"""Multi-process runtime: N cooperating processes, one per host or, on a
GPU host, one per card.

The reference runs a Spark driver + executors across machines
(cf. upstream .../Command.scala:51-62 and the YARN deployment in
README.md:66-88); the shuffle routes every read to the executor owning its
loci task. This runtime has NO shuffle: each process

  1. bootstraps the JAX distributed runtime (`jax.distributed.initialize`
     over the coordinator — the DCN control plane),
  2. is assigned a contiguous loci shard by `process_index` and loads ONLY
     that shard's reads (BAM-index byte-range pushdown; boundary reads are
     fetched by every process whose shard they overlap — halo duplication
     at the input layer, the analog of DistributedUtil.scala:585-597),
  3. packs/screens/calls its shard locally on its own devices (one card
     per process on a GPU host: see assign_card),
  4. merges global counters and the called-variant set over DCN
     (`process_allgather` — the analog of Spark accumulators and the
     driver-side `collect` in Common.scala:274-286); process 0 writes the
     single output file (the analog of `coalesce(1)` at Common.scala:293).

In-process correctness of the sharding model is pinned by
tests/test_multihost_sharding.py; the real multi-process runtime (this
module) is pinned by tests/test_multihost_runtime.py, which spawns two
OS processes against a localhost coordinator and asserts the merged call
set equals a single-process whole-file run.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import sys
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

# Default bound on any single DCN collective. The reference delegates
# failure handling to Spark's task retry (SURVEY.md §5); here a dead peer
# would otherwise hang every survivor inside process_allgather forever.
# NOTE a collective also waits for SLOW peers — shard-load skew and
# first-time XLA compiles count against this bound, so the default is
# generous; tune with --timeout when faster failure is worth the skew
# risk. (JAX's own coordination heartbeat separately detects outright
# peer crashes in ~100 s.)
DEFAULT_DCN_TIMEOUT_S = 900.0


@dataclass(frozen=True)
class MultihostRuntime:
    """This process's place in the (possibly single-process) run."""

    process_index: int
    process_count: int
    # Watchdog bound (seconds) on each DCN collective; <= 0 disables.
    timeout_s: float = DEFAULT_DCN_TIMEOUT_S

    @property
    def active(self) -> bool:
        return self.process_count > 1

    @property
    def is_writer(self) -> bool:
        """Process 0 writes the merged output (the coalesce(1) analog)."""
        return self.process_index == 0


SINGLE = MultihostRuntime(0, 1)


def _watchdog_abort(op: str, timeout_s: float) -> None:
    sys.stderr.write(
        f"guacamole: DCN collective '{op}' did not complete within "
        f"{timeout_s:.0f}s — a peer process died, hung, or is running "
        "far behind (shard skew / long first compile); aborting this "
        "process (re-run the job; raise --timeout if peers are merely "
        "slow)\n"
    )
    sys.stderr.flush()
    # os._exit: the main thread is blocked inside a native collective and
    # cannot unwind; a clean nonzero exit beats an indefinite hang.
    os._exit(42)


@contextlib.contextmanager
def _dcn_watchdog(runtime: MultihostRuntime, op: str):
    """Abort the process (exit 42, one-line error) if a DCN collective
    outlives runtime.timeout_s — so one dead process can't deadlock the
    others; the cluster launcher then sees a nonzero exit and can retry
    the whole batch (the Spark-retry analog at the job level)."""
    if not runtime.active or runtime.timeout_s <= 0:
        yield
        return
    timer = threading.Timer(
        runtime.timeout_s, _watchdog_abort, args=(op, runtime.timeout_s)
    )
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()


def bootstrap(
    coordinator: str = "",
    num_processes: int = 0,
    process_id: int = -1,
    timeout_s: float = -1.0,
) -> MultihostRuntime:
    """Initialize the JAX distributed runtime for a multi-process run.

    Arguments may come from CLI flags or the GUAC_COORDINATOR /
    GUAC_NUM_PROCESSES / GUAC_PROCESS_ID environment variables (the env
    form is what a cluster launcher like GKE/xpk/mpirun injects per task).
    A single-process run (num_processes <= 1) is a no-op returning SINGLE.

    Must be called before any other JAX use in the process: the
    coordinator handshake has to precede backend initialization.
    """
    coordinator = coordinator or os.environ.get("GUAC_COORDINATOR", "")
    if not num_processes:
        num_processes = int(os.environ.get("GUAC_NUM_PROCESSES", "0") or 0)
    if process_id < 0:
        process_id = int(os.environ.get("GUAC_PROCESS_ID", "-1") or -1)
    if timeout_s < 0:
        timeout_s = float(
            os.environ.get("GUAC_TIMEOUT", "") or DEFAULT_DCN_TIMEOUT_S
        )
    if num_processes <= 1:
        return SINGLE
    if not coordinator or process_id < 0:
        raise ValueError(
            "multi-process runs need --coordinator HOST:PORT and "
            "--process-id (or GUAC_COORDINATOR / GUAC_PROCESS_ID)"
        )
    import jax

    init_timeout = max(30, int(timeout_s)) if timeout_s > 0 else 300
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        initialization_timeout=init_timeout,
    )
    if jax.config.jax_platforms != "cpu":
        n_cards = host_gpu_count()
        if n_cards:
            card = assign_card(
                _exchange_hostnames(process_id, num_processes, init_timeout),
                process_id,
                n_cards,
            )
            # What jax.distributed.initialize(local_device_ids=...) does;
            # the backend is not up yet, so this process only ever opens
            # (and reserves memory on) its own card.
            jax.config.update("jax_cuda_visible_devices", str(card))
    if jax.process_count() != num_processes:
        raise RuntimeError(
            f"joined {jax.process_count()} processes, expected {num_processes}"
        )
    return MultihostRuntime(jax.process_index(), num_processes, timeout_s)


def host_gpu_count() -> int:
    """GPUs this host offers a process: the CUDA_VISIBLE_DEVICES list when
    the launcher set one, else what nvidia-smi lists; 0 without either."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        return len([d for d in visible.split(",") if d.strip()])
    import shutil
    import subprocess

    if shutil.which("nvidia-smi") is None:
        return 0
    listed = subprocess.run(
        ["nvidia-smi", "-L"], capture_output=True, text=True, timeout=60
    )
    if listed.returncode != 0:
        return 0
    return sum(1 for line in listed.stdout.splitlines() if line.startswith("GPU"))


def assign_card(hostnames: Sequence[str], process_id: int, n_cards: int) -> int:
    """The local card of process `process_id`: its rank among the
    processes on its own host (by process id). A JAX process reserves most
    of every card it opens, so each gets exactly one; a host given more
    processes than cards refuses to start."""
    host = hostnames[process_id]
    peers = [p for p, h in enumerate(hostnames) if h == host]
    if len(peers) > n_cards:
        raise RuntimeError(
            f"host {host} runs {len(peers)} processes but has {n_cards} "
            "GPU(s); start at most one process per card"
        )
    return peers.index(process_id)


def _exchange_hostnames(
    process_id: int, num_processes: int, timeout_s: int
) -> List[str]:
    """Every process's hostname, through the coordinator's key-value store
    (usable before any backend starts)."""
    import socket

    from jax._src.distributed import global_state

    client = global_state.client
    client.key_value_set(f"guac/host/{process_id}", socket.gethostname())
    return [
        client.blocking_key_value_get(f"guac/host/{p}", timeout_s * 1000)
        for p in range(num_processes)
    ]


def shard_loci_expression(
    runtime: MultihostRuntime, loci_set
) -> Optional[str]:
    """This process's loci shard as a parseable loci expression.

    Uniform split of the global loci set into process_count contiguous
    shards (the cross-host partitioning axis; within the shard the
    per-process partitioner further depth-balances across its tasks).
    Returns None for an empty shard (more hosts than loci ranges' span).
    """
    from guacamole.loci.partition import partition_loci_uniformly

    partitions = partition_loci_uniformly(runtime.process_count, loci_set)
    shard = partitions.inverse_map().get(runtime.process_index)
    if shard is None or shard.count == 0:
        return None
    parts = []
    for contig in shard.contigs:
        for start, end in shard.on_contig(contig).ranges:
            parts.append(f"{contig}:{start}-{end}")
    return ",".join(parts)


def _allgather_array(
    arr: np.ndarray, runtime: MultihostRuntime = SINGLE, op: str = "allgather"
) -> np.ndarray:
    """All-gather one per-process array over DCN; returns [P, *arr.shape].
    Guarded by the DCN watchdog: a dead peer aborts this process with a
    one-line error instead of hanging it forever."""
    from jax.experimental import multihost_utils

    with _dcn_watchdog(runtime, op):
        return np.asarray(multihost_utils.process_allgather(arr))


def allreduce_counters(
    runtime: MultihostRuntime, counters: Dict[str, int]
) -> Dict[str, int]:
    """Sum named integer counters across all processes (the Spark
    accumulator analog, merged over DCN)."""
    if not runtime.active:
        return dict(counters)
    keys = sorted(counters)
    local = np.asarray([counters[k] for k in keys], dtype=np.int64)
    summed = _allgather_array(local, runtime, "allreduce_counters").sum(axis=0)
    return {k: int(v) for k, v in zip(keys, summed)}


def gather_bytes(runtime: MultihostRuntime, payload: bytes) -> List[bytes]:
    """All-gather one variable-length byte string per process.

    Two DCN collectives: lengths first, then the max-length-padded
    payloads (process_allgather requires equal shapes per process).
    """
    if not runtime.active:
        return [payload]
    lengths = _allgather_array(
        np.asarray([len(payload)], np.int64), runtime, "gather_bytes/lengths"
    )[:, 0]
    width = max(1, int(lengths.max()))
    buf = np.zeros(width, np.uint8)
    buf[: len(payload)] = np.frombuffer(payload, np.uint8)
    stacked = _allgather_array(buf, runtime, "gather_bytes/payload")
    return [
        stacked[p, : int(lengths[p])].tobytes()
        for p in range(runtime.process_count)
    ]


def gather_objects(runtime: MultihostRuntime, items: Sequence) -> List:
    """All-gather per-process object lists (pickled over DCN) and return
    the concatenation in process order — the driver-collect analog.
    Every process receives the full merged list."""
    if not runtime.active:
        return list(items)
    merged: List = []
    for blob in gather_bytes(runtime, pickle.dumps(list(items), protocol=4)):
        merged.extend(pickle.loads(blob))
    return merged


# ---------------------------------------------------------------------------
# Shard persistence + recovery: the task-retry analog.
#
# The reference inherits Spark's lineage-based task retry (SURVEY.md §5 /
# upstream README.md:66-88): a lost task re-executes from its
# immutable input. jax.distributed cannot resurrect a dead peer inside a
# live job (collectives require every process), so recovery is
# relaunch-based, built on the same property Spark relies on — shards are
# deterministic functions of immutable inputs:
#
#  1. every process persists its computed shard records to
#     <out>.shards/shard-<i>-of-<n>.pkl (atomic rename) BEFORE entering
#     the DCN merge, so completed work survives any peer's death;
#  2. a dead peer trips the DCN watchdog — survivors exit 42 with their
#     shard files on disk;
#  3. `guacamole <cmd> ... --recover` (single process) loads the
#     completed shard files, re-executes ONLY the missing shards' loci
#     (BAM + .bai pushdown make that cheap), merges, and writes output
#     byte-identical to an undisturbed run (pinned by
#     tests/test_multihost_runtime.py::test_recover_after_killed_process).
# ---------------------------------------------------------------------------


def shard_dir(out_path: str) -> str:
    return out_path + ".shards"


def persist_shard(
    out_path: str, process_index: int, process_count: int, records
) -> None:
    """Atomically persist this process's computed shard records."""
    if not out_path:
        return
    d = shard_dir(out_path)
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".tmp-{process_index}")
    with open(tmp, "wb") as fh:
        pickle.dump(
            {
                "process_index": process_index,
                "process_count": process_count,
                "records": list(records),
            },
            fh,
            protocol=4,
        )
    os.replace(
        tmp,
        os.path.join(
            d, f"shard-{process_index}-of-{process_count}.pkl"
        ),
    )


def load_shards(out_path: str):
    """(process_count, {process_index: records}) from a failed run's
    shard directory; (0, {}) when none exists. Shard files from a run
    with a DIFFERENT process count (stale leftovers from an earlier
    differently-sized failed job against the same --out) are ignored —
    mixing them would mis-split the loci axis. The trusted group is the
    one with the NEWEST file (mtime), i.e. the most recent failed run,
    regardless of whether it was larger or smaller than the stale one."""
    d = shard_dir(out_path)
    if not os.path.isdir(d):
        return 0, {}
    payloads = []  # (mtime, process_count, process_index, records)
    for name in sorted(os.listdir(d)):
        if not name.startswith("shard-") or not name.endswith(".pkl"):
            continue
        path = os.path.join(d, name)
        with open(path, "rb") as fh:
            p = pickle.load(fh)
        payloads.append(
            (
                os.path.getmtime(path),
                int(p["process_count"]),
                int(p["process_index"]),
                p["records"],
            )
        )
    if not payloads:
        return 0, {}
    count = max(payloads, key=lambda t: t[0])[1]  # newest file's count
    have: Dict[int, list] = {
        idx: records
        for _mt, cnt, idx, records in payloads
        if cnt == count
    }
    return count, have


def clear_shards(out_path: str) -> None:
    """Remove a run's shard directory (after a successful merge)."""
    import shutil

    shutil.rmtree(shard_dir(out_path), ignore_errors=True)


def missing_shards_expression(loci_set, process_count: int, have) -> str:
    """The loci expression covering every shard NOT in `have` (the work a
    --recover run re-executes), '' when nothing is missing. Shard
    boundaries are recomputed exactly as the original run's
    shard_loci_expression did (uniform split, deterministic)."""
    from guacamole.loci.partition import partition_loci_uniformly

    partitions = partition_loci_uniformly(process_count, loci_set)
    inverse = partitions.inverse_map()
    parts = []
    for idx in range(process_count):
        if idx in have:
            continue
        shard = inverse.get(idx)
        if shard is None or shard.count == 0:
            continue
        for contig in shard.contigs:
            for start, end in shard.on_contig(contig).ranges:
                parts.append(f"{contig}:{start}-{end}")
    return ",".join(parts)


def barrier(runtime: MultihostRuntime, name: str) -> None:
    if not runtime.active:
        return
    from jax.experimental import multihost_utils

    with _dcn_watchdog(runtime, f"barrier/{name}"):
        multihost_utils.sync_global_devices(name)
