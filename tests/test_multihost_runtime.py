"""Real multi-host process runtime: spawn TWO OS processes against a
localhost jax.distributed coordinator, each running the full CLI on its
own loci shard (.bai/region pushdown per process), and assert the merged
VCF that process 0 writes equals a single-process whole-file run.

This is the process-level counterpart of tests/test_multihost_sharding.py
(which proves the sharding model in-process): it exercises the actual
bootstrap (`jax.distributed.initialize`), the per-`process_index` shard
assignment, and the DCN-merged record gather in parallel/multihost.py —
the analog of the reference's driver+executors deployment
(cf. upstream .../Command.scala:51-62, README.md:66-88).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from conftest import resource_path

CHRM = "chrM.sorted.bam"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _records(path) -> list:
    with open(path) as fh:
        return [line for line in fh if not line.startswith("##")]


def _spawn(argv, tmp_path, tag):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    log = open(tmp_path / f"{tag}.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "guacamole.cli"] + argv,
        stdout=log,
        stderr=subprocess.STDOUT,
        env=env,
    )
    proc._log_path = tmp_path / f"{tag}.log"  # for failure reporting
    return proc


def _wait_all(procs):
    for proc in procs:
        code = proc.wait(timeout=600)
        if code != 0:
            log = proc._log_path.read_text()
            raise AssertionError(f"process failed (exit {code}):\n{log}")


@pytest.mark.parametrize(
    "command, extra",
    [
        ("germline-threshold", []),
        ("germline-standard", ["--min-mapq", "1"]),
    ],
)
def test_two_process_run_equals_single(tmp_path, command, extra):
    coordinator = f"127.0.0.1:{_free_port()}"
    base = [
        command,
        "--reads",
        resource_path(CHRM),
        "--loci",
        "chrM:0-16571",
        "--parallelism",
        "2",
    ] + extra

    multi_out = tmp_path / "multi.vcf"
    procs = [
        _spawn(
            base
            + [
                "--coordinator",
                coordinator,
                "--num-processes",
                "2",
                "--process-id",
                str(pid),
                "--out",
                str(multi_out),
            ],
            tmp_path,
            f"{command}-p{pid}",
        )
        for pid in range(2)
    ]
    _wait_all(procs)
    assert multi_out.exists()

    single_out = tmp_path / "single.vcf"
    single = _spawn(base + ["--out", str(single_out)], tmp_path, f"{command}-single")
    _wait_all([single])

    multi = _records(multi_out)
    assert multi == _records(single_out)
    assert len([l for l in multi if not l.startswith("#")]) > 0


def test_two_process_somatic_equals_single(tmp_path):
    coordinator = f"127.0.0.1:{_free_port()}"
    pair = "synthetic.challenge.set1.%s.v2.withMDTags.chr2.syn1fp.sam"
    base = [
        "somatic-standard",
        "--tumor-reads",
        resource_path(pair % "tumor"),
        "--normal-reads",
        resource_path(pair % "normal"),
        "--loci",
        "2:0-243199373",
        "--parallelism",
        "2",
    ]
    multi_out = tmp_path / "multi.vcf"
    procs = [
        _spawn(
            base
            + [
                "--coordinator",
                coordinator,
                "--num-processes",
                "2",
                "--process-id",
                str(pid),
                "--out",
                str(multi_out),
            ],
            tmp_path,
            f"somatic-p{pid}",
        )
        for pid in range(2)
    ]
    _wait_all(procs)

    single_out = tmp_path / "single.vcf"
    _wait_all([_spawn(base + ["--out", str(single_out)], tmp_path, "somatic-1p")])
    multi = _records(multi_out)
    assert multi == _records(single_out)
    assert len([l for l in multi if not l.startswith("#")]) > 0


def test_two_process_variant_support_equals_single(tmp_path):
    coordinator = f"127.0.0.1:{_free_port()}"
    base = [
        "variant-support",
        "-v",
        resource_path("truth.chr20.vcf"),
        resource_path("gatk_mini_bundle_extract.bam"),
    ]
    multi_out = tmp_path / "multi.csv"
    procs = [
        _spawn(
            base
            + [
                "-o",
                str(multi_out),
                "--coordinator",
                coordinator,
                "--num-processes",
                "2",
                "--process-id",
                str(pid),
            ],
            tmp_path,
            f"vs-p{pid}",
        )
        for pid in range(2)
    ]
    _wait_all(procs)
    single_out = tmp_path / "single.csv"
    _wait_all([_spawn(base + ["-o", str(single_out)], tmp_path, "vs-1p")])
    assert multi_out.read_text() == single_out.read_text()
    assert single_out.read_text().strip()  # non-empty counts


def test_two_process_vaf_histogram_equals_single(tmp_path):
    coordinator = f"127.0.0.1:{_free_port()}"
    base = [
        "vaf-histogram",
        "--loci",
        "chrM:0-16571",
        resource_path(CHRM),
    ]
    multi_out = tmp_path / "multi.csv"
    procs = [
        _spawn(
            base
            + [
                "--out",
                str(multi_out),
                "--coordinator",
                coordinator,
                "--num-processes",
                "2",
                "--process-id",
                str(pid),
            ],
            tmp_path,
            f"vaf-p{pid}",
        )
        for pid in range(2)
    ]
    _wait_all(procs)
    single_out = tmp_path / "single.csv"
    _wait_all([_spawn(base + ["--out", str(single_out)], tmp_path, "vaf-1p")])
    assert multi_out.read_text() == single_out.read_text()
    assert len(single_out.read_text().splitlines()) > 1


def test_two_process_structural_variant_equals_single(tmp_path):
    coordinator = f"127.0.0.1:{_free_port()}"
    base = [
        "structural-variant",
        "--reads",
        resource_path("gatk_mini_bundle_extract.bam"),
    ]
    multi_out = tmp_path / "multi.txt"
    procs = [
        _spawn(
            base
            + [
                "--output",
                str(multi_out),
                "--coordinator",
                coordinator,
                "--num-processes",
                "2",
                "--process-id",
                str(pid),
            ],
            tmp_path,
            f"sv-p{pid}",
        )
        for pid in range(2)
    ]
    _wait_all(procs)
    single_out = tmp_path / "single.txt"
    _wait_all(
        [_spawn(base + ["--output", str(single_out)], tmp_path, "sv-1p")]
    )
    assert multi_out.read_text() == single_out.read_text()


def test_multihost_helpers_single_process():
    """The helper API degrades to identity in single-process runs."""
    from guacamole.loci.lociset import parse_loci
    from guacamole.parallel.multihost import (
        SINGLE,
        allreduce_counters,
        gather_bytes,
        gather_objects,
        shard_loci_expression,
    )

    assert not SINGLE.active and SINGLE.is_writer
    assert allreduce_counters(SINGLE, {"reads": 7}) == {"reads": 7}
    assert gather_bytes(SINGLE, b"abc") == [b"abc"]
    assert gather_objects(SINGLE, [1, 2]) == [1, 2]
    loci = parse_loci("chrM:0-100").result({"chrM": 16571})
    assert shard_loci_expression(SINGLE, loci) == "chrM:0-100"


def test_shard_expressions_cover_and_partition():
    """Per-process shard expressions partition the loci set exactly."""
    from guacamole.loci.lociset import parse_loci
    from guacamole.parallel.multihost import (
        MultihostRuntime,
        shard_loci_expression,
    )

    loci = parse_loci("chrM:0-16571").result({"chrM": 16571})
    covered = np.zeros(16571, dtype=np.int32)
    for pid in range(3):
        expr = shard_loci_expression(MultihostRuntime(pid, 3), loci)
        shard = parse_loci(expr).result({"chrM": 16571})
        for start, end in shard.on_contig("chrM").ranges:
            covered[start:end] += 1
    assert (covered == 1).all()


def _survivor_argv(coordinator, tmp_path, timeout_s):
    return [
        "germline-threshold",
        "--reads", resource_path(CHRM),
        "--loci", "chrM:0-16571",
        "--parallelism", "2",
        "--timeout", str(timeout_s),
        "--coordinator", coordinator,
        "--num-processes", "2",
        "--process-id", "0",
        "--out", str(tmp_path / "multi.vcf"),
    ]


def test_hung_peer_watchdog_aborts_survivor(tmp_path):
    """Failure semantics, hang case: a peer that is alive (heartbeating —
    so JAX's own crash detection never fires) but never joins the
    collective must not hang the survivor forever. The --timeout DCN
    watchdog aborts the survivor with exit 42 and a one-line error, so a
    cluster launcher can fail/retry the job (the job-level analog of
    Spark's task retry, which has no equivalent here — SURVEY.md §5)."""
    import time

    coordinator = f"127.0.0.1:{_free_port()}"
    hang_code = (
        "import time, jax;"
        f"jax.distributed.initialize(coordinator_address='{coordinator}',"
        "num_processes=2, process_id=1);"
        "jax.devices();"  # join backend init so the survivor passes it
        "time.sleep(600)"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    hung_log = open(tmp_path / "hung.log", "w")
    hung = subprocess.Popen(
        [sys.executable, "-c", hang_code],
        stdout=hung_log, stderr=subprocess.STDOUT, env=env,
    )
    try:
        survivor = _spawn(
            _survivor_argv(coordinator, tmp_path, 12), tmp_path, "hang-p0"
        )
        t0 = time.time()
        code = survivor.wait(timeout=180)
        elapsed = time.time() - t0
        log = survivor._log_path.read_text()
        assert code == 42, f"expected watchdog exit 42, got {code}:\n{log}"
        assert "DCN collective" in log and "did not complete" in log, log
        # promptly: survivor work + the 12 s watchdog, not minutes
        assert elapsed < 150, f"survivor took {elapsed:.0f}s to abort"
    finally:
        hung.kill()
        hung.wait(timeout=30)


def test_dead_peer_aborts_survivor_promptly(tmp_path):
    """Failure semantics, crash case: when a peer process dies outright,
    the survivor must exit nonzero promptly — via the DCN watchdog or
    JAX's coordination-service heartbeat detection, whichever trips
    first — never hang indefinitely."""
    import time

    coordinator = f"127.0.0.1:{_free_port()}"
    victim_code = (
        "import os, jax;"
        f"jax.distributed.initialize(coordinator_address='{coordinator}',"
        "num_processes=2, process_id=1);"
        "os._exit(0)"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    victim_log = open(tmp_path / "victim.log", "w")
    victim = subprocess.Popen(
        [sys.executable, "-c", victim_code],
        stdout=victim_log, stderr=subprocess.STDOUT, env=env,
    )
    survivor = _spawn(
        _survivor_argv(coordinator, tmp_path, 12), tmp_path, "dead-p0"
    )
    assert victim.wait(timeout=120) == 0

    t0 = time.time()
    code = survivor.wait(timeout=240)
    elapsed = time.time() - t0
    log = survivor._log_path.read_text()
    assert code != 0, f"survivor exited 0 despite dead peer:\n{log}"
    watchdog = "DCN collective" in log and "did not complete" in log
    heartbeat = "unhealthy" in log or "stopped sending heartbeats" in log
    assert watchdog or heartbeat, f"unexpected abort mode (exit {code}):\n{log}"
    assert elapsed < 200, f"survivor took {elapsed:.0f}s to abort"


def test_recover_after_killed_process(tmp_path):
    """The task-retry analog (round-4 VERDICT item 4): process 1 of a
    two-process run dies mid-run (fault hook: exits before persisting or
    merging anything); process 0's watchdog aborts but its completed
    shard survives on disk. `--recover` then re-executes ONLY the lost
    shard in one process and writes output identical to an undisturbed
    single-process run."""
    coordinator = f"127.0.0.1:{_free_port()}"
    base = [
        "germline-threshold",
        "--reads",
        resource_path(CHRM),
        "--loci",
        "chrM:0-16571",
        "--parallelism",
        "2",
    ]
    multi_out = tmp_path / "multi.vcf"

    def spawn_pid(pid):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        if pid == 1:
            env["GUAC_TEST_EXIT_BEFORE_MERGE"] = "1"
        log = open(tmp_path / f"rec-p{pid}.log", "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "guacamole.cli"]
            + base
            + [
                "--coordinator", coordinator,
                "--num-processes", "2",
                "--process-id", str(pid),
                "--timeout", "30",
                "--out", str(multi_out),
            ],
            stdout=log,
            stderr=subprocess.STDOUT,
            env=env,
        )
        proc._log_path = tmp_path / f"rec-p{pid}.log"
        return proc

    procs = [spawn_pid(0), spawn_pid(1)]
    codes = [p.wait(timeout=600) for p in procs]
    # p1 died on the fault hook (43); p0 hit the DCN watchdog (42).
    assert codes[1] == 43, procs[1]._log_path.read_text()
    assert codes[0] == 42, procs[0]._log_path.read_text()
    assert not multi_out.exists()
    shards = multi_out.parent / "multi.vcf.shards"
    assert shards.is_dir() and any(shards.iterdir()), (
        "the surviving process must have persisted its shard"
    )

    recover = _spawn(
        base + ["--recover", "--out", str(multi_out)], tmp_path, "recover"
    )
    _wait_all([recover])
    assert multi_out.exists()
    assert not shards.exists(), "shard dir cleaned up after recovery"

    single_out = tmp_path / "single.vcf"
    single = _spawn(base + ["--out", str(single_out)], tmp_path, "rec-single")
    _wait_all([single])
    assert _records(multi_out) == _records(single_out)
    assert multi_out.read_bytes() == single_out.read_bytes()
