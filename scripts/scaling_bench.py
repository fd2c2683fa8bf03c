#!/usr/bin/env python
"""Scaling benchmark: loci-sharded calling step across an N-device mesh.

Measures the sharded device step (counting + screening + likelihoods with
psum-merged counters) at 1, 2, 4, 8 shards and reports scaling efficiency.
On this development host the mesh is 8 virtual CPU devices
(xla_force_host_platform_device_count); on a pod the same code spans real
chips (and hosts, with each host packing only its loci shard's reads).

Usage: python scripts/scaling_bench.py [--devices 8] [--tile-l 2048]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--devices", type=int, default=8)
    parser.add_argument("--tile-l", type=int, default=2048)
    parser.add_argument("--depth", type=int, default=128)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument(
        "--single-core-probe", action="store_true",
        help="internal: pin to one core, run the 1-device step, print "
             "elements/s (the core-bound calibration point)",
    )
    args = parser.parse_args()
    if args.single_core_probe:
        cores = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, {cores[0]})

    # Force the virtual CPU mesh (this is a sharding-efficiency harness,
    # not a device measurement).
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={args.devices}"
        ).strip()

    import jax

    try:
        jax.config.update("jax_platforms", "cpu")
    except Exception:
        pass
    import numpy as np

    from guacamole.parallel.mesh import (
        ShardedBatch,
        loci_mesh,
        make_sharded_call_step,
    )

    devices = jax.devices()
    K = 8
    L, D = args.tile_l, args.depth
    rng = np.random.RandomState(0)

    def tile(seed):
        r = np.random.RandomState(seed)
        depth = r.randint(1, D, size=L)
        valid = np.arange(D)[None, :] < depth[:, None]
        return (
            np.where(valid, r.randint(0, 4, size=(L, D)), -1).astype(np.int16),
            np.where(valid, r.randint(2, 42, size=(L, D)), 0).astype(np.int16),
            np.where(valid, r.randint(20, 60, size=(L, D)), 0).astype(np.int16),
            valid & (r.rand(L, D) < 0.5),
            valid,
            r.rand(L, K) < 0.3,
        )

    results = {}
    n = 1
    while n <= len(devices):
        mesh = loci_mesh(devices[:n])
        step = make_sharded_call_step(mesh, K)
        tiles = [tile(i) for i in range(n)]
        batch = ShardedBatch(
            allele_id=np.stack([t[0] for t in tiles]),
            qual=np.stack([t[1] for t in tiles]),
            mapq=np.stack([t[2] for t in tiles]),
            strand=np.stack([t[3] for t in tiles]),
            valid=np.stack([t[4] for t in tiles]),
            is_variant=np.stack([t[5] for t in tiles]),
        )
        elements = int(batch.valid.sum())
        # Stage the batch onto the mesh ONCE (the production megabatch
        # path transfers each tile exactly once; re-shipping ~21 MB of
        # host numpy per step would measure the transfer, not the step).
        from jax.sharding import NamedSharding, PartitionSpec

        sharding = NamedSharding(mesh, PartitionSpec("loci"))
        batch = ShardedBatch(
            **{
                f: jax.device_put(getattr(batch, f), sharding)
                for f in (
                    "allele_id", "qual", "mapq", "strand", "valid",
                    "is_variant",
                )
            }
        )
        out = step(batch)
        jax.block_until_ready(out)
        # Best of 5 timed loops: this VM's hypervisor noise inflates any
        # single multi-second window by 30-100%; the minimum loop average
        # is the reproducible per-step cost (numerator and the pinned
        # single-core bound probe both get the same treatment, so the
        # efficiency ratio compares noise floors, not windows).
        wall = float("inf")
        for _rep in range(5):
            t0 = time.time()
            for _ in range(args.iters):
                out = step(batch)
            jax.block_until_ready(out)
            wall = min(wall, (time.time() - t0) / args.iters)
        results[n] = {
            "wall_ms": round(wall * 1000, 3),
            "elements_per_s": round(elements / wall),
        }
        n *= 2

    if args.single_core_probe:
        print(json.dumps({"elements_per_s": results[1]["elements_per_s"]}))
        return 0

    # Core-bound calibration: the free 1-shard baseline already spans all
    # cores (XLA CPU intra-op threading), so dividing by min(n, cores)
    # understated attainable throughput. The honest bound is the host's
    # aggregate capacity: single-CORE single-device elements/s (pinned
    # subprocess) x physical cores.
    import subprocess

    cores = len(os.sched_getaffinity(0)) or (os.cpu_count() or 1)
    probe = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--devices", "1",
         "--tile-l", str(args.tile_l), "--depth", str(args.depth),
         "--iters", str(max(4, args.iters // 2)), "--single-core-probe"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    single_core = None
    if probe.returncode == 0:
        try:
            single_core = json.loads(
                probe.stdout.strip().splitlines()[-1]
            )["elements_per_s"]
        except (ValueError, KeyError, IndexError):
            single_core = None
    core_bound = (single_core or results[1]["elements_per_s"]) * cores

    base = results[1]["elements_per_s"]
    for n, r in results.items():
        r["speedup"] = round(r["elements_per_s"] / base, 2)
        r["efficiency"] = round(r["elements_per_s"] / base / n, 2)
        # Fraction of the host's aggregate core capacity the n-shard
        # step sustains (on a pod each shard is a dedicated chip, so
        # per-chip throughput is the analogous bound there).
        r["efficiency_vs_core_bound"] = round(
            r["elements_per_s"] / core_bound, 2
        )
    report = {
        "note": (
            "virtual CPU mesh: all shards share this host's physical cores, "
            "so efficiency here reflects host oversubscription, not device "
            "scaling; on a multi-GPU host each shard is a dedicated card"
        ),
        "physical_cores": os.cpu_count(),
        "single_core_elements_per_s": single_core,
        "core_bound_elements_per_s": int(core_bound),
        "shards": results,
    }
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
