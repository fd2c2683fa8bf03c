"""Device-kernel timing on the GPU: the germline and tumor likelihood
screens and the CSR counting screen, at the slab shapes the dispatch
layer launches, with device-resident inputs.

Each shape is compiled and checked once, then timed as N back-to-back
launches ending in block_until_ready (median of several windows). Bytes
are the algorithmic minimum of the call: the packed inputs read once and
the outputs written once; the roofline share divides the time that many
bytes take at the card's published bandwidth by the measured time.

Prints one JSON object per line; the first names the card and its power
limit. Needs a GPU: exits non-zero without one.

Usage: python scripts/kernel_bench.py [--quick | --slabs]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

# Published peaks (NVIDIA H100 data sheet, SXM part), keyed by the
# device_kind JAX reports. A device missing here is an error.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "f32_flops": 67e12},
}

K = 8


def card() -> dict:
    import jax

    dev = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return {"device_kind": dev.device_kind, "platform": dev.platform,
            "count": len(jax.devices()), "nvidia_smi": smi[0] if smi else None}


def timed(fn, *args, n=50, windows=5) -> float:
    """Median seconds per call over `windows` windows of n launches."""
    import jax

    jax.block_until_ready(fn(*args))
    per = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn(*args)
        jax.block_until_ready(out)
        per.append((time.perf_counter() - t0) / n)
    return float(np.median(per))


def ll_slab(D: int, rng, tumor: bool, cells: int):
    """One likelihood slab at depth bucket D: cells // D rows (>= 256),
    row depths in (D/2, D], a 4-level binned qual dictionary, K=8 with
    alleles 0-3 live and 1-3 variant."""
    from guacamole.ops.dispatch import pack_flag_words

    L = max(256, cells // D)
    depth = rng.integers(max(1, D // 2) + 1, D + 1, size=L)
    valid = np.arange(D)[None, :] < depth[:, None]
    aid = rng.choice(4, size=(L, D), p=[0.9, 0.05, 0.03, 0.02])
    qidx = rng.integers(0, 4, size=(L, D))
    pack8 = np.where(valid, aid | (qidx << 4), 0xFF).astype(np.uint8)
    qvals = np.array([12, 23, 37, 40], np.uint8)
    mapq = (
        np.where(valid, rng.choice([0, 20, 60], size=(L, D), p=[0.02, 0.08, 0.9]), 0)
        .astype(np.uint8)
        if tumor else None
    )
    iv = np.zeros((L, K), bool)
    iv[:, 1:4] = True
    st = np.zeros((L, K), bool)
    st[:, :4] = True
    return pack8, qvals, mapq, pack_flag_words(iv, st), int(valid.sum())


def bench_likelihood(depths, peaks, cells=None) -> None:
    import jax

    from guacamole.ops import dispatch

    cells = cells or dispatch.LL_SLAB_CELLS
    rng = np.random.default_rng(2026)
    for form_name, tumor, min_phred in (
        ("germline", False, 40.0), ("tumor", True, 0.0)
    ):
        for D in depths:
            pack, qvals, mapq, words, elements = ll_slab(D, rng, tumor, cells)
            pk, qv, wd = (jax.device_put(a) for a in (pack, qvals, words))
            mq = jax.device_put(mapq) if tumor else None

            def call():
                return dispatch._ll_screen_device(
                    pk, mq, wd, K, min_phred=min_phred, ll_qvals=qv
                )

            flags = int(np.asarray(call()).sum())
            t = timed(call)
            nbytes = pack.nbytes + (mapq.nbytes if tumor else 0) + words.nbytes + len(words)
            print(json.dumps({
                "screen": "likelihood", "form": form_name, "D": D,
                "slab_cells": cells, "rows": int(pack.shape[0]),
                "elements": elements, "bytes": int(nbytes), "flags": flags,
                "xla_us": round(t * 1e6, 2),
                "xla_roofline": round(nbytes / peaks["hbm_bytes_per_s"] / t, 4),
            }), flush=True)


def bench_csr(peaks, slab_bytes=None) -> None:
    import jax

    from guacamole.ops.dispatch import CSR_SLAB_BYTES, _unpack_csr_meta
    from guacamole.ops.dispatch import pack_variant_words16
    from guacamole.ops.kernels import tile_stats_csr

    slab_bytes = slab_bytes or CSR_SLAB_BYTES
    rng = np.random.default_rng(7)
    # One full slab: 25x rows (13 nibble bytes) with a 1000x band.
    depth = rng.integers(20, 31, size=slab_bytes // 13)
    depth[: len(depth) // 20] = rng.integers(900, 1100, size=len(depth) // 20)
    nb = (depth + 1) // 2
    keep = np.cumsum(nb) <= slab_bytes
    nb = nb[keep]
    L = len(nb)
    row_off = np.zeros(L + 1, np.int32)
    np.cumsum(nb, out=row_off[1:])
    blob = (rng.integers(0, 256, size=int(row_off[-1]), dtype=np.uint8) & 0x33)
    iv = np.zeros((L, K), bool)
    iv[:, 1:4] = True
    nbd = jax.device_put(nb.astype(np.uint16))
    vwd = jax.device_put(pack_variant_words16(iv))
    bd = jax.device_put(blob)

    def call():
        off, v = _unpack_csr_meta(nbd, vwd, K)
        return tile_stats_csr(bd, off, v, K, threshold_percent=25)

    t = timed(call, n=20)
    nbytes = blob.nbytes + 4 * L + L * K * 2 + L
    print(json.dumps({
        "screen": "csr", "form": "xla", "rows": L, "blob_bytes": int(blob.nbytes),
        "elements": int(2 * blob.nbytes), "bytes": int(nbytes),
        "xla_us": round(t * 1e6, 2),
        "xla_roofline": round(nbytes / peaks["hbm_bytes_per_s"] / t, 4),
    }), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="three depth buckets instead of all eleven")
    ap.add_argument("--slabs", action="store_true",
                    help="time one depth bucket over slab sizes 1-64 MiB")
    args = ap.parse_args()
    import jax

    if jax.devices()[0].platform != "gpu":
        print("kernel_bench: no GPU found", file=sys.stderr)
        return 2
    info = card()
    print(json.dumps(info), flush=True)
    peaks = PEAKS[info["device_kind"]]
    depths = (
        [16, 256, 4096] if args.quick
        else [16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384]
    )
    if args.slabs:
        for size in (1 << 20, 4 << 20, 16 << 20, 64 << 20):
            bench_likelihood([32], peaks, cells=size)
            bench_csr(peaks, slab_bytes=size)
        return 0
    bench_likelihood(depths, peaks)
    bench_csr(peaks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
