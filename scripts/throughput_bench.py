#!/usr/bin/env python
"""Scaled throughput benchmark: chrM replicated across N synthetic contigs.

The canonical chrM workload (bench.py) is small enough that fixed
per-call overheads dominate; this bench replicates the chrM reads across
N contigs IN MEMORY (ragged byte arrays shared across replicas, so setup
stays cheap) and measures steady-state calling throughput of the
counting caller (germline-threshold) and the Bayesian caller
(germline-standard) on one chip.

Usage: python scripts/throughput_bench.py [--replicas 8] [--tasks 4]
Prints one JSON report.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CHRM_BAM = "/root/reference/src/test/resources/chrM.sorted.bam"


def replicate_contigs(cols, n_rep: int):
    """A ColumnarReads with the input's reads duplicated onto n_rep
    synthetic contigs (chrM0..chrM{n-1}); ragged data arrays are shared."""
    from guacamole.runtime.columnar import ColumnarReads

    base = cols.take(np.arange(cols.n))  # normalize to start/end bounds form
    n = base.n
    cat = np.concatenate

    def rep(a):
        return cat([a] * n_rep)

    return ColumnarReads(
        ref_names=[f"chrM{i}" for i in range(n_rep)],
        ref_lengths=list(cols.ref_lengths) * n_rep,
        samples=cols.samples,
        ref_id=cat([np.full(n, i, np.int32) for i in range(n_rep)]),
        start=rep(base.start),
        end=rep(base.end),
        mapq=rep(base.mapq),
        flags_=rep(base.flags_),
        mismatches=rep(base.mismatches),
        sample_id=rep(base.sample_id),
        seq_off=rep(base.seq_off),
        seq=base.seq,
        qual=base.qual,
        cigar_off=rep(base.cigar_off),
        cigar_len=base.cigar_len,
        cigar_op=base.cigar_op,
        md_off=rep(base.md_off),
        md_text=base.md_text,
        ev_off=rep(base.ev_off),
        ev_kind=base.ev_kind,
        ev_base=base.ev_base,
        ev_qual=base.ev_qual,
        ev_mdref=base.ev_mdref,
        sp_read=cat([base.sp_read + i * n for i in range(n_rep)]),
        sp_offset=rep(base.sp_offset),
        sp_kind=rep(base.sp_kind),
        sp_payload_offset=rep(base.sp_payload_offset),
        sp_payload_len=rep(base.sp_payload_len),
        sp_qual=rep(base.sp_qual),
        special_payload=base.special_payload,
        seq_end=rep(base.seq_end),
        cigar_end=rep(base.cigar_end),
        md_end=rep(base.md_end),
        ev_end=rep(base.ev_end),
    )


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--replicas", type=int, default=8)
    p.add_argument("--tasks", type=int, default=4)
    p.add_argument("--iters", type=int, default=3)
    args = p.parse_args()

    from guacamole.platform import configure_platform

    configure_platform()

    from guacamole.callers.common import load_read_source
    from guacamole.callers.germline_standard import (
        call_variants as standard_call,
    )
    from guacamole.callers.germline_threshold import (
        call_variants as threshold_call,
    )
    from guacamole.callers.source import ReadSource
    from guacamole.loci.lociset import LociSetBuilder
    from guacamole.loci.partition import partition_loci_uniformly
    from guacamole.loci.lociset import parse_loci
    from guacamole.reads.read import InputFilters

    filters = InputFilters.create(
        overlaps_loci=parse_loci("all"), non_duplicate=True, has_mdtag=True
    )
    small, _ = load_read_source(CHRM_BAM, filters)
    cols = replicate_contigs(small._cols, args.replicas)
    source = ReadSource.from_columnar(cols)

    builder = LociSetBuilder()
    for name, length in zip(cols.ref_names, cols.ref_lengths):
        builder.put(name, 0, length)
    partitions = partition_loci_uniformly(args.tasks, builder.result())

    report = {
        "workload": f"chrM x{args.replicas} contigs, {cols.n} reads",
        "tasks": args.tasks,
    }
    from guacamole.callers.somatic_standard import (
        call_variants as somatic_call,
    )

    normal_source = ReadSource.from_columnar(cols)

    def somatic(src, parts, **kw):
        # tumor == normal: zero emissions, but the tumor screen + exact
        # two-sample confirm run at every germline-variant locus, which is
        # the representative somatic workload shape.
        return somatic_call(src, normal_source, parts, **kw)

    for name, fn, kwargs in (
        ("germline-threshold", threshold_call, {"threshold_percent": 8}),
        ("germline-standard", standard_call, {}),
        ("somatic-standard", somatic, {}),
    ):
        calls = fn(source, partitions, **kwargs)  # warm (compile cache)
        best = float("inf")
        for _ in range(args.iters):
            t0 = time.time()
            calls = fn(source, partitions, **kwargs)
            best = min(best, time.time() - t0)
        report[name] = {
            "wall_s": round(best, 3),
            "reads_per_s": round(cols.n / best),
            "n_calls": len(calls),
        }
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
