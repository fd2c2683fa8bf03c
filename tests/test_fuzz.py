"""Randomized property fuzzing: tile packers vs the Pileup oracle on
randomly generated reads with arbitrary CIGAR/MD structure.

Generates reads with random mixes of M/I/D/S/N operators, consistent MD
tags, random qualities/strands/MAPQs, then asserts the packed tensors and
the threshold/Bayesian calls match the per-locus oracle exactly."""

import numpy as np
import pytest

from guacamole.callers.germline_standard import (
    call_variants_at_locus as standard_at_locus,
)
from guacamole.callers.germline_threshold import (
    call_variants_at_locus as threshold_at_locus,
)
from guacamole.pack.fast import pack_tile_fast
from guacamole.pileup.pileup import Pileup
from guacamole.reads.read import make_read
from guacamole.runtime.columnar import columnar_from_reads
from guacamole.pack.columnar import pack_tile_columnar

from test_pack import assert_tile_matches_oracle
from test_pack_fast import assert_tiles_equal

BASES = "ACGT"


def random_read(rng: np.random.RandomState, region_length: int):
    """A random structurally-consistent read with a consistent MD tag."""
    start = int(rng.randint(0, region_length - 20))
    # random reference fragment this read aligns against
    ops = []
    # optional leading soft clip
    if rng.rand() < 0.2:
        ops.append(("S", int(rng.randint(1, 5))))
    n_core = rng.randint(1, 4)
    for i in range(n_core):
        ops.append(("M", int(rng.randint(3, 12))))
        if i < n_core - 1:
            kind = rng.choice(["I", "D", "N", "M"])
            ops.append((kind, int(rng.randint(1, 4))))
    if rng.rand() < 0.2:
        ops.append(("S", int(rng.randint(1, 5))))

    # merge adjacent same ops (e.g. M,M)
    merged = []
    for op, length in ops:
        if merged and merged[-1][0] == op:
            merged[-1][1] += length
        else:
            merged.append([op, length])

    sequence = []
    md_parts = []
    match_run = 0
    reference = [BASES[rng.randint(4)] for _ in range(400)]
    ref_pos = start
    for op, length in merged:
        if op == "M":
            for _ in range(length):
                ref_base = reference[ref_pos]
                if rng.rand() < 0.15:  # mismatch
                    alt = BASES[rng.randint(4)]
                    while alt == ref_base:
                        alt = BASES[rng.randint(4)]
                    sequence.append(alt)
                    md_parts.append(str(match_run))
                    md_parts.append(ref_base)
                    match_run = 0
                else:
                    sequence.append(ref_base)
                    match_run += 1
                ref_pos += 1
        elif op == "I":
            sequence.extend(BASES[rng.randint(4)] for _ in range(length))
        elif op == "D":
            md_parts.append(str(match_run))
            match_run = 0
            md_parts.append(
                "^" + "".join(reference[ref_pos : ref_pos + length])
            )
            ref_pos += length
        elif op == "N":
            ref_pos += length
        elif op == "S":
            sequence.extend(BASES[rng.randint(4)] for _ in range(length))
    md_parts.append(str(match_run))

    cigar = "".join(f"{l}{op}" for op, l in merged)
    quals = "".join(
        chr(int(rng.randint(2, 42)) + 33) for _ in range(len(sequence))
    )
    return make_read(
        "".join(sequence),
        cigar_string=cigar,
        mdtag="".join(md_parts),
        start=start,
        reference_contig="chrF",
        base_qualities=quals,
        alignment_quality=int(rng.randint(0, 70)),
        is_positive_strand=bool(rng.rand() < 0.5),
    )


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_tile_matches_oracle(seed):
    rng = np.random.RandomState(seed)
    region = 120
    reads = sorted(
        (random_read(rng, region) for _ in range(rng.randint(5, 30))),
        key=lambda r: r.start,
    )
    tile = pack_tile_fast(reads, "chrF", range(0, region + 40))
    assert_tile_matches_oracle(tile, reads)
    # columnar paths (numpy + native) must agree with the object packer
    cols = columnar_from_reads(reads)
    for use_native in (False, True):
        got = pack_tile_columnar(
            cols, 0, "chrF", list(range(0, region + 40)), use_native=use_native
        )
        assert_tiles_equal(got, tile)


@pytest.mark.parametrize("seed", range(6, 10))
def test_fuzz_caller_kernels_match_oracle(seed):
    """Per-locus calls computed from packed tensors must equal the oracle's
    per-pileup calls at every covered locus."""
    from guacamole.callers.germline_threshold import call_tile
    from guacamole.callers.source import ReadSource

    rng = np.random.RandomState(seed)
    region = 100
    reads = sorted(
        (random_read(rng, region) for _ in range(rng.randint(8, 25))),
        key=lambda r: r.start,
    )
    source = ReadSource.from_reads(reads)
    tile = pack_tile_fast(reads, "chrF", range(0, region + 40))
    tile_calls = call_tile(
        tile, "", 8, emit_ref=False, emit_no_call=False, source=source
    )
    oracle_calls = []
    for locus in range(0, region + 40):
        pileup = Pileup.from_reads(reads, "chrF", locus)
        if pileup.depth:
            oracle_calls.extend(
                threshold_at_locus(pileup, 8, emit_ref=False, emit_no_call=False)
            )

    def key(calls):
        return sorted((c.start, c.allele, c.labels) for c in calls)

    assert key(tile_calls) == key(oracle_calls)


@pytest.mark.parametrize("seed", range(10, 16))
def test_fuzz_native_screen_mode_matches_full(seed):
    """Native screen-mode megatile outputs (counts32, candidates,
    ll_candidates) fuzz-checked against the full tile on random
    CIGAR/MD/quality reads: counts equal per-row bincounts of the full
    grid, the native candidate rule equals the device rule's numpy twin,
    and the inline likelihood screen covers every exact-confirm call."""
    from guacamole.callers.germline_standard import calls_from_tile_rows
    from guacamole.ops.dispatch import host_counts_candidates
    from guacamole.pack.columnar import pack_tile_columnar
    from guacamole.runtime.columnar import native_available

    if not native_available():
        pytest.skip("native runtime not built")
    rng = np.random.RandomState(seed)
    region = 120
    reads = sorted(
        (random_read(rng, region) for _ in range(rng.randint(8, 30))),
        key=lambda r: r.start,
    )
    cols = columnar_from_reads(reads)
    loci = list(range(0, region + 40))
    full = pack_tile_columnar(cols, 0, "chrF", loci)
    screen = pack_tile_columnar(
        cols, 0, "chrF", loci, fields="screen",
        ll_screen_margin=0.5, ll_screen_kind=1,
    )
    assert screen.counts32 is not None

    # counts32 == per-row bincount of the full grid's dense ids.
    K = full.K
    want_counts = np.zeros((full.L, K), dtype=np.int64)
    aid = np.asarray(full.allele_id)
    valid = np.asarray(full.valid).astype(bool)
    for r in range(full.L):
        ids = aid[r][valid[r]]
        ids = ids[(ids >= 0) & (ids < K)]
        want_counts[r] = np.bincount(ids, minlength=K)
    np.testing.assert_array_equal(screen.counts32, want_counts)
    np.testing.assert_array_equal(screen.depth, full.depth)
    np.testing.assert_array_equal(screen.overflow, full.overflow)
    np.testing.assert_array_equal(screen.is_variant, full.is_variant)

    # Native candidate rule == its numpy twin, both thresholds.
    from guacamole.runtime.native import counts_screen_native

    for threshold in (None, 8):
        np.testing.assert_array_equal(
            counts_screen_native(
                screen.counts32, screen.is_variant, threshold
            ),
            host_counts_candidates(
                screen.counts32, screen.is_variant, threshold
            ),
        )

    # Inline likelihood screen: superset of the exact confirm's emits.
    assert screen.ll_candidates is not None
    cand_loci = {
        int(screen.loci[i])
        for i in np.flatnonzero(
            np.asarray(screen.ll_candidates) | np.asarray(screen.overflow)
        )
    }
    rows = [i for i in range(full.L) if not full.overflow[i]]
    emitted = {
        c.start for c in calls_from_tile_rows(full, rows, "s")
    }
    assert emitted - cand_loci == set()


@pytest.mark.parametrize("seed", range(30, 40))
def test_fuzz_screen_gq_gate_is_superset(seed):
    """The native screen's min-likelihood (GQ) gate must keep every locus
    the exact confirm emits PAST the min-likelihood filter — the safe-drop
    claim of guac_pack.cpp's normalized-probability bound (1-phred safety
    band over the exact confirm's own genotype set), for both the fused
    (skip_nibbles) and two-phase fills."""
    from guacamole.callers.germline_standard import calls_from_tile_rows
    from guacamole.pack.columnar import pack_tile_columnar
    from guacamole.runtime.columnar import native_available

    if not native_available():
        pytest.skip("native runtime not built")
    rng = np.random.RandomState(seed)
    region = 120
    reads = sorted(
        (random_read(rng, region) for _ in range(rng.randint(8, 30))),
        key=lambda r: r.start,
    )
    cols = columnar_from_reads(reads)
    loci = list(range(0, region + 40))
    min_phred = int(rng.choice([10, 30, 40, 70]))
    min_mapq = int(rng.choice([0, 20]))
    full = pack_tile_columnar(cols, 0, "chrF", loci, min_mapq=min_mapq)
    for skip in (False, True):
        screen = pack_tile_columnar(
            cols, 0, "chrF", loci, fields="screen",
            min_mapq=min_mapq, ll_screen_margin=0.5, ll_screen_kind=1,
            ll_screen_min_phred=float(min_phred), skip_nibbles=skip,
        )
        cand_loci = {
            int(screen.loci[i])
            for i in np.flatnonzero(
                np.asarray(screen.ll_candidates)
                | np.asarray(screen.overflow)
            )
        }
        rows = [i for i in range(full.L) if not full.overflow[i]]
        emitted = {
            c.start
            for c in calls_from_tile_rows(
                full, rows, "s", min_alignment_quality=min_mapq,
                prefilter_min_likelihood=min_phred,
            )
        }
        assert emitted - cand_loci == set(), (
            f"seed={seed} skip={skip} min_phred={min_phred} "
            f"min_mapq={min_mapq}: exact emits not covered by the "
            f"GQ-gated screen: {sorted(emitted - cand_loci)}"
        )
