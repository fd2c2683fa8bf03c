"""Columnar packer cross-validation: pack_tile_columnar must equal the
object-model fast packer on identical read sets (both native-decoded and
Python-fallback columnar inputs)."""

import numpy as np
import pytest

from guacamole.gio.load import load_read_set
from guacamole.loci.lociset import parse_loci
from guacamole.pack.columnar import pack_tile_columnar, pack_tiles_columnar
from guacamole.pack.fast import pack_tile_fast
from guacamole.pack.tiles import pack_tiles
from guacamole.reads.read import InputFilters
from guacamole.runtime.columnar import (
    columnar_from_reads,
    decode_bam_columnar,
    native_available,
)

from conftest import resource_path
from fixtures import make_test_read
from test_pack import synthetic_reads
from test_pack_fast import assert_tiles_equal


def check_columnar(reads, contig, loci, **kw):
    reads = sorted(
        [r for r in reads if r.cigar.read_length == len(r.sequence)],
        key=lambda r: r.start,
    )
    cols = columnar_from_reads(reads)
    contig_id = cols.ref_names.index(contig)
    want = pack_tile_fast(reads, contig, loci, **kw)
    # numpy columnar path and C++ native packer must both equal the
    # object-path packer
    got_numpy = pack_tile_columnar(
        cols, contig_id, contig, sorted(loci), use_native=False, **kw
    )
    assert_tiles_equal(got_numpy, want)
    got_native = pack_tile_columnar(
        cols, contig_id, contig, sorted(loci), use_native=True, **kw
    )
    assert_tiles_equal(got_native, want)


def test_columnar_synthetic():
    check_columnar(synthetic_reads(), "chr1", range(0, 20))


def test_columnar_sparse_loci():
    check_columnar(synthetic_reads(), "chr1", [1, 3, 4, 9, 15])


def test_columnar_same_start(resources_dir):
    reads = load_read_set(resource_path("same_start_reads.sam")).mapped_reads
    check_columnar(reads, reads[0].reference_contig, range(0, 70))


def test_columnar_rna(resources_dir):
    reads = load_read_set(resource_path("testrna.sam")).mapped_reads
    check_columnar(
        reads, reads[0].reference_contig, range(229580594, 229580894)
    )


@pytest.mark.skipif(not native_available(), reason="native runtime not built")
def test_native_columnar_matches_fast_on_chrm(resources_dir):
    path = resource_path("chrM.sorted.bam")
    cols = decode_bam_columnar(path)
    # object-path reads with identical ordering (all mapped reads)
    reads = [
        r.as_mapped_read
        for r in load_read_set(path, InputFilters.empty).reads
        if r.is_mapped
    ]
    mapped_cols = cols.select(cols.is_mapped_mask)
    contig_id = mapped_cols.ref_names.index("chrM")
    for start in (0, 3000, 16000):
        loci = list(range(start, start + 256))
        got = pack_tile_columnar(mapped_cols, contig_id, "chrM", loci)
        want = pack_tile_fast(
            sorted(reads, key=lambda r: r.start), "chrM", loci
        )
        # ignore read_index (different orderings between the two paths are
        # possible for equal starts); everything else must match
        got_ri, want_ri = got.read_index, want.read_index
        got.read_index = want.read_index = np.zeros_like(got_ri)
        assert_tiles_equal(got, want)
        # read_index must still point at reads with the right start
        real = got_ri >= 0
        np.testing.assert_array_equal(
            mapped_cols.start[got_ri[real]],
            np.asarray(
                [r.start for r in sorted(reads, key=lambda r: r.start)],
                dtype=np.int64,
            )[want_ri[real]],
        )


@pytest.mark.skipif(not native_available(), reason="native runtime not built")
def test_native_pack_tiles_columnar(resources_dir):
    cols = decode_bam_columnar(resource_path("chrM.sorted.bam"))
    mapped = cols.select(cols.is_mapped_mask)
    loci = parse_loci("chrM:0-2000").result().on_contig("chrM")
    tiles = pack_tiles_columnar(mapped, "chrM", loci, tile_size=512)
    assert sum(int((t.loci >= 0).sum()) for t in tiles) == 2000
    assert all(t.L == 512 for t in tiles)


@pytest.mark.skipif(not native_available(), reason="native runtime not built")
def test_native_packed_nib_matches_python_packing(resources_dir):
    from guacamole.ops.dispatch import pack_nibbles

    path = resource_path("chrM.sorted.bam")
    cols = decode_bam_columnar(path)
    mapped_cols = cols.select(cols.is_mapped_mask)
    contig_id = mapped_cols.ref_names.index("chrM")
    for start, l_pad in ((0, 0), (3000, 512), (16000, 300)):
        loci = list(range(start, start + 256))
        tile = pack_tile_columnar(
            mapped_cols, contig_id, "chrM", loci, l_pad=l_pad
        )
        assert tile.packed_nib is not None
        assert tile.packed_nib.shape == (tile.L, (tile.D + 1) // 2)
        np.testing.assert_array_equal(
            tile.packed_nib, pack_nibbles(tile.allele_id, tile.valid)
        )


@pytest.mark.skipif(not native_available(), reason="native runtime not built")
def test_screen_only_tiles_match_full(resources_dir):
    path = resource_path("chrM.sorted.bam")
    cols = decode_bam_columnar(path)
    mapped_cols = cols.select(cols.is_mapped_mask)
    contig_id = mapped_cols.ref_names.index("chrM")
    loci = list(range(2000, 2512))
    full = pack_tile_columnar(mapped_cols, contig_id, "chrM", loci)
    screen = pack_tile_columnar(
        mapped_cols, contig_id, "chrM", loci, fields="screen"
    )
    # Per-element tensors are omitted...
    assert screen.qual is None and screen.valid is None
    assert screen.allele_id is None and screen.read_index is None
    # ...but everything the counting screen consumes is identical.
    np.testing.assert_array_equal(screen.depth, full.depth)
    np.testing.assert_array_equal(screen.ref_base, full.ref_base)
    np.testing.assert_array_equal(screen.overflow, full.overflow)
    np.testing.assert_array_equal(screen.num_alleles, full.num_alleles)
    np.testing.assert_array_equal(screen.is_variant, full.is_variant)
    # Screen tiles carry the CSR encoding instead of the [L, D] grid.
    assert screen.packed_nib is None
    assert screen.csr_nib is not None
    for li in range(screen.L):
        assert list(screen.alleles[li]) == list(full.alleles[li])


@pytest.mark.skipif(not native_available(), reason="native runtime not built")
def test_screen_tiles_csr_encoding(resources_dir):
    from guacamole.ops.dispatch import screen_tile_for
    from guacamole.ops.kernels import tile_stats

    path = resource_path("chrM.sorted.bam")
    cols = decode_bam_columnar(path)
    mapped_cols = cols.select(cols.is_mapped_mask)
    contig_id = mapped_cols.ref_names.index("chrM")
    loci = list(range(1000, 1512))
    full = pack_tile_columnar(mapped_cols, contig_id, "chrM", loci)
    screen = pack_tile_columnar(
        mapped_cols, contig_id, "chrM", loci, fields="screen"
    )
    assert screen.csr_nib is not None and screen.csr_off is not None
    assert screen.csr_off.shape == (screen.L + 1,)
    # CSR rows are exact-size: total bytes = sum(ceil(depth/2)).
    assert screen.csr_off[-1] == int(((screen.depth + 1) // 2).sum())
    got = screen_tile_for(screen, threshold_percent=8)
    want = tile_stats(
        full.allele_id, full.strand, full.valid, full.is_variant, full.K,
        threshold_percent=8,
    )
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.candidates, want.variant_evidence)


@pytest.mark.skipif(not native_available(), reason="native runtime not built")
def test_native_counts_match_device_screen(resources_dir):
    """The screen-mode packer's [L, K] counts by-product and the native
    candidate rule (the host fallback screen) must equal the device CSR
    screen exactly — counts, candidates, and the compact form."""
    from guacamole.ops.dispatch import (
        host_counts_candidates,
        screen_csr_launch,
    )
    from guacamole.runtime.native import counts_screen_native

    path = resource_path("chrM.sorted.bam")
    cols = decode_bam_columnar(path)
    mapped_cols = cols.select(cols.is_mapped_mask)
    contig_id = mapped_cols.ref_names.index("chrM")
    loci = list(range(1000, 3048))
    screen = pack_tile_columnar(
        mapped_cols, contig_id, "chrM", loci, fields="screen"
    )
    assert screen.counts32 is not None
    for threshold in (None, 8, 25):
        dev = screen_csr_launch(
            np.asarray(screen.csr_nib),
            np.asarray(screen.csr_off, np.int32),
            np.asarray(screen.is_variant),
            screen.K,
            threshold_percent=threshold,
        ).result()
        np.testing.assert_array_equal(screen.counts32, dev.counts)
        host_np = host_counts_candidates(
            screen.counts32, screen.is_variant, threshold
        )
        host_nat = counts_screen_native(
            screen.counts32, screen.is_variant, threshold
        )
        np.testing.assert_array_equal(host_np, np.asarray(dev.candidates))
        np.testing.assert_array_equal(host_nat, np.asarray(dev.candidates))


@pytest.mark.skipif(not native_available(), reason="native runtime not built")
def test_covered_loci_native_matches_python(resources_dir):
    """Native covered-loci must equal the numpy interval-merge fallback,
    including multi-range and empty cases."""
    from unittest import mock

    from guacamole.pack import columnar as pc

    path = resource_path("chrM.sorted.bam")
    cols = decode_bam_columnar(path).select(
        decode_bam_columnar(path).is_mapped_mask
    )
    contig_id = cols.ref_names.index("chrM")
    cases = [
        [(0, 16571)],
        [(0, 100), (5000, 5100), (16000, 17000)],
        [(20000, 21000)],  # beyond the contig: no coverage
        [],
    ]
    for ranges in cases:
        native = pc.covered_loci(cols, contig_id, ranges)
        with mock.patch(
            "guacamole.runtime.native.covered_loci_native",
            return_value=None,
        ):
            python = pc.covered_loci(cols, contig_id, ranges)
        np.testing.assert_array_equal(native, python)


def test_host_screen_env_override(monkeypatch):
    """GUAC_HOST_SCREEN pins the screen implementation choice."""
    from guacamole.ops import dispatch

    monkeypatch.setenv("GUAC_HOST_SCREEN", "1")
    assert dispatch.screen_on_host() is True
    monkeypatch.setenv("GUAC_HOST_SCREEN", "0")
    assert dispatch.screen_on_host() is False


def test_read_scan_window_covers_all_overlaps():
    """read_scan_window must be a superset window of the overlap set for
    every query, and degrade to None on non-grouped/unsorted columns."""
    import numpy as np

    from guacamole.runtime.columnar import ColumnarReads

    def cols_of(ref_id, start, end):
        n = len(start)
        z = np.zeros(n, dtype=np.int64)
        return ColumnarReads(
            ref_names=["a", "b"], ref_lengths=[1000, 1000], samples=["s"],
            ref_id=np.asarray(ref_id, np.int32),
            start=np.asarray(start, np.int64),
            end=np.asarray(end, np.int64),
            mapq=np.zeros(n, np.int32), flags_=np.zeros(n, np.uint16),
            mismatches=np.zeros(n, np.int32),
            sample_id=np.zeros(n, np.int32),
            seq_off=np.zeros(n + 1, np.int64), seq=np.zeros(0, np.uint8),
            qual=np.zeros(0, np.uint8),
            cigar_off=np.zeros(n + 1, np.int64),
            cigar_len=np.zeros(0, np.uint32), cigar_op=np.zeros(0, np.uint8),
            md_off=np.zeros(n + 1, np.int64), md_text=np.zeros(0, np.uint8),
            ev_off=np.zeros(n + 1, np.int64), ev_kind=np.zeros(0, np.uint8),
            ev_base=np.zeros(0, np.uint8), ev_qual=np.zeros(0, np.uint8),
            ev_mdref=np.zeros(0, np.uint8),
            sp_read=z[:0], sp_offset=z[:0],
            sp_kind=np.zeros(0, np.int32), sp_payload_offset=z[:0],
            sp_payload_len=z[:0], sp_qual=np.zeros(0, np.int32),
            special_payload=np.zeros(0, np.uint8),
        )

    rng = np.random.RandomState(0)
    starts0 = np.sort(rng.randint(0, 900, size=50))
    ends0 = starts0 + rng.randint(1, 120, size=50)
    starts1 = np.sort(rng.randint(0, 900, size=30))
    ends1 = starts1 + rng.randint(1, 60, size=30)
    cols = cols_of(
        [0] * 50 + [1] * 30,
        np.concatenate([starts0, starts1]),
        np.concatenate([ends0, ends1]),
    )
    for contig_id, s, e in ((0, starts0, ends0), (1, starts1, ends1)):
        base = 0 if contig_id == 0 else 50
        for lo, hi in ((0, 10), (100, 400), (850, 999), (0, 999)):
            w = cols.read_scan_window(contig_id, lo, hi)
            assert w is not None
            overlap = np.flatnonzero((e > lo) & (s <= hi)) + base
            assert all(w[0] <= r < w[1] for r in overlap), (
                contig_id, lo, hi, w, overlap,
            )
    # absent contig: empty window
    w = cols.read_scan_window(7, 0, 100)
    assert w == (cols.n, cols.n)
    # unsorted starts within a contig -> no window (full scan)
    bad = cols_of([0, 0, 0], [10, 5, 20], [30, 25, 40])
    assert bad.read_scan_window(0, 0, 100) is None
    # contig appearing in two separate blocks -> no window
    bad2 = cols_of([0, 1, 0], [10, 5, 20], [30, 25, 40])
    assert bad2.read_scan_window(0, 0, 100) is None


@pytest.mark.skipif(not native_available(), reason="native runtime not built")
def test_native_ll_screen_superset_of_exact_calls(resources_dir):
    """The packer-inline germline likelihood screen (ll_candidates, f64
    factored rule) must flag every locus the exact f64 confirm emits —
    the same superset contract the device screens carry."""
    from guacamole.callers.germline_standard import calls_from_tile_rows

    path = resource_path("chrM.sorted.bam")
    cols = decode_bam_columnar(path)
    cols = cols.select(cols.is_mapped_mask)
    contig_id = cols.ref_names.index("chrM")
    lo, hi = 0, 8192
    screen = pack_tile_columnar(
        cols, contig_id, "chrM", range(lo, hi), fields="screen",
        min_mapq=1, ll_screen_margin=0.5, ll_screen_kind=1,
    )
    assert screen.ll_candidates is not None
    cand = {
        int(screen.loci[i])
        for i in np.flatnonzero(
            np.asarray(screen.ll_candidates) | np.asarray(screen.overflow)
        )
    }
    full = pack_tile_columnar(cols, contig_id, "chrM", range(lo, hi))
    rows = [i for i in range(full.L) if not full.overflow[i]]
    calls = calls_from_tile_rows(full, rows, "s", min_alignment_quality=1)
    emitted = {c.start for c in calls}
    assert emitted, "fixture region must emit calls"
    missed = emitted - cand
    assert not missed, f"native ll screen missed exact-call loci {missed}"


@pytest.mark.skipif(not native_available(), reason="native runtime not built")
def test_native_tumor_screen_superset_of_exact_somatic(resources_dir):
    """The packer-inline tumor screen (alignment-included, kind=2) must
    flag every locus the exact somatic kernel emits. The fixture's reads
    span a 233 Mbp contig sparsely, so the tile and the oracle loop run
    over COVERED loci only."""
    from guacamole.callers.somatic_standard import (
        find_potential_variant_at_locus,
    )
    from guacamole.callers.source import ReadSource
    from guacamole.pack.columnar import covered_loci
    from guacamole.runtime.columnar import columnar_from_reads

    pair = "synthetic.challenge.set1.%s.v2.withMDTags.chr2.csnp.sam"
    filt = InputFilters.create(non_duplicate=True, has_mdtag=True)
    tumor = load_read_set(resource_path(pair % "tumor"), filt).mapped_reads
    normal = load_read_set(resource_path(pair % "normal"), filt).mapped_reads
    t_cols = columnar_from_reads(sorted(tumor, key=lambda r: r.start))
    contig = tumor[0].reference_contig
    contig_id = t_cols.ref_names.index(contig)
    lo = min(r.start for r in tumor)
    hi = max(r.end for r in tumor)
    loci = covered_loci(t_cols, contig_id, [(lo, hi)])
    assert 0 < len(loci) < 100_000
    tile = pack_tile_columnar(
        t_cols, contig_id, contig, loci, fields="screen",
        min_mapq=1, ll_screen_margin=0.5, ll_screen_kind=2,
    )
    assert tile.ll_candidates is not None
    cand = {
        int(tile.loci[i])
        for i in np.flatnonzero(
            np.asarray(tile.ll_candidates) | np.asarray(tile.overflow)
        )
    }
    t_src = ReadSource.from_reads(tumor)
    n_src = ReadSource.from_reads(normal)
    emitted = set()
    for locus in (int(x) for x in loci):
        tp = t_src.pileup_at(contig, locus)
        if not tp.elements:
            continue
        np_ = n_src.pileup_at(contig, locus)
        if not np_.elements:
            continue
        if find_potential_variant_at_locus(tp, np_, 20, 1):
            emitted.add(locus)
    assert emitted, "fixture must emit somatic calls"
    missed = emitted - cand
    assert not missed, f"native tumor screen missed somatic loci {missed}"


@pytest.mark.skipif(not native_available(), reason="native runtime not built")
def test_skip_nibbles_fused_fill_matches_two_phase(resources_dir):
    """The fused single-phase CSR fill (skip_nibbles=True: counts per
    arrival-order code, permuted at row end) must be bit-identical to the
    two-phase fill in everything the host screen consumes — counts,
    allele tables, flags, and the f64 likelihood-screen candidates — for
    both the germline and tumor screen models."""
    path = resource_path("chrM.sorted.bam")
    cols = decode_bam_columnar(path)
    mapped_cols = cols.select(cols.is_mapped_mask)
    contig_id = mapped_cols.ref_names.index("chrM")
    loci = list(range(0, 4096))
    # The (kind=2, margin=2.0) combination is the regression case the
    # round-5 fuzz campaign caught: all-(-inf) tumor scores at ref-only
    # rows made the eager and lazy fills disagree before the has_var
    # guard unified them.
    for kind, min_mapq, margin in (
        (1, 0, 0.5), (1, 20, 0.5), (2, 0, 0.5), (2, 0, 2.0), (1, 0, 0.0),
    ):
        base = pack_tile_columnar(
            mapped_cols, contig_id, "chrM", loci, fields="screen",
            min_mapq=min_mapq, ll_screen_margin=margin,
            ll_screen_kind=kind,
        )
        fused = pack_tile_columnar(
            mapped_cols, contig_id, "chrM", loci, fields="screen",
            min_mapq=min_mapq, ll_screen_margin=margin,
            ll_screen_kind=kind, skip_nibbles=True,
        )
        assert len(fused.csr_nib) == 0  # the blob really is skipped
        np.testing.assert_array_equal(fused.counts32, base.counts32)
        np.testing.assert_array_equal(
            fused.ll_candidates, base.ll_candidates
        )
        np.testing.assert_array_equal(fused.depth, base.depth)
        np.testing.assert_array_equal(fused.num_alleles, base.num_alleles)
        np.testing.assert_array_equal(fused.is_variant, base.is_variant)
        np.testing.assert_array_equal(
            fused.is_standard_alt, base.is_standard_alt
        )
        np.testing.assert_array_equal(fused.overflow, base.overflow)
        np.testing.assert_array_equal(fused.csr_off, base.csr_off)
        for li in range(fused.L):
            assert list(fused.alleles[li]) == list(base.alleles[li])


@pytest.mark.skipif(not native_available(), reason="native runtime not built")
def test_ll_qdict_16_entry_boundary():
    """The native qual-dictionary transcode engages at EXACTLY 16
    distinct quals (a full 4-bit index space) and falls back at 17."""
    from fixtures import make_test_read

    def tile_with_quals(qvals):
        reads = []
        for i, q in enumerate(qvals):
            r = make_test_read("ACGTACGT", "8M", "8", i, quality_scores=[q] * 8)
            reads.append(r)
        reads.sort(key=lambda r: r.start)
        cols = columnar_from_reads(reads)
        return pack_tile_columnar(
            cols, 0, "chr1", list(range(0, len(qvals) + 8)),
            fields="likelihood",
        )

    t16 = tile_with_quals(list(range(10, 26)))  # 16 distinct
    assert t16.ll_pack8 is not None
    assert sorted(t16.ll_qvals) == list(range(10, 26))
    t17 = tile_with_quals(list(range(10, 27)))  # 17 distinct
    assert t17.ll_pack8 is None
