"""Cross-validation: the vectorized packer must produce tiles identical to
the reference (slow, oracle-validated) packer on every fixture."""

import numpy as np
import pytest

from guacamole.gio.load import load_read_set
from guacamole.loci.lociset import parse_loci
from guacamole.pack.fast import pack_tile_fast
from guacamole.pack.tiles import pack_tile
from guacamole.reads.read import InputFilters

from conftest import resource_path
from fixtures import make_test_read
from test_pack import synthetic_reads


def assert_tiles_equal(fast, slow):
    assert fast.contig == slow.contig
    np.testing.assert_array_equal(fast.loci, slow.loci)
    np.testing.assert_array_equal(fast.ref_base, slow.ref_base)
    np.testing.assert_array_equal(fast.depth, slow.depth)
    np.testing.assert_array_equal(fast.overflow, slow.overflow)
    np.testing.assert_array_equal(fast.num_alleles, slow.num_alleles)
    assert fast.alleles == slow.alleles
    assert fast.D == slow.D
    np.testing.assert_array_equal(fast.valid, slow.valid)
    np.testing.assert_array_equal(fast.allele_id, slow.allele_id)
    np.testing.assert_array_equal(fast.qual, slow.qual)
    np.testing.assert_array_equal(fast.mapq, slow.mapq)
    np.testing.assert_array_equal(fast.strand, slow.strand)
    np.testing.assert_array_equal(fast.mismatches, slow.mismatches)
    np.testing.assert_array_equal(fast.edge_distance, slow.edge_distance)
    np.testing.assert_array_equal(fast.read_index, slow.read_index)
    np.testing.assert_array_equal(fast.is_variant, slow.is_variant)
    np.testing.assert_array_equal(fast.is_standard_alt, slow.is_standard_alt)


def check(reads, contig, loci, **kw):
    reads = sorted(
        [r for r in reads if r.cigar.read_length == len(r.sequence)],
        key=lambda r: r.start,
    )
    fast = pack_tile_fast(reads, contig, loci, **kw)
    slow = pack_tile(reads, contig, loci, **kw)
    assert_tiles_equal(fast, slow)


def test_fast_synthetic():
    check(synthetic_reads(), "chr1", range(0, 20))


def test_fast_contig_start_insertion():
    check([make_test_read("AAAAAACGT", "5I4M", "4", 0)], "chr1", range(0, 4))


def test_fast_same_start(resources_dir):
    reads = load_read_set(resource_path("same_start_reads.sam")).mapped_reads
    check(reads, reads[0].reference_contig, range(0, 70))


def test_fast_different_start(resources_dir):
    reads = load_read_set(resource_path("different_start_reads.sam")).mapped_reads
    good = [r for r in reads if r.cigar.read_length == len(r.sequence)]
    check(good, good[0].reference_contig, range(0, max(r.end for r in good)))


def test_fast_rna(resources_dir):
    reads = load_read_set(resource_path("testrna.sam")).mapped_reads
    check(reads, reads[0].reference_contig, range(229580594, 229580894))


def test_fast_chrm_slices(resources_dir):
    filters = InputFilters.create(non_duplicate=True, has_mdtag=True)
    reads = load_read_set(resource_path("chrM.sorted.bam"), filters).mapped_reads
    for start in (0, 3000, 7000, 16000):
        check(reads, "chrM", range(start, start + 300))


def test_fast_allele_overflow():
    reads = [
        make_test_read(b, "1M", "0C0" if b != "C" else "1", 0)
        for b in ["A", "C", "G", "T"]
    ] + [
        make_test_read("C" + b, "1M1I", "1", 0)
        for b in ["A", "G", "T"]
    ]
    check(reads, "chr1", [0], max_alleles=2)
    check(reads, "chr1", [0], max_alleles=8)


def test_fast_depth_overflow():
    reads = [make_test_read("ACGT", "4M", "4", 0) for _ in range(20)]
    check(reads, "chr1", range(0, 4), depth_pad=8)


def test_fast_sparse_loci():
    check(synthetic_reads(), "chr1", [1, 3, 4, 9, 15])


def test_fast_with_reference(resources_dir):
    from guacamole.gio.fasta import ReferenceGenome

    ref = ReferenceGenome.from_fasta(resource_path("sample.fasta"))
    contig = next(iter(ref.contigs.keys()))
    reads = [
        make_test_read("TCGATCGA", "8M", "8", 1, chrom=contig),
        make_test_read("TCGCTCGA", "8M", "3A4", 1, chrom=contig),
    ]
    check(reads, contig, range(1, 9), reference_genome=ref)


def test_sparse_tile_read_index_multi_contig():
    """pack_sparse_tile's read_index must resolve through source.read()
    (full-list positions) even when the object path filters to one contig
    first (regression: subset-relative indices returned the wrong read,
    crashing pileup_from_tile_row on multi-contig inputs)."""
    from guacamole.callers.source import ReadSource

    reads = [
        make_test_read("ACGTACGT", "8M", "8", 0, chrom="chrA", sample_name="alpha"),
        make_test_read("ACGTACGT", "8M", "8", 2, chrom="chrA", sample_name="alpha"),
        make_test_read("TTTTCCCC", "8M", "8", 5, chrom="chrB", sample_name="beta"),
    ]
    source = ReadSource.from_reads(reads)
    tile = source.pack_sparse_tile("chrB", [6, 7])
    for li in range(tile.L):
        for ri, ok in zip(tile.read_index[li], tile.valid[li]):
            if ok and ri >= 0:
                assert source.read(int(ri)).reference_contig == "chrB"
                assert source.read(int(ri)).sample_name == "beta"
        pileup = source.pileup_from_tile_row(tile, li)
        assert all(e.read.reference_contig == "chrB" for e in pileup.elements)
