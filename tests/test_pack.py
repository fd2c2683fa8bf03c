"""Property tests: packed tile tensors must reproduce the Pileup oracle
exactly at every locus (depth, reference base, allele multiset, per-element
qualities/strand/order)."""

import numpy as np
import pytest

from guacamole.gio.load import load_read_set
from guacamole.loci.lociset import parse_loci
from guacamole.pack.tiles import pack_tile, pack_tiles
from guacamole.pileup.pileup import Pileup
from guacamole.reads.read import InputFilters

from conftest import resource_path
from fixtures import make_test_read


def assert_tile_matches_oracle(tile, reads):
    for li in range(tile.L):
        locus = int(tile.loci[li])
        pileup = Pileup.from_reads(reads, tile.contig, locus)
        assert tile.depth[li] == pileup.depth, f"depth mismatch at {locus}"
        assert tile.ref_base[li] == pileup.reference_base, (
            f"ref base mismatch at {locus}"
        )
        if tile.overflow[li]:
            continue
        # allele dictionary must equal the oracle's sorted distinct alleles
        got_alleles = tile.alleles[li]
        want_alleles = pileup.distinct_alleles
        assert got_alleles == want_alleles, f"alleles mismatch at {locus}"
        # per-element fields, in pileup order
        n = pileup.depth
        assert list(tile.valid[li, :n]) == [True] * n
        assert not tile.valid[li, n:].any()
        for slot, element in enumerate(pileup.elements):
            aid = tile.allele_id[li, slot]
            assert got_alleles[aid] == element.allele, (
                f"allele mismatch at {locus} slot {slot}"
            )
            assert tile.qual[li, slot] == element.quality_score
            assert tile.mapq[li, slot] == element.read.alignment_quality
            assert tile.strand[li, slot] == element.read.is_positive_strand
            assert (
                tile.edge_distance[li, slot]
                == element.distance_from_sequencing_end
            )


def synthetic_reads():
    return [
        make_test_read("TCGATCGA", "8M", "8", 1),
        make_test_read("TCGCTCGA", "8M", "3A4", 1),
        make_test_read("TCGACCCTCGA", "4M3I4M", "8", 1),
        make_test_read("TCGAAAAGCT", "5M6D5M", "5^GCTTCG5", 0),
        make_test_read("AATTGAATTG", "5M1D5M", "5^C5", 3),
        make_test_read("ACGT", "2M2N2M", "4", 6),
        make_test_read("GGGG", "2S2M", "2", 9),
    ]


def test_tile_matches_oracle_synthetic():
    reads = sorted(synthetic_reads(), key=lambda r: r.start)
    loci = range(0, 20)
    tile = pack_tile(reads, "chr1", loci)
    assert_tile_matches_oracle(tile, reads)


def test_tile_matches_oracle_insertions_different_quals():
    quals_i = [10, 15, 20, 25, 5, 5, 5, 10, 15, 20, 25]
    reads = [
        make_test_read("TCGATCGA", "8M", "8", 1),
        make_test_read("TCGACCCTCGA", "4M3I4M", "8", 1, quality_scores=quals_i),
    ]
    tile = pack_tile(reads, "chr1", range(1, 9))
    assert_tile_matches_oracle(tile, reads)


def test_tile_matches_oracle_contig_start_insertion():
    reads = [make_test_read("AAAAAACGT", "5I4M", "4", 0)]
    tile = pack_tile(reads, "chr1", range(0, 4))
    assert_tile_matches_oracle(tile, reads)


def test_tile_matches_oracle_same_start_reads(resources_dir):
    reads = load_read_set(resource_path("same_start_reads.sam")).mapped_reads
    reads = sorted(reads, key=lambda r: r.start)
    tile = pack_tile(reads, reads[0].reference_contig, range(0, 70))
    assert_tile_matches_oracle(tile, reads)


def test_tile_matches_oracle_different_start_reads(resources_dir):
    reads = load_read_set(resource_path("different_start_reads.sam")).mapped_reads
    # read2 in this fixture is structurally malformed (CIGAR consumes 65
    # read bases, SEQ has 60); both the oracle and packer must skip it.
    reads = [r for r in reads if r.cigar.read_length == len(r.sequence)]
    reads = sorted(reads, key=lambda r: r.start)
    max_end = max(r.end for r in reads)
    tile = pack_tile(reads, reads[0].reference_contig, range(0, max_end))
    assert_tile_matches_oracle(tile, reads)


def test_tile_matches_oracle_rna_reads(resources_dir):
    reads = load_read_set(resource_path("testrna.sam")).mapped_reads
    reads = sorted(reads, key=lambda r: r.start)
    loci = range(229580594, 229580794)
    tile = pack_tile(reads, reads[0].reference_contig, loci)
    assert_tile_matches_oracle(tile, reads)


def test_tile_matches_oracle_chrm_slice(resources_dir):
    filters = InputFilters.create(
        overlaps_loci=parse_loci("chrM:3000-3300"),
        non_duplicate=True,
        has_mdtag=True,
    )
    reads = load_read_set(resource_path("chrM.sorted.bam"), filters).mapped_reads
    reads = sorted(reads, key=lambda r: r.start)
    tile = pack_tile(reads, "chrM", range(3000, 3300))
    assert_tile_matches_oracle(tile, reads)


def test_pack_tiles_skip_empty(resources_dir):
    reads = load_read_set(resource_path("same_start_reads.sam")).mapped_reads
    contig = reads[0].reference_contig
    loci = parse_loci(f"{contig}:0-1000").result().on_contig(contig)
    tiles = pack_tiles(reads, contig, loci, tile_size=64)
    total_loci = sum(int((t.loci >= 0).sum()) for t in tiles)
    # reads cover [0, 70) only (10 reads at 0, half with deletions to 70)
    covered = set()
    for r in reads:
        covered.update(range(r.start, r.end))
    assert total_loci == len(covered & set(range(0, 1000)))
    for t in tiles:
        real = t.loci >= 0
        assert (t.depth[real] > 0).all()
        assert (t.depth[~real] == 0).all()


def test_pack_tiles_tile_boundaries_consistent(resources_dir):
    """A read spanning a tile boundary must contribute to both tiles."""
    reads = load_read_set(resource_path("same_start_reads.sam")).mapped_reads
    reads = sorted(reads, key=lambda r: r.start)
    contig = reads[0].reference_contig
    loci = parse_loci(f"{contig}:0-70").result().on_contig(contig)
    small = pack_tiles(reads, contig, loci, tile_size=7)
    big = pack_tiles(reads, contig, loci, tile_size=1000)

    def real_depths(tiles):
        return np.concatenate([t.depth[t.loci >= 0] for t in tiles])

    assert sum(int((t.loci >= 0).sum()) for t in small) == sum(
        int((t.loci >= 0).sum()) for t in big
    )
    assert (real_depths(small) == real_depths(big)).all()


def test_depth_bucketing():
    reads = [make_test_read("ACGT", "4M", "4", 0) for _ in range(20)]
    tile = pack_tile(reads, "chr1", range(0, 4))
    assert tile.D == 32  # 20 -> next power of two
    assert (tile.depth == 20).all()


def test_allele_overflow_marks_locus():
    # 9 distinct alleles at one locus with K=4
    reads = [
        make_test_read(b, "1M", "0C0" if b != "C" else "1", 0)
        for b in ["A", "C", "G", "T"]
    ] + [
        make_test_read("C" + b, "1M1I", "1", 0, quality_scores=[30, q])
        for b, q in [("A", 30), ("G", 30), ("T", 30)]
    ]
    tile = pack_tile(reads, "chr1", [0], max_alleles=2)
    assert tile.overflow[0]
    tile_ok = pack_tile(reads, "chr1", [0], max_alleles=8)
    assert not tile_ok.overflow[0]
