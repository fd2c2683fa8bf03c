"""germline-threshold caller tests.

Per-locus expectations ported from the reference suite
(cf. upstream .../commands/GermlineThresholdCallerSuite.scala), plus
tile-path equivalence and parallelism-invariance checks.
"""

import pytest

from guacamole.callers.germline_threshold import (
    call_variants,
    call_variants_at_locus,
)
from guacamole.gio.load import load_read_set
from guacamole.loci.lociset import parse_loci
from guacamole.loci.partition import partition_loci_uniformly
from guacamole.pileup.pileup import Pileup
from guacamole.reads.read import InputFilters

from conftest import resource_path
from fixtures import make_test_read


def test_no_variants_threshold_0():
    reads = [make_test_read("TCGATCGA", "8M", "8", 1) for _ in range(3)]
    pileup = Pileup.from_reads(reads, "chr1", 1)
    genotypes = call_variants_at_locus(pileup, 0)
    assert genotypes
    assert all(g.labels == ("Ref", "Ref") for g in genotypes)


def test_het_variant_threshold_0():
    reads = [
        make_test_read("TCGATCGA", "8M", "8", 1),
        make_test_read("TCGATCGA", "8M", "8", 1),
        make_test_read("GCGATCGA", "8M", "0T7", 1),
    ]
    pileup = Pileup.from_reads(reads, "chr1", 1)
    genotypes = call_variants_at_locus(pileup, 0)
    assert all(g.labels == ("Ref", "Alt") for g in genotypes)


def test_het_variant_threshold_30():
    reads = [
        make_test_read("TCGATCGA", "8M", "8", 1),
        make_test_read("TCGATCGA", "8M", "8", 1),
        make_test_read("GCGATCGA", "8M", "0T7", 1),
    ]
    pileup = Pileup.from_reads(reads, "chr1", 1)
    genotypes = call_variants_at_locus(pileup, 30)
    assert all(g.labels == ("Ref", "Alt") for g in genotypes)


def test_het_variant_threshold_50_not_enough_evidence():
    reads = [
        make_test_read("TCGATCGA", "8M", "8", 1),
        make_test_read("TCGATCGA", "8M", "8", 1),
        make_test_read("GCGATCGA", "8M", "0T7", 1),
    ]
    pileup = Pileup.from_reads(reads, "chr1", 1)
    genotypes = call_variants_at_locus(pileup, 50)
    assert all(g.labels == ("Ref", "Ref") for g in genotypes)


def test_hom_alt_threshold_50():
    reads = [
        make_test_read("TCGATCGA", "8M", "8", 1),
        make_test_read("GCGATCGA", "8M", "0T7", 1),
        make_test_read("GCGATCGA", "8M", "0T7", 1),
    ]
    pileup = Pileup.from_reads(reads, "chr1", 1)
    genotypes = call_variants_at_locus(pileup, 50, emit_ref=False)
    assert len(genotypes) == 1
    g = genotypes[0]
    assert g.labels == ("Alt", "Alt")
    assert g.start == 1
    assert g.allele.ref_bases == b"T"
    assert g.allele.alt_bases == b"G"


def test_hom_alt_no_reference_bases_observed():
    reads = [
        make_test_read("TGGATCGA", "8M", "1C6", 1),
        make_test_read("TGGATCGA", "8M", "1C6", 1),
        make_test_read("TGGATCGA", "8M", "1C6", 1),
    ]
    pileup = Pileup.from_reads(reads, "chr1", 2)
    genotypes = call_variants_at_locus(pileup, 50, emit_ref=False)
    assert len(genotypes) == 1
    g = genotypes[0]
    assert g.start == 2
    assert g.allele.ref_bases == b"C"
    assert g.allele.alt_bases == b"G"
    assert g.labels == ("Alt", "Alt")


def test_heterozygous_deletion_not_called(resources_dir):
    # Regression scenario for hammerlab/guacamole#302.
    filters = InputFilters.create(
        mapped=True, non_duplicate=True, passed_vendor_quality_checks=True
    )
    reads = load_read_set(
        resource_path("synthetic.challenge.set1.normal.v2.withMDTags.chr2.syn1fp.sam"),
        filters,
    ).mapped_reads
    pileup = Pileup.from_reads(reads, "2", 16050070)
    genotypes = call_variants_at_locus(pileup, 8, emit_ref=False)
    assert genotypes == []


def chrm_reads(resources_dir):
    filters = InputFilters.create(
        overlaps_loci=parse_loci("all"), non_duplicate=True, has_mdtag=True
    )
    return load_read_set(resource_path("chrM.sorted.bam"), filters)


class TestTilePathEquivalence:
    @pytest.fixture(scope="class")
    def chrm(self, resources_dir):
        return chrm_reads(resources_dir)

    def test_tile_path_matches_oracle_path(self, chrm):
        """Device-count path and per-pileup oracle must produce identical
        calls over a chrM slice."""
        reads = [r for r in chrm.mapped_reads if r.start < 1200 and r.end > 800]
        loci = parse_loci("chrM:800-1200").result()
        partitions = partition_loci_uniformly(1, loci)
        tile_calls = call_variants(reads, partitions, threshold_percent=8)

        oracle_calls = []
        sorted_reads = sorted(reads, key=lambda r: r.start)
        for locus in range(800, 1200):
            pileup = Pileup.from_reads(sorted_reads, "chrM", locus)
            if pileup.depth:
                oracle_calls.extend(
                    call_variants_at_locus(
                        pileup, 8, emit_ref=False, emit_no_call=False
                    )
                )
        assert sorted(
            (c.contig, c.start, c.allele, c.labels) for c in tile_calls
        ) == sorted((c.contig, c.start, c.allele, c.labels) for c in oracle_calls)

    def test_parallelism_invariance(self, chrm):
        """1 shard vs 5 shards vs 16 shards must yield identical calls."""
        reads = [r for r in chrm.mapped_reads if r.start < 2000]
        loci = parse_loci("chrM:0-2000").result()
        results = []
        for tasks in (1, 5, 16):
            partitions = partition_loci_uniformly(tasks, loci)
            calls = call_variants(reads, partitions, threshold_percent=8)
            results.append(
                sorted((c.contig, c.start, c.allele, c.labels) for c in calls)
            )
        assert results[0] == results[1] == results[2]

    def test_tile_size_invariance(self, chrm):
        reads = [r for r in chrm.mapped_reads if r.start < 2000]
        loci = parse_loci("chrM:0-2000").result()
        partitions = partition_loci_uniformly(2, loci)
        a = call_variants(reads, partitions, tile_size=128)
        b = call_variants(reads, partitions, tile_size=4096)
        assert [(c.start, c.allele) for c in a] == [(c.start, c.allele) for c in b]


def test_compact_cap_overflow_falls_back(chrm_cached, monkeypatch):
    """With the compaction cap forced below the candidate count, the full
    [L, K] refetch fallback must yield identical calls."""
    import guacamole.callers.germline_threshold as gt

    reads = [r for r in chrm_cached.mapped_reads if r.start < 2000]
    loci = parse_loci("chrM:0-2000").result()
    partitions = partition_loci_uniformly(2, loci)
    normal = call_variants(reads, partitions, threshold_percent=8)
    monkeypatch.setattr(gt, "COMPACT_CAP", 1)
    tiny = call_variants(reads, partitions, threshold_percent=8)
    assert [(c.start, c.allele, c.labels) for c in normal] == [
        (c.start, c.allele, c.labels) for c in tiny
    ]
    assert normal  # the slice has calls, so the fallback actually ran


@pytest.fixture(scope="module")
def chrm_cached(resources_dir):
    return chrm_reads(resources_dir)


def test_streaming_matches_whole_file():
    """Per-task .bai-pushdown streaming must call identically to a single
    whole-file load (byte-range decode + per-task sources vs one source)."""
    import os
    import tempfile

    from guacamole.callers.common import load_read_source
    from guacamole.callers.germline_threshold import (
        call_variants,
        call_variants_streaming,
    )
    from guacamole.loci.lociset import parse_loci
    from guacamole.loci.partition import partition_loci_uniformly
    from guacamole.reads.read import InputFilters

    filters = InputFilters.create(
        overlaps_loci=parse_loci("all"), non_duplicate=True, has_mdtag=True
    )
    path = resource_path("chrM.sorted.bam")
    def run(bam, tasks):
        source, contig_lengths = load_read_source(bam, filters)
        loci = parse_loci("all").result(contig_lengths)
        partitions = partition_loci_uniformly(tasks, loci)
        want = call_variants(source, partitions, threshold_percent=8)
        with tempfile.TemporaryDirectory() as cache:
            os.environ["GUAC_CACHE_DIR"] = cache
            try:
                got = call_variants_streaming(
                    bam, filters, partitions, threshold_percent=8
                )
            finally:
                del os.environ["GUAC_CACHE_DIR"]
        return got, want

    def keys(calls):
        return [
            (c.contig, c.start, c.sample_name, c.allele, c.labels)
            for c in calls
        ]

    # Single-task streaming on chrM: pushdown covers the file once.
    got, want = run(path, 1)
    assert got is not None and keys(got) == keys(want)
    # Multi-task on a 16.5 kb contig: .bai's 16 kb windows would cover
    # the whole file per task, but the fine (1 kb) sidecar index splits
    # the byte ranges, so streaming works and matches.
    got, want = run(path, 3)
    assert got is not None and keys(got) == keys(want)
    # Multi-task on a multi-region BAM: disjoint ranges stream per task.
    got, want = run(resource_path("gatk_mini_bundle_extract.bam"), 4)
    assert got is not None and len(want) > 0 and keys(got) == keys(want)


def test_max_alleles_above_nibble_range():
    """K > 15 cannot use 4-bit encodings; the dispatch layer must fall
    back to the unpacked counting kernel instead of asserting."""
    from guacamole.callers.common import load_read_source
    from guacamole.callers.germline_threshold import call_variants
    from guacamole.loci.lociset import parse_loci
    from guacamole.loci.partition import partition_loci_uniformly
    from guacamole.reads.read import InputFilters

    filters = InputFilters.create(
        overlaps_loci=parse_loci("all"), non_duplicate=True, has_mdtag=True
    )
    source, contig_lengths = load_read_source(
        resource_path("chrM.sorted.bam"), filters
    )
    loci = parse_loci("chrM:0-3000").result(contig_lengths)
    partitions = partition_loci_uniformly(1, loci)
    want = call_variants(source, partitions, threshold_percent=8)
    got = call_variants(
        source, partitions, threshold_percent=8, max_alleles=16
    )
    assert [(c.start, c.allele) for c in got] == [
        (c.start, c.allele) for c in want
    ]
