"""germline-standard (Bayesian) caller tests: per-pileup behavior plus
two-phase (device screen + host confirm) equivalence with the oracle path."""

import math

import pytest

from guacamole.callers.germline_standard import (
    call_variants,
    call_variants_at_locus,
)
from guacamole.filters.genotype_filters import apply_genotype_filters
from guacamole.gio.load import load_read_set
from guacamole.loci.lociset import parse_loci
from guacamole.loci.partition import partition_loci_uniformly
from guacamole.pileup.pileup import Pileup
from guacamole.reads.read import InputFilters

from conftest import resource_path
from fixtures import make_test_read


def test_hom_alt_called():
    reads = [make_test_read("GCGATCGA", "8M", "0T7", 1) for _ in range(3)]
    pileup = Pileup.from_reads(reads, "chr1", 1)
    calls = call_variants_at_locus(pileup)
    # Hom-alt genotypes have TWO non-reference alleles, and the reference
    # emits one record per non-reference allele (:113) — so two records.
    assert len(calls) == 2
    call = calls[0]
    assert call.allele.ref_bases == b"T"
    assert call.allele.alt_bases == b"G"
    assert call.evidence.likelihood > 0.99
    assert call.evidence.read_depth == 3
    assert call.evidence.allele_read_depth == 3


def test_het_called():
    reads = [
        make_test_read("TCGATCGA", "8M", "8", 1),
        make_test_read("TCGATCGA", "8M", "8", 1),
        make_test_read("GCGATCGA", "8M", "0T7", 1),
        make_test_read("GCGATCGA", "8M", "0T7", 1),
    ]
    pileup = Pileup.from_reads(reads, "chr1", 1)
    calls = call_variants_at_locus(pileup)
    assert len(calls) == 1
    assert calls[0].allele.alt_bases == b"G"


def test_all_ref_no_call():
    reads = [make_test_read("TCGATCGA", "8M", "8", 1) for _ in range(3)]
    pileup = Pileup.from_reads(reads, "chr1", 1)
    assert call_variants_at_locus(pileup) == []


def test_mapq_filter_removes_evidence():
    reads = [
        make_test_read("TCGATCGA", "8M", "8", 1, alignment_quality=60),
        make_test_read("GCGATCGA", "8M", "0T7", 1, alignment_quality=0),
    ]
    pileup = Pileup.from_reads(reads, "chr1", 1)
    # With the low-MAPQ alt read filtered, only the ref allele remains.
    assert call_variants_at_locus(pileup, min_alignment_quality=1) == []


def test_likelihood_uses_filtered_but_evidence_uses_unfiltered():
    # Evidence statistics come from the UNfiltered sample pileup
    # (GermlineStandardCaller.scala:119).
    reads = [
        make_test_read("GCGATCGA", "8M", "0T7", 1, alignment_quality=60),
        make_test_read("GCGATCGA", "8M", "0T7", 1, alignment_quality=60),
        make_test_read("TCGATCGA", "8M", "8", 1, alignment_quality=0),
    ]
    pileup = Pileup.from_reads(reads, "chr1", 1)
    calls = call_variants_at_locus(pileup, min_alignment_quality=1)
    assert len(calls) == 2  # hom-alt: one record per non-reference allele
    assert calls[0].evidence.read_depth == 3  # unfiltered depth


def test_genotype_filters():
    reads = [make_test_read("GCGATCGA", "8M", "0T7", 1) for _ in range(3)]
    pileup = Pileup.from_reads(reads, "chr1", 1)
    calls = call_variants_at_locus(pileup)
    assert apply_genotype_filters(calls, min_read_depth=4) == []
    assert apply_genotype_filters(calls, min_read_depth=3) == calls
    assert apply_genotype_filters(calls, max_read_depth=3) == []
    assert apply_genotype_filters(calls, min_alternate_read_depth=4) == []
    assert apply_genotype_filters(calls, min_likelihood=5) == calls


def test_debug_genotype_filters_prints_counts(capsys):
    """--debug-genotype-filters prints the genotype count after each step
    (GenotypeFilter.scala:116-119)."""
    reads = [make_test_read("GCGATCGA", "8M", "0T7", 1) for _ in range(3)]
    pileup = Pileup.from_reads(reads, "chr1", 1)
    calls = call_variants_at_locus(pileup)
    apply_genotype_filters(
        calls, min_alternate_read_depth=1, min_likelihood=5, debug=True
    )
    err = capsys.readouterr().err
    assert err.count("Filtered genotypes down to") == 3


class TestTwoPhaseEquivalence:
    @pytest.fixture(scope="class")
    def chrm(self, resources_dir):
        filters = InputFilters.create(
            overlaps_loci=parse_loci("all"), non_duplicate=True, has_mdtag=True
        )
        return load_read_set(resource_path("chrM.sorted.bam"), filters)

    def test_matches_oracle_on_chrm_slice(self, chrm):
        reads = [r for r in chrm.mapped_reads if r.start < 2500]
        loci = parse_loci("chrM:0-2500").result()
        partitions = partition_loci_uniformly(3, loci)
        fast_calls = call_variants(reads, partitions, min_alignment_quality=1)

        oracle_calls = []
        sorted_reads = sorted(reads, key=lambda r: r.start)
        for locus in range(0, 2500):
            pileup = Pileup.from_reads(sorted_reads, "chrM", locus)
            if pileup.depth:
                oracle_calls.extend(
                    call_variants_at_locus(pileup, min_alignment_quality=1)
                )

        def key(c):
            return (c.reference_contig, c.start, c.allele)

        assert sorted(map(key, fast_calls)) == sorted(map(key, oracle_calls))
        # likelihoods must be bit-identical (same f64 op order)
        fast_by_key = {key(c): c.evidence.likelihood for c in fast_calls}
        for c in oracle_calls:
            assert fast_by_key[key(c)] == c.evidence.likelihood

    def test_parallelism_invariance(self, chrm):
        reads = [r for r in chrm.mapped_reads if r.start < 1500]
        loci = parse_loci("chrM:0-1500").result()
        results = []
        for tasks in (1, 4):
            partitions = partition_loci_uniformly(tasks, loci)
            calls = call_variants(reads, partitions)
            results.append(
                sorted((c.start, c.allele, c.evidence.likelihood) for c in calls)
            )
        assert results[0] == results[1]


def test_tile_row_confirm_bitwise():
    """calls_from_tile_row (the vectorized exact f64 confirm) must equal
    call_variants_at_locus bit-for-bit on EVERY evidence field, at every
    covered chrM locus in the slice, for both the native-columnar and
    object packers."""
    import dataclasses

    from guacamole.callers.common import load_read_source
    from guacamole.callers.germline_standard import calls_from_tile_row
    from guacamole.callers.source import ReadSource

    filters = InputFilters.create(
        overlaps_loci=parse_loci("all"), non_duplicate=True, has_mdtag=True
    )
    columnar, _ = load_read_source(resource_path("chrM.sorted.bam"), filters)
    objects = ReadSource.from_reads(columnar.reads_list())
    loci = list(range(0, 1200))
    for source in (columnar, objects):
        sparse = source.pack_sparse_tile("chrM", loci)
        for si in range(sparse.L):
            if not sparse.depth[si] or sparse.overflow[si]:
                continue
            fast = calls_from_tile_row(
                sparse, si, "default", min_alignment_quality=1
            )
            pileup = source.pileup_at(
                "chrM", int(sparse.loci[si]),
                reference_base=int(sparse.ref_base[si]),
            )
            oracle = call_variants_at_locus(pileup, min_alignment_quality=1)
            assert len(fast) == len(oracle)
            for f, o in zip(fast, oracle):
                assert (f.sample_name, f.reference_contig, f.start, f.allele) == (
                    o.sample_name, o.reference_contig, o.start, o.allele
                )
                fe = dataclasses.asdict(f.evidence)
                oe = dataclasses.asdict(o.evidence)
                assert fe == oe, (int(sparse.loci[si]), fe, oe)


def test_native_likelihood_screen_matches_oracle():
    """The device genotype-likelihood screen (native columnar path, csr/ll
    tiles) must reproduce the exact per-locus oracle, including f64
    likelihood values."""
    from guacamole.callers.common import load_read_source

    filters = InputFilters.create(
        overlaps_loci=parse_loci("all"), non_duplicate=True, has_mdtag=True
    )
    source, contig_lengths = load_read_source(
        resource_path("chrM.sorted.bam"), filters
    )
    loci = parse_loci("chrM:0-2500").result(contig_lengths)
    partitions = partition_loci_uniformly(3, loci)
    fast_calls = call_variants(source, partitions, min_alignment_quality=1)

    oracle_calls = []
    for locus in range(0, 2500):
        pileup = source.pileup_at("chrM", locus)
        if pileup.depth:
            oracle_calls.extend(
                call_variants_at_locus(pileup, min_alignment_quality=1)
            )

    def key(c):
        return (c.reference_contig, c.start, c.allele)

    assert sorted(map(key, fast_calls)) == sorted(map(key, oracle_calls))
    fast_by_key = {key(c): c.evidence.likelihood for c in fast_calls}
    for c in oracle_calls:
        assert fast_by_key[key(c)] == c.evidence.likelihood


def test_prefilter_min_likelihood_order_equivalent(resources_dir):
    """Emission-time min-likelihood prefiltering must equal filtering
    after the fact when the chain's earlier filters are inert."""
    from guacamole.callers.germline_standard import call_variants
    from guacamole.callers.source import ReadSource
    from guacamole.filters.genotype_filters import (
        apply_genotype_filters,
    )
    from guacamole.gio.load import load_read_set
    from guacamole.loci.partition import partition_loci_uniformly
    from guacamole.loci.lociset import parse_loci
    from guacamole.reads.read import InputFilters

    from conftest import resource_path

    read_set = load_read_set(
        resource_path("chrM.sorted.bam"),
        InputFilters.create(non_duplicate=True, has_mdtag=True),
    )
    source = ReadSource.from_reads(read_set.mapped_reads)
    loci = parse_loci("chrM:0-4000").result(read_set.contig_lengths)
    parts = partition_loci_uniformly(2, loci)
    plain = apply_genotype_filters(
        call_variants(source, parts, min_alignment_quality=1),
        min_likelihood=40,
    )
    pre = apply_genotype_filters(
        call_variants(
            source, parts, min_alignment_quality=1,
            prefilter_min_likelihood=40,
        ),
        min_likelihood=40,
    )
    assert len(plain) > 0
    assert [
        (c.reference_contig, c.start, c.allele, c.evidence) for c in plain
    ] == [(c.reference_contig, c.start, c.allele, c.evidence) for c in pre]
