"""Closed-form genotype likelihood tests.

Table-driven expectations ported from the reference suite
(cf. upstream .../likelihood/LikelihoodSuite.scala:58-211).
"""

import math

import pytest

from guacamole.likelihood import (
    likelihood_of_genotype,
    likelihoods_of_all_possible_genotypes_from_pileup,
    probability_correct_ignoring_alignment,
)
from guacamole.pileup.pileup import Pileup
from guacamole.variants.allele import Allele, Genotype

from fixtures import make_test_read

ERROR_30 = 10.0 ** (-30 / 10.0)
ERROR_40 = 10.0 ** (-40 / 10.0)

REFERENCE_BASE = b"C"


def make_genotype(a1: str, a2: str) -> Genotype:
    return Genotype.of(
        Allele(REFERENCE_BASE, a1.encode()), Allele(REFERENCE_BASE, a2.encode())
    )


def ref_read(phred):
    return make_test_read("C", "1M", "1", 1, quality_scores=[phred])


def alt_read(phred):
    return make_test_read("A", "1M", "0C0", 1, quality_scores=[phred])


def check_genotype_likelihoods(reads, expected):
    pileup = Pileup.from_reads(reads, reads[0].reference_contig, 1)
    for (a1, a2), want in expected.items():
        got = likelihood_of_genotype(
            pileup.elements,
            make_genotype(a1, a2),
            probability_correct_ignoring_alignment,
        )
        assert got == pytest.approx(want, abs=1e-12), f"genotype ({a1},{a2})"


def check_all_possible(actual, expected):
    actual_map = {g: l for g, l in actual}
    assert len(actual_map) == len(expected)
    for (a1, a2), want in expected.items():
        assert actual_map[make_genotype(a1, a2)] == pytest.approx(want, abs=1e-12)


def test_all_reads_ref():
    check_genotype_likelihoods(
        [ref_read(30), ref_read(40), ref_read(30)],
        {
            ("C", "C"): (1 - ERROR_30) * (1 - ERROR_40) * (1 - ERROR_30),
            ("C", "A"): 1.0 / 8,
            ("A", "C"): 1.0 / 8,
            ("A", "A"): ERROR_30 * ERROR_40 * ERROR_30,
            ("A", "T"): ERROR_30 * ERROR_40 * ERROR_30,
        },
    )


def test_two_ref_one_alt():
    check_genotype_likelihoods(
        [ref_read(30), ref_read(40), alt_read(30)],
        {
            ("C", "C"): (1 - ERROR_30) * (1 - ERROR_40) * ERROR_30,
            ("C", "A"): 1.0 / 8,
            ("A", "C"): 1.0 / 8,
            ("A", "A"): ERROR_30 * ERROR_40 * (1 - ERROR_30),
            ("A", "T"): ERROR_30 * ERROR_40 * 1 / 2,
            ("T", "T"): ERROR_30 * ERROR_40 * ERROR_30,
        },
    )


def test_one_ref_two_alt():
    check_genotype_likelihoods(
        [ref_read(30), alt_read(40), alt_read(30)],
        {
            ("C", "C"): (1 - ERROR_30) * ERROR_40 * ERROR_30,
            ("C", "A"): 1.0 / 8,
            ("A", "C"): 1.0 / 8,
            ("A", "A"): ERROR_30 * (1 - ERROR_40) * (1 - ERROR_30),
            ("A", "T"): ERROR_30 * 1 / 2 * 1 / 2,
            ("T", "T"): ERROR_30 * ERROR_40 * ERROR_30,
        },
    )


def test_all_reads_alt():
    check_genotype_likelihoods(
        [alt_read(30), alt_read(40), alt_read(30)],
        {
            ("C", "C"): ERROR_30 * ERROR_40 * ERROR_30,
            ("C", "A"): 1.0 / 8,
            ("A", "C"): 1.0 / 8,
            ("A", "A"): (1 - ERROR_30) * (1 - ERROR_40) * (1 - ERROR_30),
            ("A", "T"): 1.0 / 8,
            ("T", "T"): ERROR_30 * ERROR_40 * ERROR_30,
        },
    )


def test_all_possible_genotypes_all_ref():
    pileup = Pileup.from_reads([ref_read(30), ref_read(40), ref_read(30)], "chr1", 1)
    check_all_possible(
        likelihoods_of_all_possible_genotypes_from_pileup(pileup),
        {("C", "C"): (1 - ERROR_30) * (1 - ERROR_40) * (1 - ERROR_30)},
    )


def test_all_possible_genotypes_mixed():
    pileup = Pileup.from_reads([ref_read(30), ref_read(40), alt_read(30)], "chr1", 1)
    check_all_possible(
        likelihoods_of_all_possible_genotypes_from_pileup(pileup),
        {
            ("C", "C"): (1 - ERROR_30) * (1 - ERROR_40) * ERROR_30,
            ("A", "C"): 1 / 8.0,
            ("A", "A"): ERROR_30 * ERROR_40 * (1 - ERROR_30),
        },
    )


def test_all_possible_genotypes_all_alt():
    pileup = Pileup.from_reads([alt_read(30), alt_read(40), alt_read(30)], "chr1", 1)
    check_all_possible(
        likelihoods_of_all_possible_genotypes_from_pileup(pileup),
        {("A", "A"): (1 - ERROR_30) * (1 - ERROR_40) * (1 - ERROR_30)},
    )


def test_log_space_all_ref():
    pileup = Pileup.from_reads([ref_read(30), ref_read(40), ref_read(30)], "chr1", 1)
    check_all_possible(
        likelihoods_of_all_possible_genotypes_from_pileup(pileup, log_space=True),
        {
            ("C", "C"): math.log(1 - ERROR_30)
            + math.log(1 - ERROR_40)
            + math.log(1 - ERROR_30)
        },
    )


def test_log_space_mixed():
    pileup = Pileup.from_reads([ref_read(30), ref_read(40), alt_read(30)], "chr1", 1)
    check_all_possible(
        likelihoods_of_all_possible_genotypes_from_pileup(pileup, log_space=True),
        {
            ("C", "C"): math.log(1 - ERROR_30)
            + math.log(1 - ERROR_40)
            + math.log(ERROR_30),
            ("A", "C"): math.log(1.0 / 8),
            ("A", "A"): math.log(ERROR_30)
            + math.log(ERROR_40)
            + math.log(1 - ERROR_30),
        },
    )


def test_normalized_likelihoods_sum_to_one():
    pileup = Pileup.from_reads([ref_read(30), ref_read(40), alt_read(30)], "chr1", 1)
    results = likelihoods_of_all_possible_genotypes_from_pileup(
        pileup, normalize=True
    )
    assert sum(l for _, l in results) == pytest.approx(1.0, abs=1e-12)


def test_evidence_from_pileup():
    # cf. AlleleEvidenceSuite.scala
    from guacamole.variants.evidence import AlleleEvidence

    reads = [
        make_test_read("TCGATCGA", "8M", "1A6", 1, alignment_quality=30),
        make_test_read("TCGATCGA", "8M", "1A6", 1, alignment_quality=30),
        make_test_read("TCGACCCTCGA", "4M3I4M", "1A6", 1, alignment_quality=60),
    ]
    pileup = Pileup.from_reads(reads, "chr1", 2)
    evidence = AlleleEvidence.from_pileup(0.5, Allele.from_strings("A", "C"), pileup)
    assert evidence.mean_mapping_quality == 40.0
    assert evidence.median_mapping_quality == 30
    assert evidence.median_mismatches_per_read == 1


def test_evidence_one_read_supports():
    from guacamole.variants.evidence import AlleleEvidence

    reads = [
        make_test_read("TAGATCGA", "8M", "8", 1, alignment_quality=30),
        make_test_read("TCGATCGA", "8M", "1A6", 1, alignment_quality=60),
        make_test_read("TAGACCCTCGA", "4M3I4M", "8", 1, alignment_quality=60),
    ]
    pileup = Pileup.from_reads(reads, "chr1", 2)
    evidence = AlleleEvidence.from_pileup(0.5, Allele.from_strings("A", "C"), pileup)
    assert evidence.mean_mapping_quality == 60.0
    assert evidence.median_mapping_quality == 60
    assert evidence.median_mismatches_per_read == 1


def test_evidence_no_read_supports():
    from guacamole.variants.evidence import AlleleEvidence

    reads = [
        make_test_read("TAGATCGA", "8M", "8", 1, alignment_quality=30),
        make_test_read("TAGATCGA", "8M", "8", 1, alignment_quality=60),
        make_test_read("TAGACCCTCGA", "4M3I4M", "8", 1, alignment_quality=60),
    ]
    pileup = Pileup.from_reads(reads, "chr1", 2)
    evidence = AlleleEvidence.from_pileup(0.5, Allele.from_strings("A", "C"), pileup)
    assert math.isnan(evidence.mean_mapping_quality)
    assert math.isnan(evidence.median_mapping_quality)
    assert math.isnan(evidence.median_mismatches_per_read)


def test_vectorized_pairs_bitwise_vs_scalar_oracle():
    """log_likelihoods_of_genotype_pairs (and the success-probability LUT)
    must be bit-identical to likelihoods_of_genotypes across random
    pileups, with and without the alignment term, normalized and not."""
    import numpy as np

    from guacamole.likelihood import (
        likelihoods_of_genotypes,
        log_likelihoods_of_genotype_pairs,
        possible_genotypes_of_pileup,
        probability_correct_including_alignment,
        success_probabilities_of_quals,
    )

    rng = np.random.RandomState(7)
    bases = "ACGT"
    for trial in range(30):
        # Quality/depth ranges bounded so normalized likelihoods stay in
        # the oracle's domain (exp-sum underflowing to exactly 0.0 makes
        # the scalar path raise on log(0); genuine pileups never get
        # there with these caps).
        depth = int(rng.randint(1, 45))
        reads = []
        for _ in range(depth):
            ref = bases[rng.randint(4)]
            alt = bases[rng.randint(4)]
            md = "8" if alt == ref else "0%s7" % ref
            seq = alt + "CGATCGA"
            reads.append(
                make_test_read(
                    seq,
                    "8M",
                    md,
                    1,
                    quality_scores=[int(rng.randint(2, 46))] * 8,
                    # MAPQ 0 makes the alignment-included probability
                    # exactly 0.0 and the oracle raises on log(0); the
                    # callers' MAPQ>=1 pileup filter excludes it first.
                    alignment_quality=int(rng.randint(1, 90)),
                )
            )
        pileup = Pileup.from_reads(reads, "chr1", 1)
        genotypes = possible_genotypes_of_pileup(pileup)
        if not genotypes:
            continue
        alleles = sorted({a for g in genotypes for a in g.alleles})
        allele_index = {a: i for i, a in enumerate(alleles)}
        # elements whose allele is not in the (standard-filtered) set get an
        # id outside the pair id space, contributing 1-p to every row
        element_ids = np.asarray(
            [allele_index.get(e.allele, len(alleles)) for e in pileup.elements]
        )
        pairs = [
            tuple(allele_index[a] for a in g.alleles) for g in genotypes
        ]
        quals = np.asarray([e.quality_score for e in pileup.elements])
        mapqs = np.asarray(
            [e.read.alignment_quality for e in pileup.elements]
        )
        for include_alignment in (False, True):
            if include_alignment:
                success = success_probabilities_of_quals(
                    quals
                ) * success_probabilities_of_quals(mapqs)
                pc = probability_correct_including_alignment
            else:
                success = success_probabilities_of_quals(quals)
                pc = None
            for normalize in (False, True):
                kwargs = dict(log_space=True, normalize=normalize)
                if pc is not None:
                    kwargs["probability_correct"] = pc
                oracle = likelihoods_of_genotypes(
                    pileup.elements, genotypes, **kwargs
                )
                fast = log_likelihoods_of_genotype_pairs(
                    element_ids, success, pairs, normalize=normalize
                )
                assert [float(x) for x in fast] == oracle, (
                    trial, include_alignment, normalize
                )
    # edge: no elements
    empty = log_likelihoods_of_genotype_pairs(
        np.empty(0, dtype=int), np.empty(0), [(0, 0)], normalize=False
    )
    assert list(empty) == [0.0]


def test_genotype_probs_rows_bitwise():
    """genotype_probs_for_rows (batched across tile rows, with padded
    slots interspersed) must be bit-identical to per-row
    genotype_probs_for_row over random row batches, with and without the
    alignment term."""
    import numpy as np

    from guacamole.likelihood import (
        genotype_probs_for_row,
        genotype_probs_for_rows,
    )

    rng = np.random.RandomState(11)
    K = 8
    for trial in range(20):
        R = int(rng.randint(1, 12))
        D = int(rng.randint(1, 60))
        aid = rng.randint(0, K, size=(R, D)).astype(np.int16)
        quals = rng.randint(2, 46, size=(R, D)).astype(np.int16)
        mapqs = rng.randint(1, 90, size=(R, D)).astype(np.int16)
        keeps = rng.rand(R, D) < rng.rand()  # some rows mostly empty
        std = rng.rand(R, K) < 0.7
        for use_mapq in (False, True):
            for log_space in (False, True):
                batched = genotype_probs_for_rows(
                    aid,
                    quals,
                    keeps,
                    std,
                    mapqs=mapqs if use_mapq else None,
                    log_space=log_space,
                )
                for r in range(R):
                    kept = np.flatnonzero(keeps[r])
                    pairs, lls = genotype_probs_for_row(
                        aid[r][kept],
                        quals[r][kept],
                        std[r],
                        mapqs=mapqs[r][kept] if use_mapq else None,
                        log_space=log_space,
                    )
                    bpairs, blls = batched[r]
                    assert bpairs == pairs, (trial, r)
                    assert [float(x) for x in blls] == [
                        float(x) for x in lls
                    ], (trial, r, use_mapq, log_space)


def test_zero_probability_jvm_log_semantics():
    """Base quality 0 gives a zero success probability; the reference's
    Math.log(0.0) is -Infinity (not an error), and every likelihood path
    (scalar oracle, per-row, batched rows) must agree bitwise."""
    import numpy as np

    from guacamole.likelihood import (
        genotype_probs_for_row,
        genotype_probs_for_rows,
        likelihoods_of_all_possible_genotypes_from_pileup,
    )

    # two reads supporting alt 'T' at qual 0 and one ref at qual 30
    reads = [
        make_test_read("TCGATCGA", "8M", "0A7", 1, quality_scores=[0] * 8),
        make_test_read("TCGATCGA", "8M", "0A7", 1, quality_scores=[0] * 8),
        make_test_read("ACGATCGA", "8M", "8", 1, quality_scores=[30] * 8),
    ]
    pileup = Pileup.from_reads(reads, "chr1", 1)
    oracle = likelihoods_of_all_possible_genotypes_from_pileup(
        pileup, log_space=True, normalize=True
    )
    assert len(oracle) == 3  # AA, AT, TT
    values = [ll for _, ll in oracle]
    # hom-alt TT multiplies the qual-0 ref element's 0.0 probability in
    assert any(v == float("-inf") for v in values)

    aid = np.asarray([[1, 1, 0]], dtype=np.int16)  # A < T dense order
    quals = np.asarray([[0, 0, 30]], dtype=np.int16)
    keeps = np.ones((1, 3), dtype=bool)
    std = np.ones((1, 2), dtype=bool)
    pairs, row_lls = genotype_probs_for_row(
        aid[0], quals[0], std[0], log_space=True
    )
    (bpairs, batch_lls), = genotype_probs_for_rows(
        aid, quals, keeps, std, log_space=True
    )
    assert bpairs == pairs
    assert [float(x) for x in batch_lls] == [float(x) for x in row_lls]
    assert sorted(map(float, row_lls)) == sorted(map(float, values))


@pytest.mark.parametrize("seed", range(4))
def test_evidence_stats_batch_bitwise(seed):
    """AlleleEvidence.stats_batch must equal the scalar from_arrays form
    bit-for-bit across random masked rows (incl. empty masks -> nan and
    odd/even counts)."""
    import numpy as np

    from guacamole.variants.evidence import AlleleEvidence

    rng = np.random.RandomState(seed)
    R, D = 37, 23
    mask = rng.rand(R, D) < rng.rand(R, 1)  # some rows near-empty
    mask[0] = False  # guaranteed empty row
    mapqs = rng.randint(0, 61, size=(R, D)).astype(np.int16)
    quals = rng.randint(2, 41, size=(R, D)).astype(np.int16)
    mismatches = rng.randint(0, 9, size=(R, D)).astype(np.int16)

    batch = AlleleEvidence.stats_batch(mask, mapqs, quals, mismatches)
    for j in range(R):
        ref = AlleleEvidence.from_arrays(
            0.5,
            read_depth=D,
            allele_read_depth=int(mask[j].sum()),
            forward_depth=0,
            allele_forward_depth=0,
            mapqs=mapqs[j][mask[j]],
            quals=quals[j][mask[j]],
            mismatches=mismatches[j][mask[j]],
        )
        got = (
            float(batch[0][j]), float(batch[1][j]), float(batch[2][j]),
            float(batch[3][j]), float(batch[4][j]),
        )
        want = (
            ref.mean_mapping_quality, ref.median_mapping_quality,
            ref.mean_base_quality, ref.median_base_quality,
            ref.median_mismatches_per_read,
        )
        for g, w in zip(got, want):
            if math.isnan(w):
                assert math.isnan(g)
            else:
                assert g == w, (j, got, want)


def test_deep_pileup_normalization_stays_finite():
    """Depth beyond the exp-underflow point (reference emits inf/NaN,
    DEVIATIONS.md #11): normalized likelihoods must be finite, sum to ~1,
    and pick the right genotype."""
    import math

    import numpy as np

    from guacamole.likelihood import log_likelihoods_of_genotype_pairs

    rng = np.random.default_rng(3)
    # depth 4000: full exp underflow; depth 1040: the subnormal-exp
    # window where the unshifted normalization is wrong by large factors
    # (a 1.47 "probability" was observed there)
    for depth in (4000, 1040):
        # het locus: half ref (allele 0), half alt (allele 1)
        ids = rng.integers(0, 2, size=depth)
        success = np.full(depth, 0.9999)  # qual 40
        pairs = [(0, 0), (0, 1), (1, 1)]
        lls = log_likelihoods_of_genotype_pairs(
            ids, success, pairs, normalize=True
        )
        assert np.all(np.isfinite(lls)), (depth, lls)
        probs = np.exp(lls)
        assert abs(probs.sum() - 1.0) < 1e-6, (depth, probs)
        assert probs.max() <= 1.0 + 1e-12, (depth, probs)
        assert int(np.argmax(lls)) == 1  # het genotype wins


def test_shallow_normalization_unchanged_by_fallback():
    """The logsumexp fallback must not perturb the non-underflow regime:
    plain sequential normalization and the helper agree bitwise."""
    import math

    from guacamole.likelihood import _normalization_log_total

    lls = [-3.5, -1.25, -700.0, -0.5]
    total = 0.0
    for ll in lls:
        total += math.exp(ll)
    assert _normalization_log_total(lls) == math.log(total)
    # all -inf: stays -inf (empty pileup corner)
    assert _normalization_log_total([float("-inf")] * 3) == float("-inf")


def test_phred_conversion_jvm_edge_semantics():
    """The phred conversions must reproduce the JVM's unchecked edge
    arithmetic (AlleleEvidence.scala:52 / GenotypeFilter.scala:135): in
    the deep-pileup subnormal window the reference's own normalization
    yields success 'probabilities' > 1 (DEVIATIONS #11), so the error
    probability goes NEGATIVE — Java's Math.log10 gives NaN and
    Math.round(NaN) gives 0, where Python's math.log10 would raise.
    Found by the round-5 fuzz campaign crashing the exact-confirm
    emission prefilter."""
    import math

    from guacamole.utils.phred import (
        error_probability_to_phred,
        success_probability_to_phred,
    )

    # The subnormal-window artifact: probability 1.47 (the documented
    # observed value) -> error probability -0.47 -> GQ 0, not a crash.
    assert success_probability_to_phred(1.47 - 1e-10) == 0
    assert error_probability_to_phred(-0.47) == 0
    assert error_probability_to_phred(float("nan")) == 0
    # log10(+0.0) = -Inf; Math.round(+Infinity) == Long.MAX_VALUE.
    assert error_probability_to_phred(0.0) == (1 << 63) - 1
    # Ordinary values unchanged.
    assert error_probability_to_phred(1e-4) == 40
    assert success_probability_to_phred(0.9999 - 1e-10) == 40
    assert error_probability_to_phred(1.0) == 0
