"""Device kernels over packed locus tiles (JAX/XLA).

These are the per-locus compute primitives of every caller, vectorized over
whole tiles of loci at once instead of per-locus objects:

 - allele/strand counting (germline-threshold, evidence stats, VAF)
 - per-element correctness probabilities from base/mapping qualities
 - diploid genotype log-likelihoods over all allele pairs (germline-standard
   and somatic screening; cf. the per-locus math at upstream
   .../likelihood/Likelihood.scala:149-201 — here one fused computation for
   L loci x D depth x P genotype pairs)

All kernels take fixed-shape arrays ([L, D] with -1/False padding) so XLA
compiles each (L, D, K) bucket once. f32 on device; exact f64 confirmation
for emitted calls happens host-side at candidate loci only.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

LOG2 = float(np.log(2.0))


@functools.lru_cache(maxsize=None)
def genotype_pairs(max_alleles: int) -> Tuple[np.ndarray, np.ndarray]:
    """Unordered diploid genotype index pairs (i <= j) over K alleles, in
    the same enumeration order as the reference (i outer, j inner)."""
    pairs = [
        (i, j)
        for i in range(max_alleles)
        for j in range(i, max_alleles)
    ]
    i_idx = np.array([p[0] for p in pairs], dtype=np.int32)
    j_idx = np.array([p[1] for p in pairs], dtype=np.int32)
    return i_idx, j_idx


def phred_to_success(phred: jnp.ndarray) -> jnp.ndarray:
    return 1.0 - jnp.power(10.0, phred.astype(jnp.float32) / -10.0)


@functools.partial(jax.jit, static_argnames=("max_alleles",))
def allele_counts(
    allele_id: jnp.ndarray,  # [L, D] int
    strand: jnp.ndarray,  # [L, D] bool
    valid: jnp.ndarray,  # [L, D] bool
    max_alleles: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-locus allele counts and forward-strand counts: [L, K] int32."""
    one_hot = (
        (allele_id[:, :, None] == jnp.arange(max_alleles, dtype=allele_id.dtype))
        & valid[:, :, None]
    )
    counts = jnp.sum(one_hot, axis=1, dtype=jnp.int32)
    fwd = jnp.sum(one_hot & strand[:, :, None], axis=1, dtype=jnp.int32)
    return counts, fwd


@functools.partial(jax.jit, static_argnames=("include_alignment",))
def probability_correct(
    qual: jnp.ndarray,  # [L, D] int
    mapq: jnp.ndarray,  # [L, D] int
    valid: jnp.ndarray,  # [L, D] bool
    include_alignment: bool = False,
) -> jnp.ndarray:
    """P(sequenced bases correct) per element, 0 outside valid slots."""
    pc = phred_to_success(qual)
    if include_alignment:
        pc = pc * phred_to_success(mapq)
    return jnp.where(valid, pc, 0.0)


@functools.partial(jax.jit, static_argnames=("max_alleles",))
def genotype_log_likelihoods(
    allele_id: jnp.ndarray,  # [L, D] int
    pc: jnp.ndarray,  # [L, D] f32 probability-correct
    valid: jnp.ndarray,  # [L, D] bool
    max_alleles: int,
) -> jnp.ndarray:
    """log L(g) for all K(K+1)/2 diploid genotypes per locus: [L, P] f32.

    log L(i,j) = sum_d log(p(i,d) + p(j,d)) - depth * log 2
    with p(a,d) = pc(d) if element d carries allele a else 1 - pc(d).
    """
    i_idx, j_idx = genotype_pairs(max_alleles)
    i_idx = jnp.asarray(i_idx)
    j_idx = jnp.asarray(j_idx)
    # [L, D, K]: per-element probability under each allele hypothesis
    k_range = jnp.arange(max_alleles, dtype=allele_id.dtype)
    matches = allele_id[:, :, None] == k_range  # [L, D, K]
    p = jnp.where(matches, pc[:, :, None], 1.0 - pc[:, :, None])
    # [L, D, P] pair sums -> log -> masked sum over depth
    pair_sum = p[:, :, i_idx] + p[:, :, j_idx]
    log_terms = jnp.where(valid[:, :, None], jnp.log(pair_sum), 0.0)
    depth = jnp.sum(valid, axis=1, dtype=jnp.float32)  # [L]
    return jnp.sum(log_terms, axis=1) - depth[:, None] * LOG2


class PackedScreen(NamedTuple):
    counts: jnp.ndarray  # [L, K] allele counts (int32)
    candidates: jnp.ndarray  # [L] bool


@functools.partial(
    jax.jit, static_argnames=("max_alleles", "threshold_percent")
)
def tile_stats_nibble(
    packed: jnp.ndarray,  # [L, ceil(D/2)] uint8, two 4-bit allele ids/byte
    is_variant: jnp.ndarray,  # [L, K] bool
    max_alleles: int,
    threshold_percent=None,
) -> PackedScreen:
    """Counting + candidate screen over nibble-packed allele ids.

    The host packs each element's allele id into 4 bits (0xF = empty /
    invalid slot; low nibble = even depth slot, high nibble = odd), which
    is the minimal transfer encoding for the counting screen: no caller
    consumes per-element strand/qual on device (evidence stats are exact
    host-side at candidate loci), so one byte carries two elements.
    Requires max_alleles <= 15. Semantics identical to tile_stats on the
    unpacked arrays (same counts, same candidate rule).
    """
    assert max_alleles <= 15, "nibble packing reserves 0xF for empty slots"
    lo = packed & jnp.uint8(0xF)
    hi = packed >> jnp.uint8(4)
    k_range = jnp.arange(max_alleles, dtype=jnp.uint8)
    counts = jnp.sum(
        lo[:, :, None] == k_range, axis=1, dtype=jnp.int32
    ) + jnp.sum(hi[:, :, None] == k_range, axis=1, dtype=jnp.int32)
    depth = jnp.sum(lo != jnp.uint8(0xF), axis=1, dtype=jnp.int32) + jnp.sum(
        hi != jnp.uint8(0xF), axis=1, dtype=jnp.int32
    )
    candidates = counts_candidates(counts, depth, is_variant, threshold_percent)
    return PackedScreen(counts, candidates)


def counts_candidates(counts, depth, is_variant, threshold_percent):
    """THE candidate rule, shared by every counting screen (nibble, CSR,
    dense tile_stats, and the mesh per-shard bodies).

    Without a threshold, a locus is a candidate if any variant allele has
    evidence. With threshold_percent, the exact germline-threshold passing
    rule (count * 100 // depth > threshold, rewritten division-free as
    count * 100 >= depth * (threshold + 1) for positive counts):
    candidates are loci where a variant allele passes — or where two
    reference alleles pass (the mixed-N corner that classify_locus must
    still see, GermlineThresholdCaller.scala:155-175)."""
    if threshold_percent is None:
        return jnp.any((counts > 0) & is_variant, axis=1)
    passing = (counts > 0) & (
        counts * 100 >= depth[:, None] * (threshold_percent + 1)
    )
    return jnp.any(passing & is_variant, axis=1) | (
        jnp.sum(passing & ~is_variant, axis=1) >= 2
    )


def csr_screen_math(
    packed, row_off, is_variant, max_alleles, threshold_percent
):
    """Shared math of the CSR counting screens: [L, K] int32 counts and
    the [L] bool candidate mask (thresholded when threshold_percent is
    given, else any-variant-evidence). Called by the jitted single-device
    kernels below AND by the shard_map'd mesh screen (parallel/mesh.py) —
    ONE source of truth for the counting/candidate semantics."""
    lo = packed & jnp.uint8(0xF)
    hi = packed >> jnp.uint8(4)
    k_range = jnp.arange(max_alleles, dtype=jnp.uint8)
    one_hot = (lo[:, None] == k_range).astype(jnp.int32) + (
        hi[:, None] == k_range
    ).astype(jnp.int32)  # [B, K]
    prefix = jnp.concatenate(
        [
            jnp.zeros((1, max_alleles), jnp.int32),
            jnp.cumsum(one_hot, axis=0),
        ],
        axis=0,
    )  # [B+1, K]
    counts = prefix[row_off[1:]] - prefix[row_off[:-1]]  # [L, K]
    candidates = counts_candidates(
        counts, jnp.sum(counts, axis=1), is_variant, threshold_percent
    )
    return counts, candidates


@functools.partial(
    jax.jit, static_argnames=("max_alleles", "threshold_percent")
)
def tile_stats_csr(
    packed: jnp.ndarray,  # [B] uint8 nibble pairs, rows byte-aligned
    row_off: jnp.ndarray,  # [L+1] int32 byte offsets per row
    is_variant: jnp.ndarray,  # [L, K] bool
    max_alleles: int,
    threshold_percent=None,
) -> PackedScreen:
    """Counting screen over CSR nibble-packed elements (no depth axis).

    Each locus row's elements occupy bytes [row_off[r], row_off[r+1]) of
    packed (0xF = pad nibble). Counts come from a per-byte one-hot prefix
    sum differenced at row boundaries — dense, deterministic math with no
    scatters, and zero transfer padding beyond one nibble per odd-depth
    row. Depth (valid elements) is recovered as the row sum of counts,
    exactly matching tile_stats semantics on the unpacked arrays.
    """
    assert max_alleles <= 15, "nibble packing reserves 0xF for empty slots"
    counts, candidates = csr_screen_math(
        packed, row_off, is_variant, max_alleles, threshold_percent
    )
    # int16 halves the device->host transfer. Values only wrap at rows
    # deeper than 32767 elements, which the packer flags as overflow
    # (exact host fallback) — their device counts are never read.
    return PackedScreen(counts.astype(jnp.int16), candidates)


@functools.partial(
    jax.jit, static_argnames=("max_alleles", "threshold_percent", "cap")
)
def tile_stats_csr_compact(
    packed: jnp.ndarray,  # [B] uint8 nibble pairs, rows byte-aligned
    row_off: jnp.ndarray,  # [L+1] int32 byte offsets per row
    is_variant: jnp.ndarray,  # [L, K] bool
    max_alleles: int,
    threshold_percent=None,
    cap: int = 512,
) -> jnp.ndarray:
    """tile_stats_csr with device-side candidate compaction.

    Callers that emit only variant calls (no --emit-ref/--emit-no-call)
    read counts solely at candidate loci, so shipping the whole [L, K]
    count matrix to host wastes device->host bandwidth. This kernel
    gathers the candidate rows into a fixed [cap, K] buffer on device and
    returns ONE int32 array [cap + 1, K + 1]:

      row r < cap:  [candidate locus row (-1 = unused), counts[k]...]
      row cap:      [total candidate count, 0...]   (overflow detector)

    When total > cap the host falls back to the full tile_stats_csr fetch
    (rare: candidates are a small superset of emitted calls).
    """
    assert max_alleles <= 15, "nibble packing reserves 0xF for empty slots"
    counts, candidates = csr_screen_math(
        packed, row_off, is_variant, max_alleles, threshold_percent
    )
    idx = jnp.nonzero(candidates, size=cap, fill_value=-1)[0]  # [cap]
    cand_counts = counts[jnp.maximum(idx, 0)]  # [cap, K]
    cand_counts = jnp.where(idx[:, None] >= 0, cand_counts, 0)
    body = jnp.concatenate(
        [idx[:, None].astype(jnp.int32), cand_counts], axis=1
    )  # [cap, K+1]
    total = jnp.sum(candidates, dtype=jnp.int32)
    footer = jnp.zeros((1, max_alleles + 1), jnp.int32).at[0, 0].set(total)
    return jnp.concatenate([body, footer], axis=0)


def _screen_from_allele_sums(
    c: jnp.ndarray,  # [L, K] per-allele sum of m=0 log terms
    g: jnp.ndarray,  # [L, K] per-allele sum of m=2 log terms
    is_variant: jnp.ndarray,  # [L, K] bool
    is_standard_alt: jnp.ndarray,  # [L, K] bool
    max_alleles: int,
    margin: float,
    min_phred: float = 0.0,
) -> jnp.ndarray:
    """Shared tail of the likelihood screens: pair scores from per-allele
    sums (score(i,j) = -c_i - c_j for i != j, score(i,i) = -c_i + g_i;
    the common all-elements term is dropped — it cancels from the
    comparison), then flag loci where the best variant genotype comes
    within `margin` of the best reference genotype.

    Genotypes enumerate only standard-alt alleles (parity with
    possible_genotypes_of_pileup / Likelihood.scala:106); table entries
    beyond num_alleles carry False flags, so this also bounds the pairs.

    min_phred > 0 additionally drops candidates whose best-genotype
    NORMALIZED probability cannot reach that phred score (the
    min-likelihood emission gate, GenotypeFilter.scala:135; the f64 host
    form lives in guac_pack.cpp). The genotype set equals the exact
    confirm's enumeration, so p here bounds the exact p. Cancellation
    control: 1 - p computes as runner_sum / total (never as 1 - p), so
    its f32 relative error stays ~1%, i.e. <0.1 phred; a 2-phred safety
    band (vs the native f64 form's 1) makes the drop a strict superset
    filter (pinned by tests/test_screen_kernels.py and tests/test_fuzz.py).
    """
    i_idx, j_idx = genotype_pairs(max_alleles)
    i_idx = jnp.asarray(i_idx)
    j_idx = jnp.asarray(j_idx)
    het = (i_idx != j_idx).astype(jnp.float32)
    # i == j: -c_i + g_i; i != j: -c_i - c_j.
    score = -c[:, i_idx] + jnp.where(
        het > 0, -c[:, j_idx], g[:, i_idx]
    )  # [L, P]
    pair_exists = is_standard_alt[:, i_idx] & is_standard_alt[:, j_idx]
    pair_variant = is_variant[:, i_idx] | is_variant[:, j_idx]
    neg_inf = jnp.float32(-jnp.inf)
    best_variant = jnp.max(
        jnp.where(pair_exists & pair_variant, score, neg_inf), axis=1
    )
    best_ref = jnp.max(
        jnp.where(pair_exists & ~pair_variant, score, neg_inf), axis=1
    )
    # Rows with no standard variant allele can never emit; the guard also
    # keeps every implementation identical when all scores are -inf
    # (IEEE -inf >= -inf is true — see the native form's same guard).
    has_var = jnp.any(pair_exists & pair_variant, axis=1)
    cand = has_var & (best_variant >= best_ref - margin)
    if min_phred > 0:
        smax = jnp.maximum(best_variant, best_ref)  # [L]
        rel = jnp.where(
            pair_exists, score - smax[:, None], neg_inf
        )
        terms = jnp.exp(rel)  # max pair contributes exactly 1
        total = jnp.sum(terms, axis=1)
        runner = total - 1.0  # sum over non-best pairs, no cancellation
        one_minus = jnp.maximum(runner, 0.0) / jnp.maximum(
            total, 1.0
        ) + 1e-10  # the reference's phred epsilon, AlleleEvidence.scala:52
        gq = -10.0 * jnp.log10(one_minus)
        keep = ~jnp.isfinite(smax) | (gq >= min_phred - 2.0)
        cand = cand & keep
    return cand


def germline_screen_math(
    ll_pack: jnp.ndarray,  # [L, D] uint16: allele_id | qual << 4
    is_variant: jnp.ndarray,  # [L, K] bool
    is_standard_alt: jnp.ndarray,  # [L, K] bool (genotype-eligible alleles)
    max_alleles: int,
    margin: float = 0.5,
    min_phred: float = 0.0,
) -> jnp.ndarray:
    """Candidate loci for the Bayesian germline caller: [L] bool.

    The un-jitted math shared by the single-device screen
    (germline_likelihood_screen) and the shard_map'd mesh screen
    (parallel/mesh.py) — ONE source of truth for the semantics.

    Computes all K(K+1)/2 diploid genotype log-likelihoods in f32
    (identical math to the exact host model, likelihood.py: per element
    log(p(a1,e) + p(a2,e)) with p = 1 - 10^(-q/10) on match else its
    complement; the -depth*log2 and normalization terms are argmax-
    invariant and omitted) and flags loci where the best variant genotype
    comes within `margin` of the best reference genotype. With f32 row
    error far below margin, the flag set is a strict superset of loci
    whose exact f64 argmax genotype is variant — the host re-evaluates
    candidates exactly, so screening never changes results.

    Numerical form: for an element with allele a and error probability
    err = 10^(-q/10), p_i + p_j = m + (2 - 2m)*err where m = [i==a]+[j==a]
    (0, 1, or 2) — no catastrophic cancellation even at q>=70 where f32
    rounds 1-err to 1. Because the m=1 term is log(1) = exactly 0, each
    pair's log-likelihood FACTORS into per-allele sums:

        ll(i,j) = T - C_i - C_j   (i != j)
        ll(i,i) = T - C_i + G_i

    with T = sum over all elements of log(2*err), C_k = that sum over
    elements whose allele is k, and G_k = sum over those elements of
    log(2-2*err). T is common to every pair and cancels from the
    variant-vs-reference argmax comparison, so the kernel computes only
    C and G (2 logs + K masked row-sums per element) instead of a
    [L, D, P] term tensor — P/2 = ~18x less transcendental work, and
    smaller partial-sum magnitudes (f32 rounding error well under the
    screen margin even at the LIKELIHOOD_DEPTH_CAP row depth).
    """
    aid = (ll_pack & jnp.uint16(0xF)).astype(jnp.uint8)  # 0xF when empty
    q = (ll_pack >> jnp.uint16(4)).astype(jnp.float32)
    valid = ll_pack != jnp.uint16(0xFFFF)
    err = jnp.power(10.0, q / -10.0)
    x = jnp.log(2.0 * err)  # m=0 term (finite: q is capped, err > 0)
    y = jnp.log(2.0 - 2.0 * err)  # m=2 term (-inf only at q == 0)
    k_range = jnp.arange(max_alleles, dtype=jnp.uint8)
    hit = (aid[:, :, None] == k_range) & valid[:, :, None]  # [L, D, K]
    c = jnp.sum(jnp.where(hit, x[:, :, None], 0.0), axis=1)  # [L, K]
    g = jnp.sum(jnp.where(hit, y[:, :, None], 0.0), axis=1)  # [L, K]
    return _screen_from_allele_sums(
        c, g, is_variant, is_standard_alt, max_alleles, margin,
        min_phred=min_phred,
    ) & jnp.any(valid, axis=1)


germline_likelihood_screen = functools.partial(
    jax.jit, static_argnames=("max_alleles", "margin", "min_phred")
)(germline_screen_math)


def germline_screen_math8(
    ll_pack8: jnp.ndarray,  # [L, D] uint8: allele_id | qual_index << 4
    ll_qvals: jnp.ndarray,  # [Q <= 16] uint8 phred values
    is_variant: jnp.ndarray,  # [L, K] bool
    is_standard_alt: jnp.ndarray,  # [L, K] bool
    max_alleles: int,
    margin: float = 0.5,
    min_phred: float = 0.0,
) -> jnp.ndarray:
    """germline_screen_math over the qual-dictionary byte encoding
    (PackedTile::ll_pack8): HALF the H2D / HBM-read volume. The per-qual
    log terms pretabulate over the <= 16 dictionary values — the same
    f32 values the uint16 form computes per element, so the candidate
    flags are bit-identical (pinned by tests/test_screen_kernels.py)."""
    aid = (ll_pack8 & jnp.uint8(0xF)).astype(jnp.uint8)
    qidx = (ll_pack8 >> jnp.uint8(4)).astype(jnp.int32)
    valid = ll_pack8 != jnp.uint8(0xFF)
    qtab = ll_qvals.astype(jnp.float32)  # [Q]
    err_tab = jnp.power(10.0, qtab / -10.0)
    x_tab = jnp.log(2.0 * err_tab)
    y_tab = jnp.log(2.0 - 2.0 * err_tab)
    # Pad the tables to 16 so the empty-slot index (0xF) is in range
    # (its rows are masked by `valid` anyway).
    pad = 16 - x_tab.shape[0]
    if pad > 0:
        x_tab = jnp.concatenate([x_tab, jnp.zeros(pad, jnp.float32)])
        y_tab = jnp.concatenate([y_tab, jnp.zeros(pad, jnp.float32)])
    x = x_tab[qidx]
    y = y_tab[qidx]
    k_range = jnp.arange(max_alleles, dtype=jnp.uint8)
    hit = (aid[:, :, None] == k_range) & valid[:, :, None]  # [L, D, K]
    c = jnp.sum(jnp.where(hit, x[:, :, None], 0.0), axis=1)  # [L, K]
    g = jnp.sum(jnp.where(hit, y[:, :, None], 0.0), axis=1)  # [L, K]
    return _screen_from_allele_sums(
        c, g, is_variant, is_standard_alt, max_alleles, margin,
        min_phred=min_phred,
    ) & jnp.any(valid, axis=1)


germline_likelihood_screen8 = functools.partial(
    jax.jit, static_argnames=("max_alleles", "margin", "min_phred")
)(germline_screen_math8)


def tumor_screen_math(
    ll_pack: jnp.ndarray,  # [L, D] uint16: allele_id | qual << 4
    ll_mapq: jnp.ndarray,  # [L, D] uint8 per-element read MAPQ
    is_variant: jnp.ndarray,  # [L, K] bool
    is_standard_alt: jnp.ndarray,  # [L, K] bool
    max_alleles: int,
    margin: float = 0.5,
) -> jnp.ndarray:
    """Somatic tumor candidate screen: [L] bool. Un-jitted shared math
    (see germline_screen_math).

    Same construction as germline_likelihood_screen but with
    alignment-included correctness (pc = (1-err_q)(1-err_m), cf.
    probability_correct_including_alignment): a locus can emit a somatic
    call only if the tumor's argmax genotype (alignment included) has a
    variant allele — every other gate in the somatic kernel (odds ratio,
    depth bounds, normal evidence) only removes emissions, so this flag
    set is a superset of emitted loci.

    Uses the same factored form as germline_likelihood_screen: with
    m*pc + (2-m)*(1-pc) equal to exactly 1 at m=1, ll(i,j) decomposes
    into per-allele sums of log(2*(1-pc)) (m=0) and log(2*pc) (m=2),
    and the all-elements term cancels from the argmax comparison.
    """
    aid = (ll_pack & jnp.uint16(0xF)).astype(jnp.uint8)
    q = (ll_pack >> jnp.uint16(4)).astype(jnp.float32)
    valid = ll_pack != jnp.uint16(0xFFFF)
    err_q = jnp.power(10.0, q / -10.0)
    err_m = jnp.power(10.0, ll_mapq.astype(jnp.float32) / -10.0)
    pc = (1.0 - err_q) * (1.0 - err_m)
    one_minus_pc = err_q + err_m - err_q * err_m  # stable complement
    x = jnp.log(2.0 * one_minus_pc)  # m=0 term (finite: err_q > 0)
    y = jnp.log(2.0 * pc)  # m=2 term (-inf only at q == 0 in f32)
    k_range = jnp.arange(max_alleles, dtype=jnp.uint8)
    hit = (aid[:, :, None] == k_range) & valid[:, :, None]  # [L, D, K]
    c = jnp.sum(jnp.where(hit, x[:, :, None], 0.0), axis=1)  # [L, K]
    g = jnp.sum(jnp.where(hit, y[:, :, None], 0.0), axis=1)  # [L, K]
    return _screen_from_allele_sums(
        c, g, is_variant, is_standard_alt, max_alleles, margin
    ) & jnp.any(valid, axis=1)


tumor_likelihood_screen = functools.partial(
    jax.jit, static_argnames=("max_alleles", "margin")
)(tumor_screen_math)


def tumor_screen_math8(
    ll_pack8: jnp.ndarray,  # [L, D] uint8: allele_id | qual_index << 4
    ll_qvals: jnp.ndarray,  # [Q <= 16] uint8 phred values
    ll_mapq: jnp.ndarray,  # [L, D] uint8 per-element read MAPQ
    is_variant: jnp.ndarray,
    is_standard_alt: jnp.ndarray,
    max_alleles: int,
    margin: float = 0.5,
) -> jnp.ndarray:
    """tumor_screen_math over the qual-dictionary byte encoding: the
    base-qual error comes from the <= 16-entry table (identical f32
    values -> bit-identical flags); the per-element MAPQ plane is
    unchanged."""
    aid = (ll_pack8 & jnp.uint8(0xF)).astype(jnp.uint8)
    qidx = (ll_pack8 >> jnp.uint8(4)).astype(jnp.int32)
    valid = ll_pack8 != jnp.uint8(0xFF)
    err_tab = jnp.power(10.0, ll_qvals.astype(jnp.float32) / -10.0)
    pad = 16 - err_tab.shape[0]
    if pad > 0:
        err_tab = jnp.concatenate([err_tab, jnp.zeros(pad, jnp.float32)])
    err_q = err_tab[qidx]
    err_m = jnp.power(10.0, ll_mapq.astype(jnp.float32) / -10.0)
    pc = (1.0 - err_q) * (1.0 - err_m)
    one_minus_pc = err_q + err_m - err_q * err_m  # stable complement
    x = jnp.log(2.0 * one_minus_pc)
    y = jnp.log(2.0 * pc)
    k_range = jnp.arange(max_alleles, dtype=jnp.uint8)
    hit = (aid[:, :, None] == k_range) & valid[:, :, None]
    c = jnp.sum(jnp.where(hit, x[:, :, None], 0.0), axis=1)
    g = jnp.sum(jnp.where(hit, y[:, :, None], 0.0), axis=1)
    return _screen_from_allele_sums(
        c, g, is_variant, is_standard_alt, max_alleles, margin
    ) & jnp.any(valid, axis=1)


tumor_likelihood_screen8 = functools.partial(
    jax.jit, static_argnames=("max_alleles", "margin")
)(tumor_screen_math8)


class TileStats(NamedTuple):
    counts: jnp.ndarray  # [L, K] allele counts
    forward_counts: jnp.ndarray  # [L, K]
    depth: jnp.ndarray  # [L] valid-slot depth
    forward_depth: jnp.ndarray  # [L]
    variant_evidence: jnp.ndarray  # [L] bool: any variant-allele element


@functools.partial(
    jax.jit, static_argnames=("max_alleles", "threshold_percent")
)
def tile_stats(
    allele_id: jnp.ndarray,
    strand: jnp.ndarray,
    valid: jnp.ndarray,
    is_variant: jnp.ndarray,  # [L, K] bool
    max_alleles: int,
    threshold_percent=None,
) -> TileStats:
    """Fused counting + candidate screening for one tile.

    Without a threshold, a locus is a candidate if any variant allele has
    evidence. With threshold_percent, the screen applies the exact
    germline-threshold passing rule (count * 100 // depth > threshold,
    rewritten division-free as count * 100 >= depth * (threshold + 1) for
    positive counts): candidates are loci where a variant allele passes —
    or where two reference alleles pass (the mixed-N corner that
    classify_locus must still see, GermlineThresholdCaller.scala:155-175).
    """
    counts, fwd = allele_counts(allele_id, strand, valid, max_alleles)
    depth = jnp.sum(valid, axis=1, dtype=jnp.int32)
    forward_depth = jnp.sum(valid & strand, axis=1, dtype=jnp.int32)
    variant_evidence = counts_candidates(
        counts, depth, is_variant, threshold_percent
    )
    return TileStats(counts, fwd, depth, forward_depth, variant_evidence)
