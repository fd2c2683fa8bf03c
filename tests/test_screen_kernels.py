"""Device screen kernels: the XLA counting and likelihood screens against
their references, and the dispatch layer's wire formats, slabbing and
choice of path."""

import numpy as np
import pytest

from guacamole.ops.dispatch import pack_flag_words
from guacamole.ops.kernels import tile_stats


def random_tile(L=64, D=16, K=8, seed=0):
    rng = np.random.RandomState(seed)
    depth = rng.randint(0, D + 1, size=L)
    valid = np.arange(D)[None, :] < depth[:, None]
    allele_id = np.where(
        valid, rng.randint(0, K, size=(L, D)), -1
    ).astype(np.int16)
    qual = np.where(valid, rng.randint(2, 45, size=(L, D)), 0).astype(np.int16)
    mapq = np.where(valid, rng.randint(0, 70, size=(L, D)), 0).astype(np.int16)
    strand = valid & (rng.rand(L, D) < 0.5)
    is_variant = rng.rand(L, K) < 0.4
    return allele_id, qual, mapq, strand, valid, is_variant


@pytest.mark.parametrize("threshold_percent", [None, 0, 8, 50])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("D", [16, 15])  # even and odd depth axes
def test_nibble_screen_matches_reference(seed, threshold_percent, D):
    from guacamole.ops.dispatch import pack_nibbles
    from guacamole.ops.kernels import tile_stats_nibble

    K = 8
    aid, _qual, _mapq, strand, valid, is_variant = random_tile(
        L=64, D=D, K=K, seed=seed
    )
    packed = pack_nibbles(aid, valid)
    assert packed.dtype == np.uint8
    assert packed.shape == (64, (D + 1) // 2)
    out = tile_stats_nibble(
        packed, is_variant, K, threshold_percent=threshold_percent
    )
    ref = tile_stats(
        aid, strand, valid, is_variant, K,
        threshold_percent=threshold_percent,
    )
    np.testing.assert_array_equal(out.counts, ref.counts)
    np.testing.assert_array_equal(out.candidates, ref.variant_evidence)


def test_nibble_screen_masks_extra_valid():
    # valid_of-style masks (e.g. MAPQ filters) shrink validity after the
    # tile is packed: masked slots must vanish from counts and depth.
    from guacamole.ops.dispatch import pack_nibbles
    from guacamole.ops.kernels import tile_stats_nibble

    K = 8
    aid, _q, mapq, strand, valid, is_variant = random_tile(
        L=32, D=16, K=K, seed=7
    )
    masked = valid & (mapq >= 30)
    out = tile_stats_nibble(pack_nibbles(aid, masked), is_variant, K)
    ref = tile_stats(aid, strand, masked, is_variant, K)
    np.testing.assert_array_equal(out.counts, ref.counts)
    np.testing.assert_array_equal(out.candidates, ref.variant_evidence)


def _csr_encode(aid, valid, depth):
    """Reference CSR nibble encoding: row r's slots [0, depth[r]) as 4-bit
    ids (0xF where invalid), byte-aligned per row."""
    blobs, off = [], [0]
    for r in range(aid.shape[0]):
        nibs = [
            (int(aid[r, s]) & 0xF) if valid[r, s] else 0xF
            for s in range(int(depth[r]))
        ]
        if len(nibs) % 2:
            nibs.append(0xF)
        blobs.extend(nibs[i] | (nibs[i + 1] << 4) for i in range(0, len(nibs), 2))
        off.append(len(blobs))
    return (
        np.asarray(blobs, dtype=np.uint8),
        np.asarray(off, dtype=np.int32),
    )


@pytest.mark.parametrize("threshold_percent", [None, 8, 50])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_csr_screen_matches_dense(seed, threshold_percent):
    from guacamole.ops.kernels import tile_stats_csr

    K = 8
    aid, _q, _m, strand, valid, is_variant = random_tile(
        L=64, D=17, K=K, seed=seed
    )
    # Invalidate a few mid-row slots (beyond-allele-cap analog): CSR keeps
    # them as 0xF nibbles, dense masks them via valid.
    rng = np.random.RandomState(seed + 100)
    depth = valid.sum(axis=1)
    punch = (rng.rand(*valid.shape) < 0.1) & (
        np.arange(valid.shape[1])[None, :] < depth[:, None]
    )
    masked = valid & ~punch
    packed, row_off = _csr_encode(aid, masked, depth)
    out = tile_stats_csr(
        packed, row_off, is_variant, K, threshold_percent=threshold_percent
    )
    ref = tile_stats(
        aid, strand, masked, is_variant, K,
        threshold_percent=threshold_percent,
    )
    np.testing.assert_array_equal(out.counts, ref.counts)
    np.testing.assert_array_equal(out.candidates, ref.variant_evidence)


@pytest.mark.parametrize("threshold_percent", [None, 8])
@pytest.mark.parametrize("cap", [4, 64])
def test_csr_compact_matches_full(threshold_percent, cap):
    """The compact CSR screen's candidate rows/counts must equal the full
    screen's, and its footer total must be the true candidate count (so
    cap overflow is always detectable)."""
    from guacamole.ops.kernels import tile_stats_csr, tile_stats_csr_compact

    K = 8
    aid, _q, _m, _s, valid, is_variant = random_tile(L=64, D=17, K=K, seed=3)
    depth = valid.sum(axis=1)
    packed, row_off = _csr_encode(aid, valid, depth)
    full = tile_stats_csr(
        packed, row_off, is_variant, K, threshold_percent=threshold_percent
    )
    raw = np.asarray(
        tile_stats_csr_compact(
            packed, row_off, is_variant, K,
            threshold_percent=threshold_percent, cap=cap,
        )
    )
    cand_rows = np.nonzero(np.asarray(full.candidates))[0]
    total = int(raw[-1, 0])
    assert total == len(cand_rows)
    n = min(total, cap)
    np.testing.assert_array_equal(raw[:n, 0], cand_rows[:n])
    np.testing.assert_array_equal(
        raw[:n, 1:], np.asarray(full.counts)[cand_rows[:n]]
    )
    # Unused body rows are inert: idx -1, zero counts.
    assert (raw[n:cap, 0] == -1).all()
    assert (raw[n:cap, 1:] == 0).all()


def test_compact_launch_roundtrip_and_overflow_flag():
    from guacamole.ops.dispatch import screen_csr_compact_launch
    from guacamole.ops.kernels import tile_stats_csr

    K = 8
    aid, _q, _m, _s, valid, is_variant = random_tile(L=48, D=12, K=K, seed=9)
    depth = valid.sum(axis=1)
    packed, row_off = _csr_encode(aid, valid, depth)
    full = tile_stats_csr(packed, row_off, is_variant, K)
    n_cand = int(np.asarray(full.candidates).sum())
    assert n_cand > 2  # random tiles have variant evidence

    roomy = screen_csr_compact_launch(
        packed, row_off, is_variant, K, cap=n_cand + 8
    ).result()
    assert not roomy.overflowed and roomy.total == n_cand
    np.testing.assert_array_equal(
        roomy.idx, np.nonzero(np.asarray(full.candidates))[0]
    )
    np.testing.assert_array_equal(
        roomy.counts, np.asarray(full.counts)[roomy.idx]
    )

    tight = screen_csr_compact_launch(
        packed, row_off, is_variant, K, cap=n_cand - 1
    ).result()
    assert tight.overflowed and tight.total == n_cand


def test_csr_screen_bucket_padding_is_inert():
    from guacamole.ops.dispatch import screen_csr_launch
    from guacamole.ops.kernels import tile_stats_csr

    K = 8
    aid, _q, _m, strand, valid, is_variant = random_tile(
        L=32, D=16, K=K, seed=5
    )
    depth = valid.sum(axis=1)
    packed, row_off = _csr_encode(aid, valid, depth)
    direct = tile_stats_csr(packed, row_off, is_variant, K)
    bucketed = screen_csr_launch(packed, row_off, is_variant, K).result()
    np.testing.assert_array_equal(direct.counts, bucketed.counts)
    np.testing.assert_array_equal(direct.candidates, bucketed.candidates)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("include_alignment", [False, True])
def test_likelihood_screen_superset_of_f64_argmax(seed, include_alignment):
    """The f32 device likelihood screens must flag every locus whose exact
    f64 argmax genotype is variant — across extreme quals (0..93) where
    f32's 1-err rounds to 1."""
    from guacamole.ops.kernels import (
        genotype_pairs,
        germline_likelihood_screen,
        tumor_likelihood_screen,
    )

    rng = np.random.RandomState(seed)
    L, D, K = 48, 24, 8
    depth = rng.randint(1, D + 1, size=L)
    valid = np.arange(D)[None, :] < depth[:, None]
    aid = np.where(valid, rng.randint(0, 4, size=(L, D)), -1)
    qual = np.where(valid, rng.choice([0, 2, 20, 41, 70, 93], size=(L, D)), 0)
    mapq = np.where(valid, rng.choice([0, 10, 37, 60, 254], size=(L, D)), 0)
    is_variant = np.zeros((L, K), dtype=bool)
    is_variant[:, 1:4] = True
    is_standard = np.zeros((L, K), dtype=bool)
    is_standard[:, :4] = True

    ll_pack = np.where(
        valid, (aid & 0xF) | (qual.astype(np.uint16) << 4), 0xFFFF
    ).astype(np.uint16)
    if include_alignment:
        gots = {
            "tumor": np.asarray(
                tumor_likelihood_screen(
                    ll_pack, mapq.astype(np.uint8), is_variant, is_standard, K
                )
            )
        }
    else:
        gots = {
            "germline": np.asarray(
                germline_likelihood_screen(ll_pack, is_variant, is_standard, K)
            ),
        }

    # f64 oracle: argmax over pairs of the exact per-element log terms.
    i_idx, j_idx = genotype_pairs(K)
    for li in range(L):
        lls = {}
        for p, (i, j) in enumerate(zip(i_idx, j_idx)):
            if not (is_standard[li, i] and is_standard[li, j]):
                continue
            acc = 0.0
            for s in range(int(depth[li])):
                err = 10.0 ** (qual[li, s] / -10.0)
                pc = 1.0 - err
                if include_alignment:
                    pc *= 1.0 - 10.0 ** (mapq[li, s] / -10.0)
                pi = pc if aid[li, s] == i else 1.0 - pc
                pj = pc if aid[li, s] == j else 1.0 - pc
                acc += np.log(pi + pj) if pi + pj > 0 else -np.inf
            lls[p] = acc
        if not lls:
            continue
        best = max(lls, key=lambda p: lls[p])
        argmax_variant = bool(
            is_variant[li, i_idx[best]] or is_variant[li, j_idx[best]]
        )
        if argmax_variant:
            for form, got in gots.items():
                assert got[li], (
                    f"{form} screen missed f64-argmax-variant locus {li}"
                )


def _ll_fixture(seed, L=64, D=24, K=8):
    rng = np.random.RandomState(seed)
    depth = rng.randint(0, D + 1, size=L)
    valid = np.arange(D)[None, :] < depth[:, None]
    aid = np.where(valid, rng.randint(0, 4, size=(L, D)), -1)
    qual = np.where(valid, rng.choice([0, 2, 20, 41, 70, 93], size=(L, D)), 0)
    mapq = np.where(valid, rng.choice([0, 10, 37, 60, 254], size=(L, D)), 0)
    is_variant = np.zeros((L, K), bool)
    is_variant[:, 1:4] = True
    is_standard = np.zeros((L, K), bool)
    is_standard[:, :4] = True
    ll_pack = np.where(
        valid, (aid & 0xF) | (qual.astype(np.uint16) << 4), 0xFFFF
    ).astype(np.uint16)
    return ll_pack, mapq.astype(np.uint8), is_variant, is_standard


class TestPrefetchIter:
    """prefetch_iter: background-thread tile production semantics."""

    def test_order_and_completeness(self):
        from guacamole.ops.dispatch import prefetch_iter

        assert list(prefetch_iter(iter(range(100)), ahead=3)) == list(range(100))
        assert list(prefetch_iter([], ahead=2)) == []

    def test_producer_exception_reraises(self):
        import pytest

        from guacamole.ops.dispatch import prefetch_iter

        def gen():
            yield 1
            yield 2
            raise ValueError("boom")

        it = prefetch_iter(gen(), ahead=1)
        assert next(it) == 1
        assert next(it) == 2
        with pytest.raises(ValueError, match="boom"):
            next(it)

    def test_abandoned_consumer_stops_producer(self):
        import threading
        import time

        from guacamole.ops.dispatch import prefetch_iter

        produced = []

        def gen():
            for i in range(10_000):
                produced.append(i)
                yield i

        it = prefetch_iter(gen(), ahead=1)
        assert next(it) == 0
        it.close()  # abandon: the producer must notice and exit
        deadline = time.time() + 5
        while time.time() < deadline:
            threads = [
                t for t in threading.enumerate() if t.name == "guac-prefetch"
            ]
            if not threads:
                break
            time.sleep(0.05)
        # Bounded production: at most the buffered window, never the
        # whole generator.
        assert len(produced) < 100


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("min_phred", [10.0, 40.0])
def test_screen_min_phred_gate_parity_and_superset(seed, min_phred):
    """The device screens' min-likelihood (GQ) gate: the gated mask is a subset of the
    ungated one, and it keeps every locus whose EXACT f64 normalized
    argmax probability passes the filter (the safe-drop contract; the
    native f64 twin lives in guac_pack.cpp)."""
    import math

    from guacamole.ops.kernels import (
        genotype_pairs,
        germline_likelihood_screen,
    )
    K = 8
    ll_pack, _mapq, is_variant, is_standard = _ll_fixture(seed, K=K)
    ungated = np.asarray(
        germline_likelihood_screen(ll_pack, is_variant, is_standard, K)
    )
    gated = np.asarray(
        germline_likelihood_screen(
            ll_pack, is_variant, is_standard, K, min_phred=min_phred
        )
    )
    assert not np.any(gated & ~ungated)  # gate only removes

    # Exact f64 oracle: best normalized probability per locus; any locus
    # whose emission would pass the phred filter must stay flagged.
    i_idx, j_idx = genotype_pairs(K)
    L, D = ll_pack.shape
    for li in range(L):
        row = ll_pack[li]
        valid = row != 0xFFFF
        if not valid.any() or not ungated[li]:
            continue
        aid = (row & 0xF).astype(int)
        q = (row >> 4).astype(float)
        err = 10.0 ** (q / -10.0)
        scores = []
        variant_best = None
        for p in range(len(i_idx)):
            i, j = int(i_idx[p]), int(j_idx[p])
            if not (is_standard[li, i] and is_standard[li, j]):
                continue
            s = 0.0
            for d in range(D):
                if not valid[d]:
                    continue
                m = int(aid[d] == i) + int(aid[d] == j)
                term = m + (2 - 2 * m) * err[d]
                s += math.log(term) if term > 0 else -math.inf
            scores.append((s, is_variant[li, i] or is_variant[li, j]))
        if not scores:
            continue
        smax = max(s for s, _ in scores)
        best_is_variant = any(
            v for s, v in scores if s == smax
        )
        if not (best_is_variant and math.isfinite(smax)):
            continue
        total = sum(math.exp(s - smax) for s, _ in scores)
        p_best = 1.0 / total
        one_minus = 1.0 - (p_best - 1e-10)
        gq = (
            math.inf if one_minus <= 0 else -10.0 * math.log10(one_minus)
        )
        if round(gq) >= min_phred:
            assert gated[li], (
                f"seed={seed} locus {li}: exact GQ {gq:.1f} passes the "
                f"phred-{min_phred} filter but the gate dropped it"
            )


@pytest.mark.parametrize("include_alignment", [False, True])
@pytest.mark.parametrize("min_phred", [0.0, 40.0])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_qual_dictionary_screen_equals_uint16(
    seed, include_alignment, min_phred
):
    """The uint8 qual-dictionary screen forms (germline/tumor) must produce the SAME candidate flags as the uint16 forms —
    the tables hold the same f32 qual values the wide form computes per
    element — at half the transfer bytes."""
    from guacamole.ops.kernels import (
        germline_likelihood_screen,
        germline_likelihood_screen8,
        tumor_likelihood_screen,
        tumor_likelihood_screen8,
    )
    if include_alignment and min_phred > 0:
        pytest.skip("the GQ gate is a germline-only emission bound")
    K = 8
    ll_pack, mapq, is_variant, is_standard = _ll_fixture(seed, K=K)
    # Build the byte form from the wide form: dictionary of the distinct
    # qual values, index in the high nibble.
    quals = np.unique((ll_pack >> 4)[ll_pack != 0xFFFF])
    assert len(quals) <= 16
    idx_of = {int(q): i for i, q in enumerate(quals)}
    lut = np.zeros(4096, np.uint8)
    for q, i in idx_of.items():
        lut[q] = i
    pack8 = np.where(
        ll_pack == 0xFFFF,
        np.uint8(0xFF),
        ((ll_pack & 0xF) | (lut[ll_pack >> 4].astype(np.uint16) << 4)).astype(
            np.uint8
        ),
    ).astype(np.uint8)
    qvals = quals.astype(np.uint8)

    if include_alignment:
        want = np.asarray(
            tumor_likelihood_screen(ll_pack, mapq, is_variant, is_standard, K)
        )
        got8 = np.asarray(
            tumor_likelihood_screen8(
                pack8, qvals, mapq, is_variant, is_standard, K
            )
        )
    else:
        want = np.asarray(
            germline_likelihood_screen(
                ll_pack, is_variant, is_standard, K, min_phred=min_phred
            )
        )
        got8 = np.asarray(
            germline_likelihood_screen8(
                pack8, qvals, is_variant, is_standard, K,
                min_phred=min_phred,
            )
        )
    np.testing.assert_array_equal(got8, want)


def test_native_ll_pack8_roundtrip(resources_dir):
    """The native packer's qual-dictionary transcode: pack8/qvals decode
    to exactly the uint16 encoding (same validity, allele ids, quals) and
    the dispatch launch path produces the same candidates."""
    from guacamole.ops.dispatch import germline_screen_launch
    from guacamole.pack.columnar import pack_tile_columnar
    from guacamole.runtime.columnar import (
        decode_bam_columnar,
        native_available,
    )

    if not native_available():
        pytest.skip("native runtime not built")
    from conftest import resource_path

    # The chrM fixture carries 32 distinct quals -> falls back (no pack8).
    cols = decode_bam_columnar(resource_path("chrM.sorted.bam"))
    mc = cols.select(cols.is_mapped_mask)
    cid = mc.ref_names.index("chrM")
    wide = pack_tile_columnar(
        mc, cid, "chrM", list(range(0, 1024)), fields="likelihood",
        min_mapq=1,
    )
    assert wide.ll_pack8 is None  # 32 distinct quals: no dictionary

    # A quantized copy (quals binned to 8 levels, like modern basecallers)
    # must transcode.
    import dataclasses

    binned = mc.select(np.ones(mc.n, bool))
    binned.ev_qual[:] = (binned.ev_qual // 16) * 16
    t = pack_tile_columnar(
        binned, cid, "chrM", list(range(0, 1024)), fields="likelihood",
        min_mapq=1,
    )
    assert t.ll_pack8 is not None and t.ll_qvals is not None
    assert len(t.ll_qvals) <= 16
    p16, p8 = np.asarray(t.ll_pack), np.asarray(t.ll_pack8)
    valid = p16 != 0xFFFF
    np.testing.assert_array_equal(valid, p8 != 0xFF)
    np.testing.assert_array_equal(
        (p16 & 0xF)[valid], (p8 & 0xF)[valid]
    )
    np.testing.assert_array_equal(
        (p16 >> 4)[valid], t.ll_qvals[(p8 >> 4)[valid]]
    )
    # Launch path equality: pack8 launch == forced-wide launch.
    got = germline_screen_launch(t, min_mapq=1).result()
    wide_only = dataclasses.replace(t, ll_pack8=None, ll_qvals=None)
    want = germline_screen_launch(wide_only, min_mapq=1).result()
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _to_qual_dictionary(ll_pack):
    """The uint8 qual-dictionary form of a uint16 ll_pack: (pack8, qvals)."""
    quals = np.unique((ll_pack >> 4)[ll_pack != 0xFFFF])
    lut = np.zeros(4096, np.uint8)
    lut[quals] = np.arange(len(quals), dtype=np.uint8)
    pack8 = np.where(
        ll_pack == 0xFFFF,
        0xFF,
        (ll_pack & 0xF) | (lut[ll_pack >> 4].astype(np.uint16) << 4),
    ).astype(np.uint8)
    return pack8, quals.astype(np.uint8)


@pytest.mark.parametrize(
    "n, bucket", [(0, 2048), (2048, 2048), (2049, 2560), (3000, 3072),
                  (3585, 4096), (10_000, 10_240)],
)
def test_csr_blob_bucket_ladder(n, bucket):
    """CSR blobs pad to quarter-power-of-two steps from 2048 bytes: a small
    set of compiled shapes with at most 25% padding."""
    from guacamole.ops.dispatch import _bucket_bytes

    assert _bucket_bytes(n) == bucket
    assert n <= bucket <= max(2048, int(n * 1.25))


@pytest.mark.parametrize("K", [1, 8, 15])
def test_flag_words_roundtrip(K):
    """The 4-byte per-row flag words carry both [L, K] allele tables."""
    from guacamole.ops.dispatch import _unpack_flag_words

    rng = np.random.RandomState(K)
    iv, st = rng.rand(50, K) < 0.5, rng.rand(50, K) < 0.5
    words = pack_flag_words(iv, st)
    assert words.dtype == np.uint32 and words.shape == (50,)
    got_iv, got_st = _unpack_flag_words(words, K)
    np.testing.assert_array_equal(np.asarray(got_iv), iv)
    np.testing.assert_array_equal(np.asarray(got_st), st)


@pytest.mark.parametrize("K", [4, 15])
def test_csr_meta_wire_form_roundtrip(K):
    """uint16 per-row byte counts and variant masks rebuild the int32 row
    offsets and the [L, K] variant table on the device."""
    from guacamole.ops.dispatch import _unpack_csr_meta, pack_variant_words16

    rng = np.random.RandomState(K)
    nbytes = rng.randint(0, 500, size=64)
    iv = rng.rand(64, K) < 0.3
    row_off, got_iv = _unpack_csr_meta(
        nbytes.astype(np.uint16), pack_variant_words16(iv), K
    )
    np.testing.assert_array_equal(
        np.asarray(row_off), np.concatenate([[0], np.cumsum(nbytes)])
    )
    np.testing.assert_array_equal(np.asarray(got_iv), iv)


@pytest.mark.parametrize(
    "env, platform, on_host",
    [
        ("", "cpu", True),
        ("", "gpu", False),
        ("1", "gpu", True),
        ("0", "cpu", False),
        ("1", "cpu", True),
        ("0", "gpu", False),
    ],
)
def test_screen_on_host_by_platform_and_override(
    monkeypatch, env, platform, on_host
):
    """Host screens exactly when the default device is the CPU, unless
    GUAC_HOST_SCREEN pins either way."""
    from types import SimpleNamespace

    from guacamole.ops import dispatch

    monkeypatch.setattr(
        dispatch.jax, "devices", lambda *a: [SimpleNamespace(platform=platform)]
    )
    monkeypatch.setenv("GUAC_HOST_SCREEN", env)
    assert dispatch.screen_on_host() is on_host
    assert dispatch.pack_skip_nibbles() is on_host
    assert dispatch.pack_skip_nibbles(mesh=object()) is False


@pytest.mark.parametrize("slab_bytes", [1 << 7, 1 << 9, 1 << 11])
@pytest.mark.parametrize("threshold_percent", [None, 8])
def test_csr_slab_launches_equal_one_launch(
    monkeypatch, slab_bytes, threshold_percent
):
    """A blob split into row-aligned slabs (each padded to its bucket)
    screens to the same counts and candidates as one launch."""
    from guacamole.ops import dispatch

    K = 8
    aid, _q, _m, _s, valid, iv = random_tile(L=300, D=40, K=K, seed=12)
    packed, row_off = _csr_encode(aid, valid, valid.sum(axis=1))
    whole = dispatch.screen_csr_launch(
        packed, row_off, iv, K, threshold_percent=threshold_percent
    ).result()
    monkeypatch.setattr(dispatch, "CSR_SLAB_BYTES", slab_bytes)
    pending = dispatch.screen_csr_launch(
        packed, row_off, iv, K, threshold_percent=threshold_percent
    )
    assert len(pending._pendings) >= max(2, len(packed) // slab_bytes)
    slabbed = pending.result()
    np.testing.assert_array_equal(slabbed.counts, whole.counts)
    np.testing.assert_array_equal(slabbed.candidates, whole.candidates)


@pytest.mark.parametrize("tumor", [False, True])
@pytest.mark.parametrize("encoding", ["uint16", "qdict"])
def test_likelihood_slab_launches_equal_one_launch(monkeypatch, tumor, encoding):
    """Row slabs (the last padded with empty rows) flag what one launch
    flags."""
    from guacamole.ops import dispatch

    K = 8
    ll_pack, mapq, iv, st = _ll_fixture(3, L=700, D=24, K=K)
    pack, qvals = (
        (ll_pack, None) if encoding == "uint16" else _to_qual_dictionary(ll_pack)
    )
    mq = mapq if tumor else None
    whole = dispatch.ll_screen_arrays_launch(
        pack, mq, iv, st, K, ll_qvals=qvals
    ).result()
    monkeypatch.setattr(dispatch, "LL_SLAB_CELLS", 256 * 24)
    pending = dispatch.ll_screen_arrays_launch(
        pack, mq, iv, st, K, ll_qvals=qvals
    )
    assert len(pending._pendings) == 3
    np.testing.assert_array_equal(pending.result(), whole)
