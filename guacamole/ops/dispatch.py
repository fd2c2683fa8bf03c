"""Kernel dispatch: how each production screen reaches the device.

The screens ship compact encodings across the host->device link (CSR
nibble blobs for the counting screen, the uint16 ll_pack or uint8
qual-dictionary ll_pack8 for the likelihood screens), 4-16x fewer bytes
than full [L, D] tensors, and run the XLA kernels of ops/kernels.py on
them. screen_on_host() decides whether a run screens on the device at
all: on a CPU-only process the native packer's own screens are used.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import jax
import numpy as np


# Opt-in transfer accounting (GUAC_TRANSFER_STATS=1): every staged H2D
# payload and fetched D2H payload is counted with its wall time, so a
# run can report exactly what the link moved and how long it took. Off
# by default: staging is implicit in the jit call and costs nothing.
# "launches" counts every staged device screen launch either way.
TRANSFER_STATS = {
    "h2d_bytes": 0, "h2d_s": 0.0, "h2d_calls": 0,
    "d2h_bytes": 0, "d2h_s": 0.0, "d2h_calls": 0,
    "launches": 0,
}


def transfer_stats_enabled() -> bool:
    return os.environ.get("GUAC_TRANSFER_STATS", "") == "1"


def reset_transfer_stats() -> None:
    for k in TRANSFER_STATS:
        TRANSFER_STATS[k] = 0 if k.endswith(("bytes", "calls", "launches")) else 0.0


def _stage(*arrays):
    """device_put with accounting when GUAC_TRANSFER_STATS=1; otherwise a
    passthrough (the jit call stages implicitly)."""
    TRANSFER_STATS["launches"] += 1
    if not transfer_stats_enabled():
        return arrays
    import time as _time

    live = [a for a in arrays if a is not None]
    t0 = _time.perf_counter()
    staged = jax.device_put(live)
    jax.block_until_ready(staged)
    TRANSFER_STATS["h2d_s"] += _time.perf_counter() - t0
    TRANSFER_STATS["h2d_bytes"] += sum(int(a.nbytes) for a in live)
    TRANSFER_STATS["h2d_calls"] += 1
    it = iter(staged)
    return tuple(None if a is None else next(it) for a in arrays)


def copy_to_host_async(*arrays) -> None:
    """Queue the device->host copy of every device array among `arrays`,
    so a later fetch finds the data already in flight."""
    for arr in arrays:
        if isinstance(arr, jax.Array):
            arr.copy_to_host_async()


def fetch_arrays(*arrays):
    """Device->host transfer of several arrays: all copies start before
    the first one is waited on, so their latencies overlap."""
    copy_to_host_async(*arrays)
    if transfer_stats_enabled():
        import time as _time

        t0 = _time.perf_counter()
        out = tuple(
            np.asarray(arr) if arr is not None else None for arr in arrays
        )
        TRANSFER_STATS["d2h_s"] += _time.perf_counter() - t0
        TRANSFER_STATS["d2h_bytes"] += sum(
            int(a.nbytes)
            for a, src in zip(out, arrays)
            if a is not None and isinstance(src, jax.Array)
        )
        TRANSFER_STATS["d2h_calls"] += 1
        return out
    return tuple(
        np.asarray(arr) if arr is not None else None for arr in arrays
    )


class ScreenResult(NamedTuple):
    counts: np.ndarray  # [L, K]
    forward_counts: np.ndarray  # None on the packed fast path (unused)
    depth: np.ndarray  # [L]; None on the packed fast path (unused)
    candidates: np.ndarray  # [L] bool


def pack_nibbles(allele_id: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """[L, D] allele ids + validity -> [L, ceil(D/2)] uint8, two 4-bit ids
    per byte (0xF = empty). The minimal H2D encoding for the counting
    screen — 8x smaller than shipping int16 ids + bool masks."""
    aid = (np.where(valid, allele_id, -1) & 0xF).astype(np.uint8)
    if aid.shape[1] % 2:
        aid = np.concatenate(
            [aid, np.full((aid.shape[0], 1), 0xF, np.uint8)], axis=1
        )
    return aid[:, 0::2] | (aid[:, 1::2] << 4)


def tile_packed_nibbles(tile, valid=None) -> np.ndarray:
    """A tile's nibble-packed allele ids for the counting screen.

    With no extra validity mask, the native packer's precomputed encoding
    (tile.packed_nib) is used directly; otherwise (or when packed in
    Python) the ids are packed here."""
    if valid is None:
        pn = getattr(tile, "packed_nib", None)
        if pn is not None and pn.size:
            return pn
        valid = tile.valid
    if tile.allele_id is None:
        raise ValueError(
            "cannot apply a validity mask to a reduced (fields='screen'/"
            "'likelihood') tile: per-element tensors were not packed; "
            "pack with fields='full' or bake the filter in via min_mapq"
        )
    return pack_nibbles(np.asarray(tile.allele_id), np.asarray(valid))


class PendingScreen(NamedTuple):
    """Dispatched-but-unfetched screen kernel outputs (device arrays).

    JAX dispatch is asynchronous: callers can launch the kernels for many
    tiles, letting the device work and the host->device/device->host
    traffic overlap host-side packing/classification, then resolve each
    with result().
    """

    counts: object
    forward_counts: object
    depth: object
    candidates: object

    def result(self) -> ScreenResult:
        return ScreenResult(*fetch_arrays(*self))


def screen_tile_launch(
    allele_id, qual, mapq, strand, valid, is_variant, max_alleles: int,
    threshold_percent=None,
) -> PendingScreen:
    """Dispatch per-locus counts + variant-evidence screening for one tile
    without blocking on the device->host transfer."""
    if max_alleles <= 15:
        return screen_packed_launch(
            pack_nibbles(np.asarray(allele_id), np.asarray(valid)),
            np.asarray(is_variant),
            max_alleles,
            threshold_percent=threshold_percent,
        )
    # Nibble packing reserves 0xF for empty slots; rare K>15 configs use
    # the unpacked counting kernel.
    from guacamole.ops.kernels import tile_stats

    stats = tile_stats(
        allele_id, strand, valid, is_variant, max_alleles,
        threshold_percent=threshold_percent,
    )
    pending = PendingScreen(
        stats.counts, stats.forward_counts, stats.depth,
        stats.variant_evidence,
    )
    # Queue the host copies right behind the kernels so the transfer is
    # already in flight when result() is called.
    copy_to_host_async(*pending)
    return pending


def _as_pending(out) -> PendingScreen:
    pending = PendingScreen(out.counts, None, None, out.candidates)
    copy_to_host_async(out.counts, out.candidates)
    return pending


def screen_packed_launch(
    packed: np.ndarray,
    is_variant: np.ndarray,
    max_alleles: int,
    threshold_percent=None,
) -> PendingScreen:
    """Dispatch the nibble-packed counting screen (the default XLA path)."""
    from guacamole.ops.kernels import tile_stats_nibble

    return _as_pending(
        tile_stats_nibble(
            packed, is_variant, max_alleles,
            threshold_percent=threshold_percent,
        )
    )


def _bucket_bytes(n: int) -> int:
    """Pad CSR byte-blob lengths to quarter-power-of-two steps (>= 2048):
    a small compiled-shape set with at most ~12% transfer padding."""
    b = 2048
    while b < n:
        b *= 2
    if b > 2048:
        half = b // 2
        for step in (1, 2, 3):
            cand = half + (half * step) // 4
            if cand >= n:
                return cand
    return b


def candidates_of(result) -> np.ndarray:
    """The [L] bool candidate mask from either screen-result kind
    (PendingCandidates ndarray or a ScreenResult)."""
    return (
        result
        if isinstance(result, np.ndarray)
        else np.asarray(result.candidates)
    )


class PendingCandidates:
    """Dispatched-but-unfetched candidate mask (device array)."""

    __slots__ = ("_arr",)

    def __init__(self, arr):
        self._arr = arr
        copy_to_host_async(arr)

    def result(self) -> np.ndarray:
        (out,) = fetch_arrays(self._arr)
        return out


def ll_pack_of(tile, min_mapq: int = 0) -> np.ndarray:
    """A tile's likelihood-screen encoding (allele_id | qual << 4 uint16,
    0xFFFF empty/filtered), from the native packer when present, else
    packed here from the full per-element tensors."""
    pack = getattr(tile, "ll_pack", None)
    if pack is not None:
        packed_min = getattr(tile, "ll_min_mapq", None) or 0
        if packed_min != min_mapq:
            raise ValueError(
                "tile was likelihood-packed with min_mapq=%d but the "
                "screen requested min_mapq=%d" % (packed_min, min_mapq)
            )
        return pack
    if tile.valid is None:
        raise ValueError(
            "tile has neither a native ll_pack nor per-element tensors"
        )
    keep = np.asarray(tile.valid)
    if min_mapq > 0:
        keep = keep & (np.asarray(tile.mapq) >= min_mapq)
    aid = np.asarray(tile.allele_id)
    qual = np.asarray(tile.qual).astype(np.uint16)
    return np.where(
        keep, (aid & 0xF).astype(np.uint16) | (qual << 4), np.uint16(0xFFFF)
    ).astype(np.uint16)


def ll_mapq_of(tile, min_mapq: int = 0) -> np.ndarray:
    """A tile's per-element read-MAPQ plane for the alignment-included
    tumor screen ([L, D] uint8), from the native packer when present, else
    derived from the full per-element tensors. Values are only read at
    slots valid in ll_pack, so fill values for empty slots are irrelevant."""
    mq = getattr(tile, "ll_mapq", None)
    if mq is not None:
        return np.asarray(mq)
    if tile.mapq is None:
        raise ValueError(
            "tile has neither a native ll_mapq nor per-element tensors"
        )
    return np.clip(np.asarray(tile.mapq), 0, 255).astype(np.uint8)


def pack_flag_words(is_variant, is_standard_alt) -> np.ndarray:
    """[L, K <= 15] bool x2 -> [L] uint32 (is_variant bits 0..14,
    is_standard_alt bits 16..30): 4 B/locus across the link instead of
    2K bool bytes — the allele-table planes were ~30%% of the likelihood
    screens' H2D at scale. Unpacked on device (_unpack_flag_words)."""
    iv = np.asarray(is_variant, dtype=bool)
    sa = np.asarray(is_standard_alt, dtype=bool)
    w = np.arange(iv.shape[1], dtype=np.uint32)
    lo = (iv.astype(np.uint32) << w).sum(axis=1, dtype=np.uint32)
    hi = (sa.astype(np.uint32) << w).sum(axis=1, dtype=np.uint32)
    return (lo | (hi << np.uint32(16))).astype(np.uint32)


@functools.partial(jax.jit, static_argnames=("max_alleles",))
def _unpack_flag_words(flags, max_alleles: int):
    import jax.numpy as jnp

    k = jnp.arange(max_alleles, dtype=jnp.uint32)
    iv = ((flags[:, None] >> k) & jnp.uint32(1)) > 0
    sa = ((flags[:, None] >> (k + jnp.uint32(16))) & jnp.uint32(1)) > 0
    return iv, sa


def _ll_screen_device(
    ll_pack: np.ndarray,
    ll_mapq,  # [L, D] uint8 or None
    flag_words: np.ndarray,  # [L] uint32 (pack_flag_words)
    max_alleles: int,
    margin: float = 0.5,
    min_phred: float = 0.0,
    ll_qvals=None,  # ll_pack is the uint8 qual-dictionary form
):
    """Dispatch the genotype-likelihood candidate screen on raw arrays
    (germline form, or the alignment-included tumor form when ll_mapq is
    given). Returns the device candidates array."""
    is_variant, is_standard_alt = _unpack_flag_words(
        flag_words, max_alleles
    )
    if ll_mapq is not None:
        if ll_qvals is not None:
            from guacamole.ops.kernels import tumor_likelihood_screen8

            return tumor_likelihood_screen8(
                ll_pack, ll_qvals, ll_mapq, is_variant, is_standard_alt,
                max_alleles, margin=margin,
            )
        from guacamole.ops.kernels import tumor_likelihood_screen

        return tumor_likelihood_screen(
            ll_pack, ll_mapq, is_variant, is_standard_alt, max_alleles,
            margin=margin,
        )
    if ll_qvals is not None:
        from guacamole.ops.kernels import germline_likelihood_screen8

        return germline_likelihood_screen8(
            ll_pack, ll_qvals, is_variant, is_standard_alt, max_alleles,
            margin=margin, min_phred=min_phred,
        )
    from guacamole.ops.kernels import germline_likelihood_screen

    return germline_likelihood_screen(
        ll_pack, is_variant, is_standard_alt, max_alleles, margin=margin,
        min_phred=min_phred,
    )


# Cells ([rows, D] slots) of one likelihood-screen launch: the XLA
# kernels reduce a [rows, D, K] one-hot expression, so megatile [L, D]
# inputs split into row slabs. On the H100 the time per cell is flat
# from 4M cells up (PERF.md).
LL_SLAB_CELLS = 4 << 20


class _MergedCandidates:
    """Slab-launched candidate screens presenting one tile-wide mask."""

    __slots__ = ("_pendings",)

    def __init__(self, pendings):
        self._pendings = pendings  # [(n_rows, PendingCandidates)]

    def result(self) -> np.ndarray:
        return np.concatenate(
            [np.asarray(p.result())[:nr] for nr, p in self._pendings]
        )


def ll_screen_arrays_launch(
    ll_pack, ll_mapq, is_variant, is_standard_alt, max_alleles: int,
    margin: float = 0.5,
    min_phred: float = 0.0,
    ll_qvals=None,
):
    """PendingCandidates form of _ll_screen_device. Megatile inputs
    split into row slabs (padded to the shared row-bucket ladder with
    all-empty rows — 0xFFFF ll_pack slots yield candidate=False) whose
    masks concatenate transparently at fetch."""
    L, D = np.asarray(ll_pack).shape
    slab_rows = max(256, LL_SLAB_CELLS // max(D, 1))
    empty_slot = 0xFF if ll_qvals is not None else 0xFFFF
    words = pack_flag_words(is_variant, is_standard_alt)
    if L <= slab_rows:
        ll_pack, ll_mapq, words = _stage(ll_pack, ll_mapq, words)
        return PendingCandidates(
            _ll_screen_device(
                ll_pack, ll_mapq, words, max_alleles,
                margin=margin, min_phred=min_phred, ll_qvals=ll_qvals,
            )
        )
    pendings = []
    for r0 in range(0, L, slab_rows):
        r1 = min(r0 + slab_rows, L)
        nr = r1 - r0
        npad = min(_bucket_rows_slab(nr), slab_rows)
        sp = np.asarray(ll_pack)[r0:r1]
        fl = words[r0:r1]
        sm = (
            np.asarray(ll_mapq)[r0:r1] if ll_mapq is not None else None
        )
        if npad > nr:
            pad = npad - nr
            sp = np.concatenate(
                [sp, np.full((pad, D), empty_slot, sp.dtype)]
            )
            fl = np.concatenate([fl, np.zeros(pad, fl.dtype)])
            if sm is not None:
                sm = np.concatenate(
                    [sm, np.zeros((pad, D), sm.dtype)]
                )
        sp, sm, fl = _stage(sp, sm, fl)
        pendings.append(
            (
                nr,
                PendingCandidates(
                    _ll_screen_device(
                        sp, sm, fl, max_alleles, margin=margin,
                        min_phred=min_phred, ll_qvals=ll_qvals,
                    )
                ),
            )
        )
    return _MergedCandidates(pendings)


def germline_screen_launch(
    tile, min_mapq: int = 0, margin: float = 0.5, min_phred: float = 0.0
) -> PendingCandidates:
    """Dispatch the genotype-likelihood candidate screen for one tile.

    Note: when the tile was packed with fields="likelihood", its allele
    tables are already MAPQ-filtered natively; the min_mapq here only
    applies to Python-packed full tiles.
    """
    pack8 = getattr(tile, "ll_pack8", None)
    if pack8 is not None:
        # Qual-dictionary byte form (native tiles, <= 16 distinct quals):
        # half the transfer, identical flags. The pack-time MAPQ filter
        # contract is checked the same way as ll_pack_of.
        packed_min = getattr(tile, "ll_min_mapq", None) or 0
        if packed_min == min_mapq:
            return ll_screen_arrays_launch(
                np.asarray(pack8),
                None,
                np.asarray(tile.is_variant),
                np.asarray(tile.is_standard_alt),
                tile.K,
                margin=margin,
                min_phred=min_phred,
                ll_qvals=np.asarray(tile.ll_qvals),
            )
    return ll_screen_arrays_launch(
        ll_pack_of(tile, min_mapq),
        None,
        np.asarray(tile.is_variant),
        np.asarray(tile.is_standard_alt),
        tile.K,
        margin=margin,
        min_phred=min_phred,
    )


def tumor_screen_launch(
    tile, min_mapq: int = 0, margin: float = 0.5
) -> PendingCandidates:
    """Dispatch the alignment-included tumor likelihood screen for one
    tile packed with fields="likelihood_mapq"."""
    packed_min = getattr(tile, "ll_min_mapq", None) or 0
    if packed_min != min_mapq:
        raise ValueError(
            "tile was likelihood-packed with min_mapq=%d but the screen "
            "requested min_mapq=%d" % (packed_min, min_mapq)
        )
    pack8 = getattr(tile, "ll_pack8", None)
    if pack8 is not None:
        return ll_screen_arrays_launch(
            np.asarray(pack8),
            np.asarray(tile.ll_mapq),
            np.asarray(tile.is_variant),
            np.asarray(tile.is_standard_alt),
            tile.K,
            margin=margin,
            ll_qvals=np.asarray(tile.ll_qvals),
        )
    return ll_screen_arrays_launch(
        np.asarray(tile.ll_pack),
        np.asarray(tile.ll_mapq),
        np.asarray(tile.is_variant),
        np.asarray(tile.is_standard_alt),
        tile.K,
        margin=margin,
    )


def screen_on_host() -> bool:
    """Run counting/likelihood screens from the native packer's outputs
    on host instead of shipping encodings to a device: when the default
    device is the CPU (a CPU "device" screen is the same silicon with
    extra XLA round trips; the native packer computes the same
    candidates inline during the pack). Any accelerator screens on the
    device. GUAC_HOST_SCREEN=1/0 forces either (tests pin host/device
    equality with it)."""
    env = os.environ.get("GUAC_HOST_SCREEN", "")
    if env in ("0", "1"):
        return env == "1"
    return jax.devices()[0].platform == "cpu"


def pack_skip_nibbles(mesh=None) -> bool:
    """True when CSR screen tiles may skip the nibble blob at pack time:
    no mesh and the counting screens will run from the packer's [L, K]
    counts on host (screen_on_host), so nothing ever reads csr_nib. The
    native packer then uses the fused single-phase fill (no per-element
    second pass, no nibble writes) — identical counts/candidates."""
    return mesh is None and screen_on_host()


def host_counts_candidates(counts, is_variant, threshold_percent):
    """numpy twin of kernels.counts_candidates (THE candidate rule) for
    the host fallback screen; depth is the row sum of counts, exactly as
    the CSR device kernel recovers it."""
    counts = np.asarray(counts)
    is_variant = np.asarray(is_variant, dtype=bool)
    if threshold_percent is None:
        return ((counts > 0) & is_variant).any(axis=1)
    depth = counts.sum(axis=1)
    passing = (counts > 0) & (
        counts * 100 >= depth[:, None] * (threshold_percent + 1)
    )
    return (passing & is_variant).any(axis=1) | (
        (passing & ~is_variant).sum(axis=1) >= 2
    )


class _HostCountsScreen:
    """Pending-compatible screen computed from native pack counts."""

    __slots__ = ("_counts", "_is_variant", "_threshold", "_compact")

    def __init__(self, counts, is_variant, threshold_percent, compact):
        self._counts = counts
        self._is_variant = is_variant
        self._threshold = threshold_percent
        self._compact = compact

    def result(self):
        from guacamole.runtime.native import counts_screen_native

        candidates = counts_screen_native(
            self._counts, self._is_variant, self._threshold
        )
        if candidates is None:
            candidates = host_counts_candidates(
                self._counts, self._is_variant, self._threshold
            )
        if self._compact:
            idx = np.flatnonzero(candidates).astype(np.int64)
            return CompactScreen(
                idx, np.asarray(self._counts)[idx], len(idx)
            )
        return ScreenResult(
            np.asarray(self._counts), None, None, candidates
        )


# Blob bytes of one CSR screen launch: the XLA counting kernel
# materializes ~8*K bytes of one-hot + prefix intermediates per blob byte,
# so a 70 MB megatile blob in one launch would allocate gigabytes. Slabs
# bound that working set (1 GiB at 16 MiB) while a whole region still
# screens in a few launches; on the H100 a launch costs the same up to
# 16 MiB (PERF.md).
CSR_SLAB_BYTES = 16 << 20


def _csr_slab_ranges(row_off: np.ndarray, slab_bytes: int):
    """Row ranges [(r0, r1)] whose byte spans each fit slab_bytes (one
    over-long row still gets its own slab)."""
    L = len(row_off) - 1
    out = []
    r0 = 0
    while r0 < L:
        target = int(row_off[r0]) + slab_bytes
        r1 = int(np.searchsorted(row_off, target, side="right")) - 1
        r1 = min(max(r1, r0 + 1), L)
        out.append((r0, r1))
        r0 = r1
    return out


def _bucket_rows_slab(n: int) -> int:
    """Pad slab row counts to the SAME quarter-power-of-two ladder the
    tile packer uses (one source of truth: pack.columnar._bucket_rows),
    so slab shapes and tile shapes share a compiled-shape set."""
    from guacamole.pack.columnar import _bucket_rows

    return _bucket_rows(n)


def _pad_slab_rows(row_off: np.ndarray, is_variant: np.ndarray):
    """Pad a slab's row axis to its bucket: appended rows are empty (their
    offsets repeat the blob end, their variant flags are all-false), so
    they produce zero counts and no candidates."""
    nr = len(row_off) - 1
    npad = _bucket_rows_slab(nr)
    if npad == nr:
        return row_off, is_variant, nr
    row_off = np.concatenate(
        [row_off, np.full(npad - nr, row_off[-1], row_off.dtype)]
    )
    is_variant = np.concatenate(
        [
            is_variant,
            np.zeros((npad - nr,) + is_variant.shape[1:], is_variant.dtype),
        ]
    )
    return row_off, is_variant, nr


class _MergedScreens:
    """Slab-launched CSR screens presenting one tile-wide result."""

    __slots__ = ("_pendings",)

    def __init__(self, pendings):
        self._pendings = pendings  # [(n_rows, PendingScreen)]

    def result(self) -> ScreenResult:
        parts = [(nr, p.result()) for nr, p in self._pendings]
        return ScreenResult(
            np.concatenate([p.counts[:nr] for nr, p in parts]),
            None,
            None,
            np.concatenate([p.candidates[:nr] for nr, p in parts]),
        )


def pack_variant_words16(is_variant) -> np.ndarray:
    """[L, K <= 15] bool -> [L] uint16 bitmask (device-unpacked)."""
    iv = np.asarray(is_variant, dtype=bool)
    w = np.arange(iv.shape[1], dtype=np.uint16)
    return (iv.astype(np.uint16) << w).sum(axis=1, dtype=np.uint16)


@functools.partial(jax.jit, static_argnames=("max_alleles",))
def _unpack_variant_words(variant_words, max_alleles: int):
    import jax.numpy as jnp

    k = jnp.arange(max_alleles, dtype=jnp.uint16)
    return (((variant_words[:, None] >> k) & jnp.uint16(1)) > 0,)


@functools.partial(jax.jit, static_argnames=("max_alleles",))
def _unpack_csr_meta(nibble_bytes, variant_words, max_alleles: int):
    """Device-side rebuild of the CSR row metadata from the compact wire
    form: [L] uint16 per-row nibble-byte counts -> [L+1] int32 offsets
    (exact integer cumsum), [L] uint16 masks -> [L, K] bool flags. Cuts
    the CSR screens' non-blob H2D ~3x (int32 offsets + K bool bytes ->
    2+2 bytes per row)."""
    import jax.numpy as jnp

    counts = nibble_bytes.astype(jnp.int32)
    row_off = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(counts)]
    )
    k = jnp.arange(max_alleles, dtype=jnp.uint16)
    iv = ((variant_words[:, None] >> k) & jnp.uint16(1)) > 0
    return row_off, iv


def _screen_csr_one_launch(
    csr_nib, row_off, is_variant, max_alleles, threshold_percent
) -> PendingScreen:
    pad = _bucket_bytes(len(csr_nib)) - len(csr_nib)
    if pad:
        csr_nib = np.concatenate(
            [csr_nib, np.full(pad, 0xFF, np.uint8)]
        )
    nb_wide = np.diff(np.asarray(row_off))
    vw = pack_variant_words16(is_variant)
    if nb_wide.size == 0 or int(nb_wide.max(initial=0)) <= 0xFFFF:
        nb = nb_wide.astype(np.uint16)
        csr_nib, nb, vw = _stage(csr_nib, nb, vw)
        row_off, is_variant = _unpack_csr_meta(nb, vw, max_alleles)
    else:
        # A single row beyond 64 KB of nibbles (depth > 131k) would wrap
        # the uint16 wire form and corrupt every later offset: ship the
        # int32 offsets directly for this (pathological) slab.
        row_off = np.asarray(row_off, dtype=np.int32)
        csr_nib, row_off, vw = _stage(csr_nib, row_off, vw)
        (is_variant,) = _unpack_variant_words(vw, max_alleles)
    from guacamole.ops.kernels import tile_stats_csr

    return _as_pending(
        tile_stats_csr(
            csr_nib, row_off, is_variant, max_alleles,
            threshold_percent=threshold_percent,
        )
    )


def screen_csr_launch(
    csr_nib: np.ndarray,  # [B] uint8
    row_off: np.ndarray,  # [L+1] int32
    is_variant: np.ndarray,  # [L, K] bool
    max_alleles: int,
    threshold_percent=None,
):
    """Dispatch the CSR counting screen (native screen-mode tiles). Blobs
    beyond the slab bound split into row-aligned slab launches whose
    results concatenate transparently at fetch."""
    if len(csr_nib) <= CSR_SLAB_BYTES:
        return _screen_csr_one_launch(
            csr_nib, row_off, is_variant, max_alleles, threshold_percent
        )
    row_off = np.asarray(row_off)
    pendings = []
    for r0, r1 in _csr_slab_ranges(row_off, CSR_SLAB_BYTES):
        b0, b1 = int(row_off[r0]), int(row_off[r1])
        so, sv, nr = _pad_slab_rows(
            row_off[r0 : r1 + 1] - b0, np.asarray(is_variant[r0:r1])
        )
        pendings.append(
            (
                nr,
                _screen_csr_one_launch(
                    csr_nib[b0:b1], so, sv, max_alleles, threshold_percent
                ),
            )
        )
    return _MergedScreens(pendings)


class CompactScreen(NamedTuple):
    """Candidate-compacted screen result (decoded on host).

    idx/counts carry ONLY candidate rows; total is the device's candidate
    count. When total > len(idx) the compaction overflowed and the caller
    must refetch the full screen (CompactScreen carries no usable rows in
    that case beyond the first cap candidates)."""

    idx: np.ndarray  # [n] int32 ascending candidate rows
    counts: np.ndarray  # [n, K] int32 counts at those rows
    total: int

    @property
    def overflowed(self) -> bool:
        return self.total > len(self.idx)


class PendingCompact:
    """Dispatched-but-unfetched compact screen (one device array)."""

    __slots__ = ("_arr",)

    def __init__(self, arr):
        self._arr = arr
        copy_to_host_async(arr)

    def result(self) -> CompactScreen:
        (raw,) = fetch_arrays(self._arr)  # [cap+1, K+1]
        total = int(raw[-1, 0])
        body = raw[:-1]
        n = min(total, len(body))
        return CompactScreen(body[:n, 0], body[:n, 1:], total)


class _MergedCompacts:
    """Slab-launched compact screens presenting one tile-wide result.

    Overflow composes naturally: an overflowed slab contributes more to
    `total` than rows to `idx`, so the merged result's overflowed property
    is True and the caller refetches the full screen."""

    __slots__ = ("_slabs",)

    def __init__(self, slabs):
        self._slabs = slabs  # [(row_base, PendingCompact)]

    def result(self) -> CompactScreen:
        parts = [(r0, p.result()) for r0, p in self._slabs]
        idx = np.concatenate(
            [r0 + s.idx for r0, s in parts]
        ) if parts else np.empty(0, np.int64)
        counts = (
            np.concatenate([s.counts for _r0, s in parts])
            if parts
            else np.empty((0, 0), np.int32)
        )
        return CompactScreen(idx, counts, sum(s.total for _r0, s in parts))


def _compact_one_launch(
    csr_nib, row_off, is_variant, max_alleles, threshold_percent, cap
) -> PendingCompact:
    from guacamole.ops.kernels import tile_stats_csr_compact

    pad = _bucket_bytes(len(csr_nib)) - len(csr_nib)
    if pad:
        csr_nib = np.concatenate(
            [csr_nib, np.full(pad, 0xFF, np.uint8)]
        )
    nb_wide = np.diff(np.asarray(row_off))
    vw = pack_variant_words16(is_variant)
    if nb_wide.size == 0 or int(nb_wide.max(initial=0)) <= 0xFFFF:
        nb = nb_wide.astype(np.uint16)
        csr_nib, nb, vw = _stage(csr_nib, nb, vw)
        row_off, is_variant = _unpack_csr_meta(nb, vw, max_alleles)
    else:
        # A single row beyond 64 KB of nibbles (depth > 131k) would wrap
        # the uint16 wire form and corrupt every later offset: ship the
        # int32 offsets directly for this (pathological) slab.
        row_off = np.asarray(row_off, dtype=np.int32)
        csr_nib, row_off, vw = _stage(csr_nib, row_off, vw)
        (is_variant,) = _unpack_variant_words(vw, max_alleles)
    return PendingCompact(
        tile_stats_csr_compact(
            csr_nib, row_off, is_variant, max_alleles,
            threshold_percent=threshold_percent, cap=cap,
        )
    )


def screen_csr_compact_launch(
    csr_nib: np.ndarray,  # [B] uint8
    row_off: np.ndarray,  # [L+1] int32
    is_variant: np.ndarray,  # [L, K] bool
    max_alleles: int,
    threshold_percent=None,
    cap: int = 512,
):
    """Dispatch the CSR screen with device-side candidate compaction: the
    host fetch is one small [cap+1, K+1] array instead of the full [L, K]
    counts + [L] mask. Blobs beyond the slab bound split into row-aligned
    slab launches (each with a cap scaled to its row count) whose results
    merge transparently at fetch."""
    if len(csr_nib) <= CSR_SLAB_BYTES:
        return _compact_one_launch(
            csr_nib, row_off, is_variant, max_alleles, threshold_percent,
            max(cap, (len(row_off) - 1) // 256),
        )
    row_off = np.asarray(row_off)
    slabs = []
    for r0, r1 in _csr_slab_ranges(row_off, CSR_SLAB_BYTES):
        b0, b1 = int(row_off[r0]), int(row_off[r1])
        so, sv, _nr = _pad_slab_rows(
            row_off[r0 : r1 + 1] - b0, np.asarray(is_variant[r0:r1])
        )
        slabs.append(
            (
                r0,
                _compact_one_launch(
                    csr_nib[b0:b1], so, sv, max_alleles, threshold_percent,
                    max(cap, (len(so) - 1) // 256),
                ),
            )
        )
    return _MergedCompacts(slabs)


def _cat_csr(tiles):
    """Concatenate CSR tiles: one blob, row offsets rebased per tile, and
    the stacked is_variant table."""
    blobs = [np.asarray(t.csr_nib) for t in tiles]
    offs = [np.asarray(t.csr_off, dtype=np.int32) for t in tiles]
    if len(tiles) == 1:
        packed, row_off = blobs[0], offs[0]
    else:
        packed = np.concatenate(blobs)
        base = 0
        parts = [offs[0]]
        for blob, off in zip(blobs[:-1], offs[1:]):
            base += len(blob)
            parts.append(off[1:] + base)
        row_off = np.concatenate(parts)
    is_variant = (
        np.asarray(tiles[0].is_variant)
        if len(tiles) == 1
        else np.concatenate([np.asarray(t.is_variant) for t in tiles])
    )
    return packed, row_off, is_variant


def screen_tile(
    allele_id, qual, mapq, strand, valid, is_variant, max_alleles: int,
    threshold_percent=None,
) -> ScreenResult:
    """Per-locus counts + variant-evidence screening for one tile."""
    return screen_tile_launch(
        allele_id, qual, mapq, strand, valid, is_variant, max_alleles,
        threshold_percent=threshold_percent,
    ).result()


def screen_tile_for(tile, threshold_percent=None, valid=None) -> ScreenResult:
    """Counting screen for a LocusTile, using its native nibble encoding
    when available (the fast path for every caller that doesn't need
    per-element qualities on device)."""
    if valid is None and getattr(tile, "csr_nib", None) is not None:
        return screen_csr_launch(
            tile.csr_nib,
            tile.csr_off,
            np.asarray(tile.is_variant),
            tile.K,
            threshold_percent=threshold_percent,
        ).result()
    return screen_packed_launch(
        tile_packed_nibbles(tile, valid),
        np.asarray(tile.is_variant),
        tile.K,
        threshold_percent=threshold_percent,
    ).result()


def prefetch_iter(iterable, ahead: int = 2):
    """Run `iterable` on a background thread, buffering up to `ahead`
    items. Tile packing dominates caller wall time and the native packer
    releases the GIL for its whole ctypes call, so producing tiles on a
    side thread overlaps packing with the consumer's device fetches and
    exact-confirm math (both mostly GIL-released numpy as well).

    Items are yielded in production order. Exceptions raised by the
    producer re-raise at the consumer's next pull. If the consumer
    abandons the generator, the producer thread notices within 100 ms of
    its next put and exits."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(1, ahead))
    done = object()
    stop = False

    def worker():
        try:
            it = iter(iterable)
            while True:
                try:
                    item = next(it)
                except StopIteration:
                    payload = (done, None)
                    break
                while not stop:
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop:
                    return
        except BaseException as exc:  # re-raised at the consumer
            payload = (done, exc)
        while not stop:
            try:
                q.put(payload, timeout=0.1)
                return
            except queue.Full:
                continue

    thread = threading.Thread(
        target=worker, name="guac-prefetch", daemon=True
    )
    thread.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is done:
                if item[1] is not None:
                    raise item[1]
                return
            yield item
    finally:
        stop = True


def pipelined(items, launch, max_in_flight: int = 8):
    """Yield (item, launch(item)) with a bounded window of launches in
    flight ahead of consumption, so async device dispatches (and their
    device->host transfers) overlap host-side packing of later items."""
    from collections import deque

    in_flight = deque()
    for item in items:
        in_flight.append((item, launch(item)))
        if len(in_flight) > max_in_flight:
            yield in_flight.popleft()
    while in_flight:
        yield in_flight.popleft()


class _SlicedScreen:
    """A row-slice view over a batched PendingScreen (one tile's results
    out of a multi-tile launch)."""

    __slots__ = ("_batch", "_lo", "_hi")

    def __init__(self, batch, lo: int, hi: int):
        self._batch = batch
        self._lo = lo
        self._hi = hi

    def result(self) -> ScreenResult:
        full = self._batch.cached_result()
        lo, hi = self._lo, self._hi

        def cut(a):
            return a[lo:hi] if a is not None else None

        return ScreenResult(
            cut(full.counts),
            cut(full.forward_counts),
            cut(full.depth),
            cut(full.candidates),
        )


class _BatchPending:
    __slots__ = ("_pending", "_result")

    def __init__(self, pending: PendingScreen):
        self._pending = pending
        self._result = None

    def cached_result(self) -> ScreenResult:
        if self._result is None:
            self._result = self._pending.result()
        return self._result


def pipelined_batched_screens(
    items,
    tile_of,
    batch: int = 4,
    max_in_flight: int = 8,
    threshold_percent=None,
    valid_of=None,
    compact_cap=None,
):
    """Like pipelined(), but stacks up to `batch` same-shape tiles along
    the locus axis into ONE kernel launch (the per-locus kernels don't
    care which tile a row came from). Cuts dispatch + transfer round
    trips by the batch factor.

    compact_cap: when set, CSR tiles dispatch the candidate-compacted
    kernel (yielding PendingCompact results) — only valid when the
    consumer reads counts at candidate rows alone (no emit-ref /
    emit-no-call paths).

    Yields (item, pending-with-.result() or None-for-empty-tile)."""
    from collections import deque

    in_flight = deque()
    groups = {}

    def flush(key):
        members = groups.pop(key)
        tiles = [tile_of(it) for it in members]
        t0 = tiles[0]
        if t0.K > 15:
            if len(tiles) == 1:
                allele_id, qual, mapq, strand = (
                    t0.allele_id, t0.qual, t0.mapq, t0.strand,
                )
                valid = valid_of(t0) if valid_of is not None else t0.valid
                is_variant = t0.is_variant
            else:
                cat = np.concatenate
                allele_id = cat([t.allele_id for t in tiles])
                qual = cat([t.qual for t in tiles])
                mapq = cat([t.mapq for t in tiles])
                strand = cat([t.strand for t in tiles])
                valid = cat(
                    [
                        valid_of(t) if valid_of is not None else t.valid
                        for t in tiles
                    ]
                )
                is_variant = cat([t.is_variant for t in tiles])
            launched = screen_tile_launch(
                allele_id, qual, mapq, strand, valid, is_variant, t0.K,
                threshold_percent=threshold_percent,
            )
        elif key[0] == "csr":
            # CSR tiles batch regardless of their depth profile: blobs
            # concatenate, offsets rebase by each tile's blob length.
            packed, row_off, is_variant = _cat_csr(tiles)
            launched = screen_csr_launch(
                packed, row_off, is_variant, t0.K,
                threshold_percent=threshold_percent,
            )
        else:
            packs = [
                tile_packed_nibbles(
                    t, valid_of(t) if valid_of is not None else None
                )
                for t in tiles
            ]
            packed = packs[0] if len(packs) == 1 else np.concatenate(packs)
            is_variant = (
                np.asarray(tiles[0].is_variant)
                if len(tiles) == 1
                else np.concatenate([np.asarray(t.is_variant) for t in tiles])
            )
            launched = screen_packed_launch(
                packed, is_variant, t0.K, threshold_percent=threshold_percent
            )
        pending = _BatchPending(launched)
        row = 0
        for it, t in zip(members, tiles):
            in_flight.append((it, _SlicedScreen(pending, row, row + t.L)))
            row += t.L

    for item in items:
        tile = tile_of(item)
        if not tile.L:
            in_flight.append((item, None))
        else:
            csr_skipped = (
                getattr(tile, "csr_nib", None) is not None
                and len(tile.csr_nib) == 0
                and getattr(tile, "counts32", None) is not None
            )
            if (
                valid_of is None
                and getattr(tile, "counts32", None) is not None
                and (csr_skipped or screen_on_host())
            ):
                # csr_skipped: the tile was packed with skip_nibbles (the
                # pack-time host-screen decision) — its CSR blob is empty,
                # so a device launch would silently count nothing. The
                # counts screen is always correct; use it unconditionally.
                # Host fallback: no accelerator attached, and the native
                # packer already counted these elements — threshold the
                # counts directly, zero device round trips.
                in_flight.append(
                    (
                        item,
                        _HostCountsScreen(
                            tile.counts32,
                            np.asarray(tile.is_variant),
                            threshold_percent,
                            compact_cap is not None,
                        ),
                    )
                )
            elif (
                valid_of is None
                and getattr(tile, "csr_nib", None) is not None
            ):
                # CSR tiles launch immediately: each tile is one small
                # transfer and JAX pipelines the async dispatches, so
                # packing tile i+1 overlaps tile i's transfer + kernel;
                # a batch barrier would stall the device and
                # classification behind the slowest tile's packing.
                if compact_cap is not None:
                    # (The launch itself scales the compaction width with
                    # row count — 1 candidate per 256 loci is already
                    # dense — so megatiles don't overflow into a full
                    # [L, K] refetch.)
                    in_flight.append(
                        (
                            item,
                            screen_csr_compact_launch(
                                np.asarray(tile.csr_nib),
                                np.asarray(tile.csr_off, dtype=np.int32),
                                np.asarray(tile.is_variant),
                                tile.K,
                                threshold_percent=threshold_percent,
                                cap=compact_cap,
                            ),
                        )
                    )
                else:
                    key = ("csr", tile.L)
                    groups.setdefault(key, []).append(item)
                    flush(key)
            else:
                key = (tile.L, tile.D)
                groups.setdefault(key, []).append(item)
                if len(groups[key]) >= batch:
                    flush(key)
        # Megatiles shrink the in-flight window: each queued item pins
        # its tile's native buffers AND (via the item tuple) its task's
        # columnar chunk, so eight ~1M-row tiles in flight held ~4 tasks'
        # full decode chunks alive at once (a monotone multi-GB RSS ramp
        # at scale). Two in flight still overlaps pack with classify.
        # The window stays shrunk while ANY queued item is a megatile —
        # keying off only the current tile would let a run of small tail
        # tiles re-grow the window around a still-queued megatile.
        window = (
            2
            if any(
                tile_of(it).L >= (1 << 17)
                for it, _p in in_flight
                if _p is not None
            )
            else max_in_flight
        )
        while len(in_flight) > window:
            yield in_flight.popleft()
    for key in list(groups):
        flush(key)
    while in_flight:
        yield in_flight.popleft()

