"""Multi-chip execution: loci-sharded device mesh.

The distribution model replaces the reference's Spark shuffle
(cf. upstream .../DistributedUtil.scala:558-634) with:

 - host-side loci partitioning (uniform or depth-balanced) assigning each
   device a contiguous span of loci tiles;
 - halo duplication on host: reads overlapping a shard boundary are packed
   into both shards (the reference's boundary-read duplication, :585-597),
   so per-locus compute is fully local to one device;
 - a shard_map'd per-tile kernel over a 1-D "loci" mesh axis; the only
   cross-device communication is the psum of global counters (the analog of
   Spark accumulators), which XLA hands to NCCL on GPUs.

Within one process, shards = devices; across processes each process
packs only its own loci shard's byte ranges from the BAM and merges
results on the host (see parallel/multihost.py).

The per-shard bodies call the SHARED kernel math from ops/kernels.py
(csr_screen_math / germline_screen_math / tumor_screen_math / tile_stats
semantics) — one source of truth for the counting/likelihood rules; the
mesh only adds the shard axis and the psum'd counters.
"""

from __future__ import annotations

import functools
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from guacamole.ops.dispatch import copy_to_host_async
from guacamole.ops.kernels import (
    csr_screen_math,
    genotype_log_likelihoods,
    germline_screen_math,
    probability_correct,
    tumor_screen_math,
)
from guacamole.pack.tiles import LocusTile


def loci_mesh(devices: Sequence = None) -> Mesh:
    """A 1-D mesh over all (or the given) devices, axis name 'loci'."""
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devices), axis_names=("loci",))


# ---------------------------------------------------------------------------
# Production mesh screens: one shard_map step over n_devices tiles at once.
# Each step's per-shard body reuses the exact single-device kernel math.
# ---------------------------------------------------------------------------


class MeshCsrOutput(NamedTuple):
    counts: jnp.ndarray  # [S, L, K] int16 per-locus allele counts
    candidates: jnp.ndarray  # [S, L] bool
    total_elements: jnp.ndarray  # [] psum'd global element count
    total_candidates: jnp.ndarray  # [] psum'd global candidate count


@functools.lru_cache(maxsize=None)
def _mesh_csr_step(mesh: Mesh, max_alleles: int, threshold_percent):
    """shard_map'd CSR counting screen: each device screens its own tile
    (packed[s], row_off[s], is_variant[s]) with the shared XLA math;
    global counters psum across the mesh."""
    spec = P("loci")

    def per_shard(packed, row_off, is_variant):
        counts, candidates = csr_screen_math(
            packed[0], row_off[0], is_variant[0], max_alleles,
            threshold_percent,
        )
        total_elements = jax.lax.psum(
            jnp.sum(counts, dtype=jnp.int32), axis_name="loci"
        )
        total_candidates = jax.lax.psum(
            jnp.sum(candidates, dtype=jnp.int32), axis_name="loci"
        )
        # int16 halves the device->host transfer; rows deeper than 32767
        # are flagged overflow by the packer and never read (same contract
        # as tile_stats_csr).
        return (
            counts.astype(jnp.int16)[None],
            candidates[None],
            total_elements,
            total_candidates,
        )

    sharded = shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=(spec, spec, P(), P()),
    )
    return jax.jit(lambda p, r, v: MeshCsrOutput(*sharded(p, r, v)))


@functools.lru_cache(maxsize=None)
def _mesh_ll_step(mesh: Mesh, max_alleles: int, margin: float,
                  include_alignment: bool, min_phred: float = 0.0):
    """shard_map'd genotype-likelihood candidate screen (germline form, or
    the alignment-included tumor form when include_alignment), with the
    shared XLA math as the per-shard body."""
    spec = P("loci")

    if include_alignment:

        def per_shard(ll_pack, ll_mapq, is_variant, is_standard_alt):
            cand = tumor_screen_math(
                ll_pack[0], ll_mapq[0], is_variant[0],
                is_standard_alt[0], max_alleles, margin,
            )
            total = jax.lax.psum(
                jnp.sum(cand, dtype=jnp.int32), axis_name="loci"
            )
            return cand[None], total

        sharded = shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(spec, spec, spec, spec),
            out_specs=(spec, P()),
        )
        return jax.jit(sharded)

    def per_shard(ll_pack, is_variant, is_standard_alt):
        cand = germline_screen_math(
            ll_pack[0], is_variant[0], is_standard_alt[0], max_alleles,
            margin, min_phred=min_phred,
        )
        total = jax.lax.psum(jnp.sum(cand, dtype=jnp.int32), axis_name="loci")
        return cand[None], total

    sharded = shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=(spec, P()),
    )
    return jax.jit(sharded)


def _bucket(n: int, base: int = 256) -> int:
    """Pad sizes to power-of-two-ish steps to bound the compiled-shape set."""
    b = base
    while b < n:
        b *= 2
    if b > base:
        half = b // 2
        for step in (1, 2, 3):
            cand = half + (half * step) // 4
            if cand >= n:
                return cand
    return b


class _MeshPendingSlice:
    """One shard's slice of a dispatched mesh step (counts+candidates or
    candidates-only), presenting the .result() protocol the callers'
    classify/confirm stages already consume."""

    __slots__ = ("_arrs", "_shard", "_L")

    def __init__(self, arrs, shard: int, L: int):
        self._arrs = arrs
        self._shard = shard
        self._L = L

    def result(self):
        from guacamole.ops.dispatch import ScreenResult, fetch_arrays

        if len(self._arrs) == 1:  # candidates-only (likelihood screens)
            (cand,) = fetch_arrays(self._arrs[0])
            return np.asarray(cand)[self._shard, : self._L]
        counts, cand = fetch_arrays(*self._arrs)
        return ScreenResult(
            np.asarray(counts)[self._shard, : self._L],
            None,
            None,
            np.asarray(cand)[self._shard, : self._L],
        )


def _dense_to_csr(tile) -> Tuple[np.ndarray, np.ndarray]:
    """CSR nibble encoding from a full tile's per-element tensors (the
    fallback when the packer didn't emit csr_nib — Python-packed tiles)."""
    allele_id = np.asarray(tile.allele_id)
    valid = np.asarray(tile.valid).astype(bool)
    L = allele_id.shape[0]
    # Compact valid slots to the front of each row (stable).
    order = np.argsort(~valid, axis=1, kind="stable")
    compact = np.take_along_axis(
        np.where(valid, allele_id & 0xF, 0xF).astype(np.uint8), order, axis=1
    )
    depths = valid.sum(axis=1)
    nbytes = (depths + 1) // 2
    row_off = np.zeros(L + 1, dtype=np.int32)
    np.cumsum(nbytes, out=row_off[1:])
    blob = np.empty(int(row_off[-1]), dtype=np.uint8)
    for r in range(L):
        d = int(depths[r])
        if not d:
            continue
        row = compact[r, :d]
        if d % 2:
            row = np.concatenate([row, np.full(1, 0xF, np.uint8)])
        blob[row_off[r] : row_off[r + 1]] = row[0::2] | (row[1::2] << 4)
    return blob, row_off


def csr_of(tile) -> Tuple[np.ndarray, np.ndarray]:
    """A tile's CSR nibble encoding (native when present, else derived)."""
    if getattr(tile, "csr_nib", None) is not None:
        nib = np.asarray(tile.csr_nib)
        off = np.asarray(tile.csr_off, dtype=np.int32)
        # A skip_nibbles-packed tile (empty blob with nonzero offsets)
        # must never reach a device CSR launch — it would silently count
        # nothing. Callers pass skip_nibbles only on host-screen runs.
        # A hard raise (not assert): the failure mode is silently wrong
        # calls, which must fail under python -O too.
        if len(nib) == 0 and len(off) > 0 and off[-1] != 0:
            raise RuntimeError(
                "CSR tile was packed with skip_nibbles but reached a "
                "device screen launch"
            )
        return nib, off
    return _dense_to_csr(tile)


def mesh_csr_screens(
    items,
    tile_of,
    mesh: Mesh,
    threshold_percent=None,
    groups_in_flight: int = 2,
):
    """Screen a stream of CSR tiles over the mesh: group n_devices tiles,
    pad/stack, run ONE shard_map step per group, yield (item, pending).

    Partial final groups run with masked no-op shards (all-empty rows —
    zero counts, zero candidates), NOT replicated duplicates, so no wasted
    work is dispatched. Yield order is per-group; callers sort at the end.
    """
    n = int(mesh.devices.size)
    in_flight: deque = deque()
    group: List = []

    def flush():
        members, tiles = [], []
        for item in group:
            members.append(item)
            tiles.append(tile_of(item))
        group.clear()
        csrs = [csr_of(t) for t in tiles]
        L = _bucket(max(t.L for t in tiles), 256)
        B = _bucket(max(len(c[0]) for c in csrs), 2048)
        K = tiles[0].K
        packed = np.full((n, B), 0xFF, np.uint8)
        row_off = np.zeros((n, L + 1), np.int32)
        is_variant = np.zeros((n, L, K), bool)
        for s, (t, (blob, off)) in enumerate(zip(tiles, csrs)):
            packed[s, : len(blob)] = blob
            row_off[s, : len(off)] = off
            row_off[s, len(off) :] = off[-1]
            is_variant[s, : t.L] = np.asarray(t.is_variant)
        step = _mesh_csr_step(mesh, K, threshold_percent)
        out = step(packed, row_off, is_variant)
        copy_to_host_async(out.counts, out.candidates)
        for s, (item, t) in enumerate(zip(members, tiles)):
            in_flight.append(
                (item, _MeshPendingSlice((out.counts, out.candidates), s, t.L))
            )

    for item in items:
        tile = tile_of(item)
        if not tile.L:
            in_flight.append((item, None))
        else:
            group.append(item)
            if len(group) == n:
                flush()
        while len(in_flight) > groups_in_flight * n:
            yield in_flight.popleft()
    if group:
        flush()
    while in_flight:
        yield in_flight.popleft()


def mesh_ll_screens(
    items,
    tile_of,
    mesh: Mesh,
    margin: float = 0.5,
    include_alignment: bool = False,
    min_mapq: int = 0,
    min_phred: float = 0.0,
    groups_in_flight: int = 2,
):
    """Screen a stream of likelihood-packed tiles over the mesh (germline
    form, or the tumor alignment-included form). Same grouping contract as
    mesh_csr_screens; yields (item, pending-candidates)."""
    from guacamole.ops.dispatch import ll_mapq_of, ll_pack_of

    n = int(mesh.devices.size)
    in_flight: deque = deque()
    group: List = []

    def flush():
        members = list(group)
        group.clear()
        tiles = [tile_of(item) for item in members]
        packs = [ll_pack_of(t, min_mapq) for t in tiles]
        L = _bucket(max(t.L for t in tiles), 256)
        D = _bucket(max(p.shape[1] for p in packs), 16)
        K = tiles[0].K
        ll_pack = np.full((n, L, D), 0xFFFF, np.uint16)
        is_variant = np.zeros((n, L, K), bool)
        is_standard = np.zeros((n, L, K), bool)
        mapq = np.zeros((n, L, D), np.uint8) if include_alignment else None
        for s, (t, pck) in enumerate(zip(tiles, packs)):
            ll_pack[s, : pck.shape[0], : pck.shape[1]] = pck
            is_variant[s, : t.L] = np.asarray(t.is_variant)
            is_standard[s, : t.L] = np.asarray(t.is_standard_alt)
            if include_alignment:
                mq = ll_mapq_of(t, min_mapq)
                mapq[s, : mq.shape[0], : mq.shape[1]] = mq
        step = _mesh_ll_step(
            mesh, K, margin, include_alignment, min_phred=min_phred
        )
        if include_alignment:
            cand, _total = step(ll_pack, mapq, is_variant, is_standard)
        else:
            cand, _total = step(ll_pack, is_variant, is_standard)
        copy_to_host_async(cand)
        for s, (item, t) in enumerate(zip(members, tiles)):
            in_flight.append((item, _MeshPendingSlice((cand,), s, t.L)))

    for item in items:
        tile = tile_of(item)
        if not tile.L:
            in_flight.append((item, None))
        else:
            group.append(item)
            if len(group) == n:
                flush()
        while len(in_flight) > groups_in_flight * n:
            yield in_flight.popleft()
    if group:
        flush()
    while in_flight:
        yield in_flight.popleft()


# ---------------------------------------------------------------------------
# Full sharded calling step (counts + likelihoods + psum counters): used by
# the driver dryrun and the mesh unit tests; per-shard math is the shared
# kernels (allele counting via one-hot, probability_correct,
# genotype_log_likelihoods) — not a re-derivation.
# ---------------------------------------------------------------------------


class ShardedBatch(NamedTuple):
    """Per-device stacked tile tensors: leading axis = device shard."""

    allele_id: jnp.ndarray  # [S, L, D]
    qual: jnp.ndarray
    mapq: jnp.ndarray
    strand: jnp.ndarray
    valid: jnp.ndarray
    is_variant: jnp.ndarray  # [S, L, K]


def stack_tiles(tiles: Sequence[LocusTile]) -> ShardedBatch:
    """Stack same-shape tiles into [S, L, D] arrays (one tile per shard)."""
    return ShardedBatch(
        allele_id=jnp.asarray(np.stack([t.allele_id for t in tiles])),
        qual=jnp.asarray(np.stack([t.qual for t in tiles])),
        mapq=jnp.asarray(np.stack([t.mapq for t in tiles])),
        strand=jnp.asarray(np.stack([t.strand for t in tiles])),
        valid=jnp.asarray(np.stack([t.valid for t in tiles])),
        is_variant=jnp.asarray(np.stack([t.is_variant for t in tiles])),
    )


class CallStepOutput(NamedTuple):
    counts: jnp.ndarray  # [S, L, K] per-locus allele counts
    forward_counts: jnp.ndarray  # [S, L, K]
    depth: jnp.ndarray  # [S, L]
    candidates: jnp.ndarray  # [S, L] bool: variant evidence present
    log_likelihoods: jnp.ndarray  # [S, L, P] genotype log-likelihoods
    total_elements: jnp.ndarray  # [] global element count (psum over shards)
    total_candidates: jnp.ndarray  # [] global candidate-locus count


def make_sharded_call_step(
    mesh: Mesh, max_alleles: int, threshold_percent=None
):
    """Build the jitted, shard_map'd per-shard calling step.

    Each device processes its own [L, D] tile via the shared single-device
    kernels (tile_stats counting/candidate semantics + the genotype
    log-likelihood kernel); global counters are merged with psum over the
    loci axis (the Spark-accumulator analog).
    """
    from guacamole.ops.kernels import tile_stats

    spec = P("loci")
    replicated = P()

    def per_shard(allele_id, qual, mapq, strand, valid, is_variant):
        # shapes here are the per-device block: [1, L, D] -> squeeze
        allele_id = allele_id[0]
        qual = qual[0]
        mapq = mapq[0]
        strand = strand[0]
        valid = valid[0]
        is_variant = is_variant[0]

        stats = tile_stats(
            allele_id, strand, valid, is_variant, is_variant.shape[-1],
            threshold_percent=threshold_percent,
        )
        pc = probability_correct(qual, mapq, valid, include_alignment=False)
        ll = genotype_log_likelihoods(
            allele_id, pc, valid, is_variant.shape[-1]
        )

        total_elements = jax.lax.psum(
            jnp.sum(stats.depth, dtype=jnp.int32), axis_name="loci"
        )
        total_candidates = jax.lax.psum(
            jnp.sum(stats.variant_evidence, dtype=jnp.int32), axis_name="loci"
        )
        return (
            stats.counts[None],
            stats.forward_counts[None],
            stats.depth[None],
            stats.variant_evidence[None],
            ll[None],
            total_elements,
            total_candidates,
        )

    sharded = shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(spec,) * 6,
        out_specs=(spec, spec, spec, spec, spec, replicated, replicated),
    )

    @jax.jit
    def step(batch: ShardedBatch) -> CallStepOutput:
        outs = sharded(
            batch.allele_id,
            batch.qual,
            batch.mapq,
            batch.strand,
            batch.valid,
            batch.is_variant,
        )
        return CallStepOutput(*outs)

    return step


def sharded_call_step(
    tiles: Sequence[LocusTile], mesh: Mesh = None, max_alleles: int = 8
) -> CallStepOutput:
    """Convenience: stack tiles (one per device) and run the sharded step."""
    if mesh is None:
        mesh = loci_mesh()
    n = len(mesh.devices.flat)
    assert len(tiles) == n, f"need {n} tiles (one per device), got {len(tiles)}"
    batch = stack_tiles(tiles)
    step = make_sharded_call_step(mesh, max_alleles)
    return step(batch)
