"""germline-threshold caller: call variants where the percent of reads
supporting an allele exceeds a threshold.

Pipeline replacing the reference's Spark flow
(cf. the reference's .../commands/GermlineThresholdCaller.scala:58-178):

  load reads -> partition loci (uniform or depth-balanced) -> per shard:
  pack covered loci into dense tiles -> device kernel counts alleles per
  (locus, allele) -> host classifies calls from the (tiny) count matrices.

Per-locus classification parity notes:
 - thresholding uses integer percent arithmetic: count * 100 // depth
 - classification cases (no-call / hom-ref / hom-alt / het-deletion skip /
   het / compound-alt / N-reference) match GermlineThresholdCaller.scala:119-177
 - allele ties at equal counts are broken by canonical allele order (the
   reference's order there is JVM hash order, which is not a meaningful
   contract).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from guacamole.gio.vcf import VcfRecord
from guacamole.loci.locimap import LociMap
from guacamole.loci.lociset import LociSet
from guacamole.ops.dispatch import (
    CompactScreen,
    pipelined_batched_screens,
    screen_tile_for,
)
from guacamole.pack.tiles import LocusTile, pack_tiles
from guacamole.pileup.pileup import Pileup
from guacamole.reads.read import MappedRead
from guacamole.utils import bases as Bases
from guacamole.variants.allele import Allele

log = logging.getLogger(__name__)

NO_CALL = ("NoCall", "NoCall")
HOM_REF = ("Ref", "Ref")
HOM_ALT = ("Alt", "Alt")
HET = ("Ref", "Alt")
COMPOUND = ("Alt", "OtherAlt")

ALT_PLACEHOLDER = Bases.ALT.decode("ascii")

# Device-side candidate compaction width for variant-only runs: each tile
# fetches [cap+1, K+1] int32 instead of the full [L, K] counts. Tiles with
# more candidates than this refetch the full screen (rare).
COMPACT_CAP = 512


@dataclass(frozen=True)
class ThresholdCall:
    sample_name: str
    contig: str
    start: int
    allele: Allele
    labels: Tuple[str, str]

    def to_vcf_record(self) -> VcfRecord:
        return VcfRecord(
            contig=self.contig,
            start=self.start,
            ref=Bases.bases_to_string(self.allele.ref_bases),
            alt=Bases.bases_to_string(self.allele.alt_bases),
            sample_name=self.sample_name or "default",
            genotype=self.labels,
        )


def classify_locus(
    alleles_and_counts: List[Tuple[Allele, int]],
    total_reads: int,
    reference_base: int,
    sample_name: str,
    contig: str,
    locus: int,
    threshold_percent: int,
    emit_ref: bool,
    emit_no_call: bool,
) -> List[ThresholdCall]:
    """Classify one (sample, locus) from its per-allele counts."""
    passing = [
        (allele, count)
        for allele, count in alleles_and_counts
        if count * 100 // total_reads > threshold_percent
    ]
    # Sort by descending count; ties broken by canonical allele order.
    passing.sort(key=lambda pair: (-pair[1], pair[0]))

    def call(allele: Allele, labels: Tuple[str, str]) -> ThresholdCall:
        return ThresholdCall(sample_name, contig, locus, allele, labels)

    ref_placeholder = Allele(bytes([reference_base]), Bases.ALT)

    if not passing:
        return [call(ref_placeholder, NO_CALL)] if emit_no_call else []
    if len(passing) == 1:
        allele, _ = passing[0]
        if not allele.is_variant:
            return [call(ref_placeholder, HOM_REF)] if emit_ref else []
        return [call(allele, HOM_ALT)]
    (a1, _), (a2, _) = passing[0], passing[1]
    # Heterozygous deletion: skip (GermlineThresholdCaller.scala:147-149).
    if (not a1.is_variant or not a2.is_variant) and (
        (a1.alt_bases == b"") != (a2.alt_bases == b"")
    ):
        return []
    if a1.is_variant != a2.is_variant:
        return [call(a1 if a1.is_variant else a2, HET)]
    if a1.is_variant and a2.is_variant:
        return [call(a1, COMPOUND), call(a2, COMPOUND)]
    # Multiple "reference" alleles: tolerate an N reference, else error.
    if a1.ref_bases == b"N" or a2.ref_bases == b"N":
        log.warning(
            "Reference base N found and ignored in sample=%s at (%s, %d)",
            sample_name,
            contig,
            locus,
        )
        proper = a2.ref_bases if a1.ref_bases == b"N" else a1.ref_bases
        return [call(Allele(proper, Bases.ALT), HOM_REF)]
    raise ValueError(
        "Multiple reference bases found in sample = %s at (chr, pos) = (%s, %d)"
        % (sample_name, contig, locus)
    )


def call_variants_at_locus(
    pileup: Pileup,
    threshold_percent: int,
    emit_ref: bool = True,
    emit_no_call: bool = True,
) -> List[ThresholdCall]:
    """Per-pileup API (host oracle path; the tile path is call_tile).
    Mirrors callVariantsAtLocus (GermlineThresholdCaller.scala:90-178),
    including its emitRef/emitNoCall defaults."""
    if not pileup.elements:
        return []
    calls: List[ThresholdCall] = []
    for sample_name, sample_pileup in sorted(pileup.by_sample().items()):
        counts_map: Dict[Allele, int] = {}
        for e in sample_pileup.elements:
            counts_map[e.allele] = counts_map.get(e.allele, 0) + 1
        calls.extend(
            classify_locus(
                sorted(counts_map.items()),
                sample_pileup.depth,
                pileup.reference_base,
                sample_name,
                pileup.reference_name,
                pileup.locus,
                threshold_percent,
                emit_ref,
                emit_no_call,
            )
        )
    return calls


def call_tile(
    tile: LocusTile,
    sample_name: str,
    threshold_percent: int,
    emit_ref: bool,
    emit_no_call: bool,
    sample_reads: Optional[Sequence[MappedRead]] = None,
    source=None,
    pending=None,
) -> List[ThresholdCall]:
    """Run the device counting kernel over a tile and classify on host.

    pending: an already-launched PendingScreen for this tile (pipelined
    path); when absent the kernel is dispatched synchronously here.
    """
    if tile.L == 0:
        return []
    if pending is not None:
        stats = pending.result()
    else:
        stats = screen_tile_for(tile, threshold_percent=threshold_percent)
    depth_arr = np.asarray(tile.depth)[: tile.L]
    overflow_arr = np.asarray(tile.overflow).astype(bool)[: tile.L]
    if isinstance(stats, CompactScreen):
        if stats.overflowed:
            # More candidates than the compaction cap: refetch the full
            # [L, K] screen for this tile (rare).
            stats = screen_tile_for(tile, threshold_percent=threshold_percent)
        else:
            assert not (emit_ref or emit_no_call), (
                "compact screens only carry candidate rows"
            )
            counts_by_row = {
                int(r): stats.counts[i] for i, r in enumerate(stats.idx)
            }
            calls = []
            rows = np.union1d(
                stats.idx.astype(np.int64),
                np.nonzero(overflow_arr & (depth_arr > 0))[0],
            )
            for li in rows:
                li = int(li)
                row_counts = (
                    None if overflow_arr[li] else counts_by_row.get(li)
                )
                calls.extend(
                    _classify_tile_locus(
                        tile, li, int(depth_arr[li]), row_counts,
                        sample_name, sample_reads, source,
                        threshold_percent, emit_ref, emit_no_call,
                    )
                )
            return calls
    counts = stats.counts
    variant_evidence = stats.candidates
    calls: List[ThresholdCall] = []
    # Only loci flagged by the device screen (exact thresholded passing
    # rule) or needing the exact host fallback can produce output; with
    # emit flags set every covered locus can.
    active = depth_arr > 0
    if not (emit_ref or emit_no_call):
        evidence = np.asarray(variant_evidence).astype(bool)[: tile.L]
        active &= evidence | overflow_arr
    for li in np.nonzero(active)[0]:
        li = int(li)
        row_counts = None if tile.overflow[li] else counts[li]
        calls.extend(
            _classify_tile_locus(
                tile, li, int(depth_arr[li]), row_counts, sample_name,
                sample_reads, source, threshold_percent, emit_ref,
                emit_no_call,
            )
        )
    return calls


def _classify_tile_locus(
    tile: LocusTile,
    li: int,
    total: int,
    row_counts,
    sample_name: str,
    sample_reads,
    source,
    threshold_percent: int,
    emit_ref: bool,
    emit_no_call: bool,
) -> List[ThresholdCall]:
    """Classify one tile row from its device counts (row_counts, [K]) or,
    when row_counts is None (overflow row), via the exact host pileup."""
    locus = int(tile.loci[li])
    if row_counts is None:
        # Exact host fallback for >K-allele or >D-depth loci.
        if source is not None:
            pileup = source.pileup_at(tile.contig, locus)
        else:
            assert sample_reads is not None, (
                "overflow locus requires reads for exact host fallback"
            )
            pileup = Pileup.from_reads(sample_reads, tile.contig, locus)
        counts_map: Dict[Allele, int] = {}
        for e in pileup.elements:
            counts_map[e.allele] = counts_map.get(e.allele, 0) + 1
        alleles_and_counts = sorted(counts_map.items())
        total = pileup.depth
        reference_base = pileup.reference_base
    else:
        n = int(tile.num_alleles[li])
        alleles_and_counts = [
            (tile.alleles[li][k], int(row_counts[k])) for k in range(n)
        ]
        reference_base = int(tile.ref_base[li])
    return classify_locus(
        alleles_and_counts,
        total,
        reference_base,
        sample_name,
        tile.contig,
        locus,
        threshold_percent,
        emit_ref,
        emit_no_call,
    )


def call_variants(
    reads,
    loci_partitions: LociMap,
    threshold_percent: int = 8,
    emit_ref: bool = False,
    emit_no_call: bool = False,
    tile_size: int = 0,
    max_alleles: int = 8,
    reference_genome=None,
    mesh=None,
) -> List[ThresholdCall]:
    """Call variants over a loci partitioning (shard -> loci).

    reads: a list of MappedReads or a ReadSource (columnar or object).
    mesh: a jax.sharding.Mesh — when given, the device screens run ONE
    shard_map step per group of n_devices tiles (each chip screens its own
    tile; psum'd global counters) instead of sequential per-tile kernels.
    Output is identical by construction (pinned by
    tests/test_distributed_caller.py)."""
    from guacamole.callers.source import ReadSource

    from guacamole.ops.dispatch import pack_skip_nibbles

    source = (
        reads if isinstance(reads, ReadSource) else ReadSource.from_reads(reads)
    )
    skip_nib = pack_skip_nibbles(mesh)
    calls: List[ThresholdCall] = []
    inverse = loci_partitions.inverse_map()
    sample_sources = {
        name: source.for_sample(name) for name in source.sample_names()
    }

    def tiles():
        for task in sorted(inverse):
            task_loci = inverse[task]
            for sample_name, sample_source in sorted(sample_sources.items()):
                for contig in task_loci.contigs:
                    for tile in sample_source.iter_tiles(
                        contig,
                        task_loci.on_contig(contig),
                        tile_size=tile_size,
                        max_alleles=max_alleles,
                        reference_genome=reference_genome,
                        fields="screen",
                        skip_nibbles=skip_nib,
                    ):
                        yield tile, sample_name, sample_source

    calls.extend(
        _screen_and_classify(
            tiles(), threshold_percent, emit_ref, emit_no_call, mesh=mesh
        )
    )
    return calls


def _screen_and_classify(
    tile_items, threshold_percent, emit_ref, emit_no_call, mesh=None
) -> List[ThresholdCall]:
    """Pipelined execution over (tile, sample_name, source) items: launch
    the screen kernel for each packed tile immediately (JAX dispatch is
    async), classify once a bounded window of tiles is in flight, so host
    packing/classification overlaps the device kernels and the
    device->host copies. With a mesh, groups of n_devices tiles screen in
    ONE shard_map step each (one tile per chip). Returns calls in
    deterministic order."""
    from guacamole.ops.dispatch import prefetch_iter

    if mesh is not None:
        from guacamole.parallel.mesh import mesh_csr_screens

        screen_iter = mesh_csr_screens(
            prefetch_iter(tile_items, ahead=2),
            tile_of=lambda item: item[0],
            mesh=mesh,
            threshold_percent=threshold_percent,
        )
    else:
        screen_iter = pipelined_batched_screens(
            # Pack tiles on a background thread: the native packer releases
            # the GIL, so packing tile i+1 overlaps tile i's screen fetch +
            # classification.
            prefetch_iter(tile_items, ahead=2),
            tile_of=lambda item: item[0],
            threshold_percent=threshold_percent,
            # Variant-only runs read counts at candidate loci alone: compact
            # them on device so each tile's fetch is one small array.
            compact_cap=None if (emit_ref or emit_no_call) else COMPACT_CAP,
        )
    calls: List[ThresholdCall] = []
    for (tile, name, src), pending in screen_iter:
        calls.extend(
            call_tile(
                tile,
                name,
                threshold_percent,
                emit_ref,
                emit_no_call,
                source=src,
                pending=pending,
            )
        )
    # Deterministic emission order regardless of tile batching/bucketing.
    calls.sort(key=lambda c: (c.contig, c.start, c.sample_name, c.allele))
    return calls


def call_variants_streaming(
    path: str,
    filters,
    loci_partitions: LociMap,
    threshold_percent: int = 8,
    emit_ref: bool = False,
    emit_no_call: bool = False,
    tile_size: int = 0,
    max_alleles: int = 8,
    reference_genome=None,
    mesh=None,
) -> Optional[List[ThresholdCall]]:
    """Streaming variant: each partition task decodes only its own BAM
    byte ranges (.bai pushdown), with task i+1's IO + decode on a
    background thread while task i packs and screens. Identical output to
    load-then-call (pinned by tests). Returns None when streaming is
    unavailable (non-BAM input, no native runtime/index) — callers then
    use load_read_source + call_variants."""
    from guacamole.callers.streaming import iter_task_sources

    task_sources = iter_task_sources(path, filters, loci_partitions)
    if task_sources is None:
        return None
    from guacamole.ops.dispatch import pack_skip_nibbles

    skip_nib = pack_skip_nibbles(mesh)

    # One pipeline across ALL tasks: tiles from task i+1 keep the device
    # busy while task i's tail classifies, and each task's decode was
    # already prefetched on a background thread.
    def tiles():
        for task, task_loci, source in task_sources:
            sample_sources = {
                name: source.for_sample(name)
                for name in source.sample_names()
            }
            for sample_name, sample_source in sorted(
                sample_sources.items()
            ):
                for contig in task_loci.contigs:
                    for tile in sample_source.iter_tiles(
                        contig,
                        task_loci.on_contig(contig),
                        tile_size=tile_size,
                        max_alleles=max_alleles,
                        reference_genome=reference_genome,
                        fields="screen",
                        skip_nibbles=skip_nib,
                    ):
                        yield tile, sample_name, sample_source

    return _screen_and_classify(
        tiles(), threshold_percent, emit_ref, emit_no_call, mesh=mesh
    )
