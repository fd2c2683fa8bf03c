"""Mesh-distributed calling: the production multi-chip execution path.

Each caller's device screen runs ONE shard_map step per group of
n_devices tiles (each chip screens its own loci shard's tile; only psum'd
global counters cross devices), replacing the reference's Spark task
scheduling (cf. upstream .../DistributedUtil.scala:288-364: the
pileupFlatMap family serving every caller through one distributed
engine). Host-side classification / exact-f64 confirmation is unchanged,
so mesh output is identical to the sequential path by construction (and
by tests/test_distributed_caller.py).

These wrappers delegate to the callers' own `mesh=` parameter — the mesh
path lives inside each caller (wired from the CLI via --mesh), not in a
separate engine; this module is the stable API for tests and tools.
"""

from __future__ import annotations

from typing import List

from guacamole.callers import germline_standard, germline_threshold
from guacamole.callers import somatic_standard
from guacamole.callers.germline_threshold import ThresholdCall
from guacamole.loci.locimap import LociMap
from guacamole.parallel.mesh import loci_mesh


def call_variants_mesh(
    reads,
    loci_partitions: LociMap,
    threshold_percent: int = 8,
    emit_ref: bool = False,
    emit_no_call: bool = False,
    tile_size: int = 4096,
    max_alleles: int = 8,
    reference_genome=None,
    mesh=None,
) -> List[ThresholdCall]:
    """germline-threshold over a device mesh (one tile per chip per step)."""
    return germline_threshold.call_variants(
        reads,
        loci_partitions,
        threshold_percent=threshold_percent,
        emit_ref=emit_ref,
        emit_no_call=emit_no_call,
        tile_size=tile_size,
        max_alleles=max_alleles,
        reference_genome=reference_genome,
        mesh=mesh if mesh is not None else loci_mesh(),
    )


def call_standard_mesh(
    reads,
    loci_partitions: LociMap,
    min_alignment_quality: int = 0,
    emit_ref: bool = False,
    tile_size: int = 4096,
    max_alleles: int = 8,
    reference_genome=None,
    mesh=None,
):
    """germline-standard over a device mesh: the f32 genotype-likelihood
    screen runs under shard_map; exact f64 confirm on host per shard."""
    return germline_standard.call_variants(
        reads,
        loci_partitions,
        min_alignment_quality=min_alignment_quality,
        emit_ref=emit_ref,
        tile_size=tile_size,
        max_alleles=max_alleles,
        reference_genome=reference_genome,
        mesh=mesh if mesh is not None else loci_mesh(),
    )


def call_somatic_mesh(
    tumor_reads,
    normal_reads,
    loci_partitions: LociMap,
    odds_threshold: int = 20,
    min_alignment_quality: int = 1,
    filter_multi_allelic: bool = False,
    max_read_depth: int = 2**31 - 1,
    tile_size: int = 4096,
    max_alleles: int = 8,
    reference_genome=None,
    mesh=None,
):
    """somatic-standard over a device mesh: the alignment-included tumor
    screen runs under shard_map (tumor/normal stay a host-side pair — the
    exact confirm packs both samples' sparse tiles per shard, the analog of
    the two-sample tile axis in DistributedUtil.scala:316-364)."""
    return somatic_standard.call_variants(
        tumor_reads,
        normal_reads,
        loci_partitions,
        odds_threshold=odds_threshold,
        min_alignment_quality=min_alignment_quality,
        filter_multi_allelic=filter_multi_allelic,
        max_read_depth=max_read_depth,
        tile_size=tile_size,
        max_alleles=max_alleles,
        reference_genome=reference_genome,
        mesh=mesh if mesh is not None else loci_mesh(),
    )
