"""Mesh-distributed caller equivalence: the shard_map'd screens over the
8-device CPU mesh must produce exactly the sequential callers' calls, for
all three main callers (threshold / germline-standard / somatic)."""

import jax
import pytest

from guacamole.callers.distributed import (
    call_somatic_mesh,
    call_standard_mesh,
    call_variants_mesh,
)
from guacamole.callers.germline_standard import (
    call_variants as call_standard,
)
from guacamole.callers.germline_threshold import call_variants
from guacamole.callers.somatic_standard import (
    call_variants as call_somatic,
)
from guacamole.gio.load import load_read_set
from guacamole.loci.lociset import parse_loci
from guacamole.loci.partition import partition_loci_uniformly
from guacamole.parallel.mesh import loci_mesh
from guacamole.reads.read import InputFilters

from conftest import resource_path


@pytest.fixture(scope="module")
def chrm_reads(resources_dir):
    filters = InputFilters.create(
        overlaps_loci=parse_loci("chrM:0-5000"),
        non_duplicate=True,
        has_mdtag=True,
    )
    return load_read_set(resource_path("chrM.sorted.bam"), filters).mapped_reads


def key(calls):
    return sorted((c.contig, c.start, c.allele, c.labels) for c in calls)


@pytest.mark.parametrize("tasks", [1, 8])
def test_mesh_caller_matches_sequential(chrm_reads, tasks):
    loci = parse_loci("chrM:0-5000").result()
    partitions = partition_loci_uniformly(tasks, loci)
    mesh = loci_mesh(jax.devices()[:8])
    sequential = call_variants(chrm_reads, partitions, tile_size=1024)
    distributed = call_variants_mesh(
        chrm_reads, partitions, tile_size=1024, mesh=mesh
    )
    assert key(distributed) == key(sequential)
    assert len(distributed) > 0


def test_mesh_caller_small_mesh(chrm_reads):
    loci = parse_loci("chrM:1000-2000").result()
    partitions = partition_loci_uniformly(2, loci)
    mesh = loci_mesh(jax.devices()[:2])
    sequential = call_variants(chrm_reads, partitions, tile_size=512)
    distributed = call_variants_mesh(
        chrm_reads, partitions, tile_size=512, mesh=mesh
    )
    assert key(distributed) == key(sequential)


@pytest.mark.parametrize("tasks", [1, 8])
def test_mesh_standard_matches_sequential(chrm_reads, tasks):
    loci = parse_loci("chrM:0-5000").result()
    partitions = partition_loci_uniformly(tasks, loci)
    mesh = loci_mesh(jax.devices()[:8])
    sequential = call_standard(
        chrm_reads, partitions, min_alignment_quality=1, tile_size=1024
    )
    distributed = call_standard_mesh(
        chrm_reads,
        partitions,
        min_alignment_quality=1,
        tile_size=1024,
        mesh=mesh,
    )

    def skey(calls):
        return [
            (c.reference_contig, c.start, c.allele, c.evidence)
            for c in calls
        ]

    assert skey(distributed) == skey(sequential)
    assert len(distributed) > 0


def test_mesh_somatic_matches_sequential(resources_dir):
    filters = InputFilters.create(
        overlaps_loci=parse_loci("all"),
        non_duplicate=True,
        passed_vendor_quality_checks=True,
        has_mdtag=True,
    )
    tumor = load_read_set(
        resource_path("tumor.chr20.tough.sam"), filters
    ).mapped_reads
    normal = load_read_set(
        resource_path("normal.chr20.tough.sam"), filters
    ).mapped_reads
    starts = [r.start for r in tumor + normal]
    loci = parse_loci(
        "20:%d-%d" % (min(starts), max(r.end for r in tumor + normal))
    ).result()
    partitions = partition_loci_uniformly(4, loci)
    mesh = loci_mesh(jax.devices()[:8])
    sequential = call_somatic(
        tumor, normal, partitions, odds_threshold=120, tile_size=1024
    )
    distributed = call_somatic_mesh(
        tumor,
        normal,
        partitions,
        odds_threshold=120,
        tile_size=1024,
        mesh=mesh,
    )

    def skey(calls):
        return [
            (
                c.reference_contig,
                c.start,
                c.allele,
                c.somatic_log_odds,
                c.tumor_variant_evidence,
                c.normal_reference_evidence,
            )
            for c in calls
        ]

    assert skey(distributed) == skey(sequential)
    assert len(distributed) > 0


def test_mesh_variant_support_and_vaf_equal_sequential(resources_dir):
    """The analytics tools' counting screens on the 8-device mesh must
    equal the sequential path (one shard_map step per tile group)."""
    import jax

    from guacamole.callers.common import load_read_source
    from guacamole.callers.variant_support import (
        loci_from_variants,
        pileup_allele_counts,
    )
    from guacamole.callers.vaf_histogram import variant_loci_from_reads
    from guacamole.loci.lociset import parse_loci
    from guacamole.loci.partition import partition_loci_uniformly
    from guacamole.parallel.mesh import loci_mesh
    from guacamole.reads.read import InputFilters

    mesh = loci_mesh(jax.devices()[:8])

    vs_loci = loci_from_variants(resource_path("truth.chr20.vcf"))
    source, _ = load_read_source(
        resource_path("gatk_mini_bundle_extract.bam"), InputFilters.empty
    )
    seq = pileup_allele_counts(source, vs_loci, tile_size=512)
    on_mesh = pileup_allele_counts(source, vs_loci, tile_size=512, mesh=mesh)
    assert [str(c) for c in on_mesh] == [str(c) for c in seq]
    assert len(seq) > 0

    chrm, lengths = load_read_source(
        resource_path("chrM.sorted.bam"), InputFilters.empty
    )
    loci = parse_loci("chrM:0-16571").result(lengths)
    partitions = partition_loci_uniformly(3, loci)
    seq_v = variant_loci_from_reads(chrm, partitions, tile_size=512)
    mesh_v = variant_loci_from_reads(chrm, partitions, tile_size=512, mesh=mesh)
    assert mesh_v == seq_v
    assert len(seq_v) > 0
