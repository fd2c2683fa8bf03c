"""Multi-host input sharding: each host loads ONLY its loci shard's reads
(BAM-index byte-range pushdown), packs and calls locally; the union of
per-host calls must equal a single whole-file run.

This is the cross-host half of the distribution model (the cross-chip half
is tests/test_distributed_caller.py): no read crosses hosts — boundary
reads are fetched by both hosts via overlapping index queries (halo
duplication at the input layer)."""

import pytest

from guacamole.callers.germline_threshold import call_variants
from guacamole.callers.germline_standard import (
    call_variants as call_standard,
)
from guacamole.gio.load import load_read_set
from guacamole.loci.lociset import parse_loci
from guacamole.loci.partition import partition_loci_uniformly
from guacamole.reads.read import InputFilters

from conftest import resource_path

CHRM = "chrM.sorted.bam"


def host_shards(n_hosts, total=16570):
    """Uniform loci shards, as the whole-genome partitioner would assign."""
    loci = parse_loci(f"chrM:0-{total}").result()
    partitions = partition_loci_uniformly(n_hosts, loci)
    return [partitions.inverse_map()[h] for h in range(n_hosts)]


def load_for_shard(shard_loci):
    """What one host loads: only reads overlapping its loci shard (the
    index-backed region query)."""
    contig = shard_loci.contigs[0]
    ranges = shard_loci.on_contig(contig).ranges
    expr = ",".join(f"{contig}:{s}-{e}" for s, e in ranges)
    filters = InputFilters.create(
        overlaps_loci=parse_loci(expr), non_duplicate=True, has_mdtag=True
    )
    return load_read_set(resource_path(CHRM), filters).mapped_reads


@pytest.mark.parametrize("n_hosts", [2, 3])
def test_per_host_threshold_calls_union_equals_whole_run(
    resources_dir, n_hosts
):
    shards = host_shards(n_hosts)

    per_host_calls = []
    for shard_loci in shards:
        reads = load_for_shard(shard_loci)
        partitions = partition_loci_uniformly(1, shard_loci)
        per_host_calls.extend(call_variants(reads, partitions))

    whole_filters = InputFilters.create(
        overlaps_loci=parse_loci("chrM:0-16570"),
        non_duplicate=True,
        has_mdtag=True,
    )
    whole_reads = load_read_set(resource_path(CHRM), whole_filters).mapped_reads
    whole_partitions = partition_loci_uniformly(
        n_hosts, parse_loci("chrM:0-16570").result()
    )
    whole_calls = call_variants(whole_reads, whole_partitions)

    def key(calls):
        return sorted((c.contig, c.start, c.allele, c.labels) for c in calls)

    assert key(per_host_calls) == key(whole_calls)
    assert len(whole_calls) > 0


def test_per_host_standard_calls_union_equals_whole_run(resources_dir):
    shards = host_shards(2, total=4000)
    per_host = []
    for shard_loci in shards:
        reads = load_for_shard(shard_loci)
        partitions = partition_loci_uniformly(1, shard_loci)
        per_host.extend(call_standard(reads, partitions, min_alignment_quality=1))

    whole_filters = InputFilters.create(
        overlaps_loci=parse_loci("chrM:0-4000"),
        non_duplicate=True,
        has_mdtag=True,
    )
    whole_reads = load_read_set(resource_path(CHRM), whole_filters).mapped_reads
    whole = call_standard(
        whole_reads,
        partition_loci_uniformly(2, parse_loci("chrM:0-4000").result()),
        min_alignment_quality=1,
    )

    def key(calls):
        return sorted(
            (c.reference_contig, c.start, c.allele, c.evidence.likelihood)
            for c in calls
        )

    assert key(per_host) == key(whole)
    assert len(whole) > 0


def test_per_host_pushdown_decode_union_equals_whole_run(tmp_path):
    """Production multi-host input path: each host decodes ONLY its shard's
    BGZF chunks natively (.bai pushdown), packs columnar, calls; the union
    must equal a whole-file columnar run."""
    import shutil

    from guacamole.callers.common import bai_chunks_for_loci
    from guacamole.callers.source import ReadSource
    from guacamole.gio.bai import build_bam_index
    from guacamole.runtime.columnar import (
        decode_bam_columnar,
        filter_columnar,
        native_available,
    )

    if not native_available():
        pytest.skip("native runtime not built")

    dst = str(tmp_path / CHRM)
    shutil.copy(resource_path(CHRM), dst)
    build_bam_index(dst)

    n_hosts = 2
    shards = host_shards(n_hosts)
    per_host_calls = []
    for shard_loci in shards:
        contig = shard_loci.contigs[0]
        ranges = shard_loci.on_contig(contig).ranges
        expr = ",".join(f"{contig}:{s}-{e}" for s, e in ranges)
        builder = parse_loci(expr)
        chunks = bai_chunks_for_loci(dst, builder)
        cols = decode_bam_columnar(dst, chunks=chunks)
        assert cols is not None
        loci_set = builder.result(cols.contig_lengths)
        cols = filter_columnar(
            cols, loci_set=loci_set, non_duplicate=True, has_mdtag=True
        )
        partitions = partition_loci_uniformly(1, shard_loci)
        per_host_calls.extend(
            call_variants(ReadSource.from_columnar(cols), partitions)
        )

    whole = decode_bam_columnar(dst)
    loci_set = parse_loci("chrM:0-16570").result(whole.contig_lengths)
    whole_cols = filter_columnar(
        whole, loci_set=loci_set, non_duplicate=True, has_mdtag=True
    )
    whole_calls = call_variants(
        ReadSource.from_columnar(whole_cols),
        partition_loci_uniformly(n_hosts, parse_loci("chrM:0-16570").result()),
    )

    def key(calls):
        return sorted((c.contig, c.start, c.allele, c.labels) for c in calls)

    assert key(per_host_calls) == key(whole_calls)
    assert len(whole_calls) > 0


def test_load_shards_prefers_newest_run(tmp_path):
    """Stale shard files from an earlier differently-sized failed run
    against the same --out must lose to the NEWEST run's files, whether
    the stale run was larger or smaller."""
    import os
    import time

    from guacamole.parallel.multihost import (
        load_shards,
        persist_shard,
        shard_dir,
    )

    out = str(tmp_path / "calls.vcf")
    # Older, larger failed run: 2 of 4 shards persisted.
    persist_shard(out, 0, 4, ["old-a"])
    persist_shard(out, 2, 4, ["old-b"])
    # Backdate them, then a newer 2-process run persists one shard.
    for name in os.listdir(shard_dir(out)):
        p = os.path.join(shard_dir(out), name)
        os.utime(p, (time.time() - 3600, time.time() - 3600))
    persist_shard(out, 1, 2, ["new"])
    count, have = load_shards(out)
    assert count == 2
    assert have == {1: ["new"]}
