"""Streaming (.bai-pushdown) paths for germline-standard and
somatic-standard, plus index-depth-balanced streaming partitions: each
must produce calls identical to the whole-file load path.

Together with tests/test_germline_threshold.py::test_streaming_matches_
whole_file, this pins VERDICT items #7 (depth-balanced streaming) and #9
(streaming for all callers). Match: per-task BAM-index pushdown
(upstream .../reads/Read.scala:395-406) under the reference's
default depth-balanced partitioning (DistributedUtil.scala:41-48)."""

import os
import tempfile

import numpy as np
import pytest

from conftest import resource_path

CHRM = "chrM.sorted.bam"
GATK = "gatk_mini_bundle_extract.bam"


@pytest.fixture()
def cache_dir():
    with tempfile.TemporaryDirectory() as cache:
        os.environ["GUAC_CACHE_DIR"] = cache
        try:
            yield cache
        finally:
            del os.environ["GUAC_CACHE_DIR"]


def _filters(expr="all"):
    from guacamole.loci.lociset import parse_loci
    from guacamole.reads.read import InputFilters

    return InputFilters.create(
        overlaps_loci=parse_loci(expr), non_duplicate=True, has_mdtag=True
    )


def test_index_depth_partitions_cover_loci_and_balance(cache_dir):
    """Index-depth-balanced partitions must cover the loci set exactly,
    and weight tasks by byte density (not loci length)."""
    from guacamole.callers.streaming import ensure_bam_index
    from guacamole.gio.bam import BamFile
    from guacamole.loci.lociset import parse_loci
    from guacamole.loci.partition import partition_loci_by_index_depth

    path = resource_path(CHRM)
    bai = ensure_bam_index(path)
    assert bai is not None
    lengths = dict(BamFile(path).references)
    loci = parse_loci("all").result(lengths)
    partitions = partition_loci_by_index_depth(4, loci, 250, path, bai)
    assert partitions.count == loci.count
    inverse = partitions.inverse_map()
    assert sum(s.count for s in inverse.values()) == loci.count
    assert len(inverse) >= 2  # multiple tasks actually got loci


def test_streaming_standard_matches_whole_file(cache_dir):
    from guacamole.callers.common import load_read_source
    from guacamole.callers.germline_standard import (
        call_variants,
        call_variants_streaming,
    )
    from guacamole.loci.lociset import parse_loci
    from guacamole.loci.partition import partition_loci_uniformly

    filters = _filters()
    path = resource_path(CHRM)
    source, contig_lengths = load_read_source(path, filters)
    loci = parse_loci("all").result(contig_lengths)
    partitions = partition_loci_uniformly(3, loci)
    want = call_variants(source, partitions, min_alignment_quality=1)
    got = call_variants_streaming(
        path, filters, partitions, min_alignment_quality=1
    )
    assert got is not None and len(want) > 0

    def keys(calls):
        return [
            (c.reference_contig, c.start, c.sample_name, c.allele,
             c.evidence.likelihood)
            for c in calls
        ]

    assert keys(got) == keys(want)


def test_streaming_standard_depth_balanced_partitions(cache_dir):
    """Streaming with INDEX-depth-balanced partitions (the new default
    configuration) must still equal the whole-file run — partitioning is
    load balance only, never semantics."""
    from guacamole.callers.common import load_read_source
    from guacamole.callers.germline_standard import (
        call_variants,
        call_variants_streaming,
    )
    from guacamole.callers.streaming import ensure_bam_index
    from guacamole.loci.lociset import parse_loci
    from guacamole.loci.partition import (
        partition_loci_by_index_depth,
        partition_loci_uniformly,
    )

    filters = _filters()
    path = resource_path(CHRM)
    bai = ensure_bam_index(path)
    source, contig_lengths = load_read_source(path, filters)
    loci = parse_loci("all").result(contig_lengths)
    balanced = partition_loci_by_index_depth(3, loci, 250, path, bai)
    want = call_variants(
        source, partition_loci_uniformly(1, loci), min_alignment_quality=1
    )
    got = call_variants_streaming(
        path, filters, balanced, min_alignment_quality=1
    )
    assert got is not None and len(want) > 0

    def keys(calls):
        return [
            (c.reference_contig, c.start, c.sample_name, c.allele)
            for c in calls
        ]

    assert keys(got) == keys(want)


def test_streaming_somatic_matches_whole_file(cache_dir):
    """Somatic streaming: both samples decode per task. With the same
    file as tumor and normal, no somatic call can survive (normal carries
    every tumor variant), but the full screen -> sparse-confirm pipeline
    runs; the streaming and whole-file paths must agree exactly."""
    from guacamole.callers.common import load_read_source
    from guacamole.callers.somatic_standard import (
        call_variants,
        call_variants_streaming,
    )
    from guacamole.loci.lociset import parse_loci
    from guacamole.loci.partition import partition_loci_uniformly

    filters = _filters()
    path = resource_path(GATK)
    tumor, contig_lengths = load_read_source(path, filters)
    normal, _ = load_read_source(path, filters)
    loci = parse_loci("all").result(contig_lengths)
    partitions = partition_loci_uniformly(2, loci)
    want = call_variants(
        tumor, normal, partitions, min_alignment_quality=1
    )
    got = call_variants_streaming(
        path, path, filters, partitions, min_alignment_quality=1
    )
    assert got is not None

    def keys(calls):
        return [(c.reference_contig, c.start, c.allele) for c in calls]

    assert keys(got) == keys(want)


def test_cli_default_config_streams(cache_dir, tmp_path, capsys):
    """The DEFAULT CLI configuration (depth-balanced, accuracy 250) must
    take the streaming path for BAM inputs — no whole-file load message —
    and produce the golden calls."""
    from guacamole.cli import main

    out = tmp_path / "out.vcf"
    rc = main(
        [
            "germline-threshold",
            "--reads",
            resource_path(CHRM),
            "--loci",
            "chrM:0-16571",
            "--parallelism",
            "3",
            "--out",
            str(out),
        ]
    )
    assert rc == 0
    err = capsys.readouterr().err
    assert "Loaded" not in err  # the whole-file load path logs "Loaded..."
    records = [
        line for line in out.read_text().splitlines()
        if not line.startswith("#")
    ]
    assert len(records) == 138  # golden chrM call count


def test_compare_vcf_records(tmp_path):
    """The record-level VCF comparator (concordance.compare_vcf_records):
    identical call sets with different headers/QUAL compare equal; any
    CHROM/POS/REF/ALT/GT difference is surfaced; GT order is normalized."""
    from guacamole.concordance import compare_vcf_records

    a = tmp_path / "a.vcf"
    b = tmp_path / "b.vcf"
    a.write_text(
        "##fileformat=VCFv4.1\n##source=ours\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n"
        "chrM\t5\t.\tC\tT\t.\t.\t.\tGT:DP\t0/1:10\n"
        "chrM\t9\t.\tA\tG\t.\t.\t.\tGT:DP\t1/1:12\n"
    )
    b.write_text(
        "##fileformat=VCFv4.1\n##source=adam-0.16\n##extra=header\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n"
        "chrM\t5\t.\tC\tT\t99\t.\tDB\tGT:DP\t1|0:44\n"
        "chrM\t9\t.\tA\tG\t.\t.\t.\tGT:DP\t1/1:12\n"
    )
    cmp1 = compare_vcf_records(str(a), str(b))
    assert cmp1.record_level_identical and cmp1.matching == 2

    c = tmp_path / "c.vcf"
    c.write_text(
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n"
        "chrM\t5\t.\tC\tT\t.\t.\t.\tGT\t0/1\n"
        "chrM\t9\t.\tA\tC\t.\t.\t.\tGT\t1/1\n"
    )
    cmp2 = compare_vcf_records(str(a), str(c))
    assert not cmp2.record_level_identical
    assert cmp2.matching == 1
    assert cmp2.only_a == (("chrM", 9, "A", "G", "1/1"),)
    assert cmp2.only_b == (("chrM", 9, "A", "C", "1/1"),)
