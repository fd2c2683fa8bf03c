#!/usr/bin/env python
"""Measured in-repo baseline: the pure-Python oracle path, end-to-end.

The reference publishes no performance numbers and this environment has
no JVM, so the only *measurable* baseline is this repo's own oracle
implementation of the reference's semantics: pure-Python read objects,
per-locus object Pileups walked by the sliding-window engine
(engine.pileup_flat_map — the pileupFlatMap analog), scalar exact-f64
likelihoods, object filter stacks, VCF writer. Single thread, no tiles,
no device, no native decode — the same work the reference's Scala code
does per locus, minus the JVM/Spark startup.

Each config reproduces the corresponding bench config's CLI semantics
and asserts byte-identity against the committed golden VCF, so the
baseline time measures CORRECT work.

Prints one JSON object: {config: {wall_s, n_reads, golden_match}}.
"""

import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
RESOURCES = "/root/reference/src/test/resources"
GOLDEN = os.path.join(REPO, "tests", "golden")
INT_MAX = 2**31 - 1


def _load(path, parse_loci, vendor_checks=False):
    from guacamole.gio.load import load_read_set
    from guacamole.reads.read import InputFilters

    filters = InputFilters.create(
        overlaps_loci=parse_loci("all"),
        non_duplicate=True,
        passed_vendor_quality_checks=vendor_checks,
        has_mdtag=True,
    )
    rs = load_read_set(path, filters)
    reads = sorted(rs.mapped_reads, key=lambda r: (r.reference_contig, r.start))
    return reads, rs.contig_lengths


def _write_and_check(records, contig_lengths, golden_name, tmp):
    from guacamole.callers.common import write_variants

    out = os.path.join(tmp, golden_name)
    write_variants(records, out, contig_lengths=contig_lengths)
    with open(out, "rb") as fh, open(
        os.path.join(GOLDEN, golden_name), "rb"
    ) as gh:
        return fh.read() == gh.read()


def run_germline_threshold(tmp):
    from guacamole.callers.germline_threshold import call_variants_at_locus
    from guacamole.engine import pileup_flat_map
    from guacamole.loci.lociset import parse_loci
    from guacamole.loci.partition import partition_loci_uniformly

    t0 = time.time()
    reads, lengths = _load(
        os.path.join(RESOURCES, "chrM.sorted.bam"), parse_loci
    )
    loci = parse_loci("all").result(lengths)
    partitions = partition_loci_uniformly(2, loci)
    calls = pileup_flat_map(
        reads,
        partitions,
        True,
        lambda p: call_variants_at_locus(
            p, 8, emit_ref=False, emit_no_call=False
        ),
    )
    records = [c.to_vcf_record() for c in calls]
    ok = _write_and_check(
        records, lengths, "chrM.germline-threshold.vcf", tmp
    )
    return {
        "wall_s": round(time.time() - t0, 2),
        "n_reads": len(reads),
        "golden_match": ok,
    }


def run_germline_standard(tmp):
    from guacamole.callers.germline_standard import (
        call_variants_at_locus,
        called_allele_to_vcf_record,
    )
    from guacamole.engine import pileup_flat_map
    from guacamole.filters.genotype_filters import apply_genotype_filters
    from guacamole.loci.lociset import parse_loci
    from guacamole.loci.partition import partition_loci_uniformly

    t0 = time.time()
    reads, lengths = _load(
        os.path.join(RESOURCES, "chrM.sorted.bam"), parse_loci
    )
    loci = parse_loci("all").result(lengths)
    partitions = partition_loci_uniformly(2, loci)
    calls = pileup_flat_map(
        reads,
        partitions,
        True,
        lambda p: call_variants_at_locus(p, min_alignment_quality=1),
    )
    filtered = apply_genotype_filters(
        calls,
        min_read_depth=0,
        max_read_depth=INT_MAX,
        min_alternate_read_depth=0,
        min_likelihood=0,
    )
    records = [called_allele_to_vcf_record(c) for c in filtered]
    ok = _write_and_check(records, lengths, "chrM.germline-standard.vcf", tmp)
    return {
        "wall_s": round(time.time() - t0, 2),
        "n_reads": len(reads),
        "golden_match": ok,
    }


def run_somatic_standard(tmp):
    from guacamole.callers.somatic_standard import (
        called_somatic_allele_to_vcf_record,
        find_potential_variant_at_locus,
    )
    from guacamole.engine import pileup_flat_map_two
    from guacamole.filters.somatic_filters import (
        apply_somatic_filters,
        somatic_minimum_alternate_read_depth,
        somatic_within_read_depth_range,
    )
    from guacamole.loci.lociset import parse_loci
    from guacamole.loci.partition import partition_loci_uniformly

    t0 = time.time()
    tumor, t_lengths = _load(
        os.path.join(RESOURCES, "tumor.chr20.tough.sam"), parse_loci,
        vendor_checks=True,
    )
    normal, n_lengths = _load(
        os.path.join(RESOURCES, "normal.chr20.tough.sam"), parse_loci,
        vendor_checks=True,
    )
    loci = parse_loci("all").result(t_lengths)
    partitions = partition_loci_uniformly(2, loci)
    potential = pileup_flat_map_two(
        tumor,
        normal,
        partitions,
        True,
        lambda tp, np_: find_potential_variant_at_locus(
            tp, np_, 120, min_alignment_quality=1,
            filter_multi_allelic=False, max_read_depth=200,
        ),
    )
    potential = [
        g
        for g in potential
        if somatic_within_read_depth_range(g, 8, 200, 4)
    ]
    potential = [
        g for g in potential if somatic_minimum_alternate_read_depth(g, 3)
    ]
    filtered = apply_somatic_filters(
        potential,
        min_tumor_read_depth=8,
        max_tumor_read_depth=200,
        min_normal_read_depth=4,
        min_tumor_alternate_read_depth=3,
        min_log_odds=0,
        min_likelihood=70,
        min_vaf=5,
        min_average_mapping_quality=0,
        min_average_base_quality=0,
        maximum_median_mismatches=INT_MAX,
    )
    records = [called_somatic_allele_to_vcf_record(c) for c in filtered]
    ok = _write_and_check(records, n_lengths, "chr20.somatic-standard.vcf", tmp)
    return {
        "wall_s": round(time.time() - t0, 2),
        "n_reads": len(tumor) + len(normal),
        "golden_match": ok,
    }


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")  # oracle never uses jax
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out["germline-threshold-chrM"] = run_germline_threshold(tmp)
        out["germline-standard-chrM"] = run_germline_standard(tmp)
        out["somatic-standard-chr20"] = run_somatic_standard(tmp)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
