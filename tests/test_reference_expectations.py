"""Full-CLI reference-expectation gates: the known positive/negative
somatic loci of the reference's SomaticStandardCallerSuite
(cf. upstream .../commands/SomaticStandardCallerSuite.scala:54-115)
and the germline-threshold #302 regression, asserted at the OUTPUT level —
VCF records with CHROM/POS/REF/ALT/GT/AD/DP/GQ — through the same CLI a
user runs. Unlike the self-golden snapshots (determinism gates), these
expectations are derived from the reference test suite, so they pin
end-to-end parity of the caller + filter stack + VCF FORMAT encoding."""

import os
import subprocess
import sys

import pytest

from conftest import resource_path

# Fixed algorithm parameters of the reference suite
# (SomaticStandardCallerSuite.scala:38-52).
SOMATIC_ARGS = [
    "--odds", "120",
    "--min-tumor-read-depth", "8",
    "--min-normal-read-depth", "4",
    "--max-tumor-read-depth", "200",
    "--min-tumor-alternate-read-depth", "3",
    "--min-vaf", "5",
    "--min-likelihood", "70",
]

STANDARD_BASES = set("ACGT")


def run_cli(args, timeout=600):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    result = subprocess.run(
        [sys.executable, "-m", "guacamole.cli"] + args,
        env=env, capture_output=True, text=True, timeout=timeout,
    )
    assert result.returncode == 0, result.stderr[-2000:]


def read_vcf_records(path):
    """{(chrom, pos_1based): (ref, alt, {format_key: value})} per record."""
    records = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            chrom, pos, _id, ref, alt = f[0], int(f[1]), f[2], f[3], f[4]
            fmt = dict(zip(f[8].split(":"), f[9].split(":")))
            records[(chrom, pos)] = (ref, alt, fmt)
    return records


def run_somatic(tmp_path, tumor, normal, name):
    out = str(tmp_path / f"{name}.vcf")
    run_cli(
        ["somatic-standard",
         "--tumor-reads", resource_path(tumor),
         "--normal-reads", resource_path(normal),
         "--out", out] + SOMATIC_ARGS,
    )
    return read_vcf_records(out)


def test_somatic_positive_loci_called_with_wellformed_records(tmp_path):
    """Every known-positive locus of the reference suite's 'simple positive
    variants' table must appear in the CLI's VCF with well-formed
    CHROM/POS/REF/ALT and GT/AD/DP/GQ fields
    (SomaticStandardCallerSuite.scala:83-90)."""
    records = run_somatic(
        tmp_path, "tumor.chr20.tough.sam", "normal.chr20.tough.sam", "tough"
    )
    positive_loci = [
        42999694, 25031215, 44061033, 45175149, 755754, 1843813,
        3555766, 3868620, 9896926, 14017900, 17054263, 35951019, 50472935,
        51858471, 58201903, 7087895, 19772181, 30430960, 32150541, 42186626,
        44973412, 46814443, 52311925, 53774355, 57280858, 62262870,
    ]
    for locus in positive_loci:
        key = ("20", locus + 1)  # VCF POS is 1-based
        assert key in records, f"expected somatic call at 20:{locus} missing"
        ref, alt, fmt = records[key]
        # simple SNV positives: single standard ref/alt bases, het call
        assert ref in STANDARD_BASES and alt in STANDARD_BASES, (locus, ref, alt)
        assert ref != alt
        assert fmt["GT"] == "0/1", (locus, fmt)
        ad = [int(x) for x in fmt["AD"].split(",")]
        dp = int(fmt["DP"])
        assert len(ad) == 2 and all(a > 0 for a in ad), (locus, fmt)
        assert sum(ad) <= dp, (locus, fmt)
        # the suite's minTumorAlternateReadDepth gate
        assert ad[1] >= 3, (locus, fmt)
        # GQ is phred-scaled likelihood, gated at --min-likelihood 70
        assert int(fmt["GQ"]) >= 70, (locus, fmt)


def test_somatic_negative_loci_not_called_syn1(tmp_path):
    """Known false-positive loci of syn1 must NOT be called
    (SomaticStandardCallerSuite.scala:92-100)."""
    records = run_somatic(
        tmp_path,
        "synthetic.challenge.set1.tumor.v2.withMDTags.chr2.syn1fp.sam",
        "synthetic.challenge.set1.normal.v2.withMDTags.chr2.syn1fp.sam",
        "syn1fp",
    )
    for locus in [216094721, 3529313, 8789794, 104043280, 104175801,
                  126651101, 241901237, 57270796, 120757852]:
        assert ("2", locus + 1) not in records, (
            f"false positive called at 2:{locus}"
        )


def test_somatic_complex_region_loci(tmp_path):
    """Complex-region expectations: the listed negatives absent AND the two
    positives present (SomaticStandardCallerSuite.scala:102-111)."""
    records = run_somatic(
        tmp_path,
        "synthetic.challenge.set1.tumor.v2.withMDTags.chr2.complexvar.sam",
        "synthetic.challenge.set1.normal.v2.withMDTags.chr2.complexvar.sam",
        "complexvar",
    )
    for locus in [148487667, 134307261, 90376213, 3638733, 109347468]:
        assert ("2", locus + 1) not in records, (
            f"false positive called at 2:{locus}"
        )
    for locus in [82949713, 130919744]:
        key = ("2", locus + 1)
        assert key in records, f"expected somatic call at 2:{locus} missing"
        _ref, _alt, fmt = records[key]
        assert fmt["GT"] == "0/1"
        assert int(fmt["AD"].split(",")[1]) >= 3


def test_somatic_difficult_negative_loci(tmp_path):
    """'difficult negative variants' on the simplefp pair
    (SomaticStandardCallerSuite.scala:113-118)."""
    records = run_somatic(
        tmp_path, "tumor.chr20.simplefp.sam", "normal.chr20.simplefp.sam",
        "simplefp",
    )
    for locus in [26211835, 29652479, 54495768, 13046318, 25939088]:
        assert ("20", locus + 1) not in records, (
            f"false positive called at 20:{locus}"
        )


def test_germline_threshold_het_deletion_regression(tmp_path):
    """hammerlab/guacamole#302: the heterozygous-deletion scenario at
    2:16050070 must not produce a call through the full CLI
    (GermlineThresholdCallerSuite.scala:104-113)."""
    out = str(tmp_path / "g302.vcf")
    run_cli(
        ["germline-threshold",
         "--reads",
         resource_path(
             "synthetic.challenge.set1.normal.v2.withMDTags.chr2.syn1fp.sam"
         ),
         "--threshold", "8",
         "--out", out],
    )
    records = read_vcf_records(out)
    assert ("2", 16050071) not in records
