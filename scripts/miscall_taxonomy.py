"""Characterize scale-simulator miscalls (round-4 VERDICT item 3).

For every false positive / false negative of the germline-standard scale
run and every germline-contaminated somatic call, replay the locus
through the EXACT per-pileup oracle (the reference semantics:
germline_standard.call_variants_at_locus /
somatic find_potential_variant_at_locus,
cf. upstream .../commands/GermlineStandardCaller.scala:90-124 and
SomaticStandardCaller.scala:162-245) and classify:

  oracle-agrees  — the exact reference semantics produce the same
                   (mis)call on this fixture: not a pipeline defect.
                   Sub-classified by mechanism (error-flip het at depth,
                   band-edge depth transition, indel-shadow).
  divergence     — the pipeline's screen/confirm called differently from
                   the oracle at this locus: a real defect.

Output: one JSON object on stdout (taxonomy + counts), consumed manually
and summarized in BENCH_REPORT/docs. Runs host-side (JAX_PLATFORMS=cpu).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

SCALE_DIR = os.path.join(REPO, ".bench_scale")


def read_vcf_snvs(path):
    """{(contig, pos0): (ref, alt)} — 0-based, matching the simulator's
    truth positions (VCF POS is 1-based)."""
    out = {}
    for line in open(path):
        if line.startswith("#"):
            continue
        f = line.rstrip("\n").split("\t")
        if len(f[3]) == 1 and len(f[4]) == 1:
            out[(f[0], int(f[1]) - 1)] = (f[3], f[4])
    return out


def band_distance(pos, bands):
    """bp distance to the nearest coverage-band boundary on deep1m."""
    edges = [
        bands["band"][0], bands["band"][1],
        bands["spike"][0], bands["spike"][1],
    ]
    return min(abs(pos - e) for e in edges)


def main():
    from guacamole.platform import configure_platform

    configure_platform()
    from guacamole.callers.germline_standard import (
        call_variants_at_locus,
    )
    from guacamole.callers.somatic_standard import (
        find_potential_variant_at_locus,
    )
    from guacamole.callers.source import ReadSource
    from guacamole.filters.genotype_filters import (
        apply_genotype_filters,
    )
    from guacamole.runtime.columnar import decode_bam_columnar
    from guacamole.utils.simulate import make_scale_fixture

    manifest = make_scale_fixture(SCALE_DIR)
    truth = manifest["truth"]
    bands = manifest["bands"]
    germ_bam = os.path.join(SCALE_DIR, manifest["files"]["germline_bam"])
    tumor_bam = os.path.join(SCALE_DIR, manifest["files"]["tumor_bam"])
    normal_bam = os.path.join(SCALE_DIR, manifest["files"]["normal_bam"])

    tmp = tempfile.mkdtemp()
    gs_vcf = os.path.join(tmp, "gs.vcf")
    som_vcf = os.path.join(tmp, "som.vcf")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run(
        [sys.executable, "-m", "guacamole.cli", "germline-standard",
         "--reads", germ_bam, "--min-likelihood", "40", "--out", gs_vcf],
        check=True, env=env, capture_output=True, timeout=900,
    )
    subprocess.run(
        [sys.executable, "-m", "guacamole.cli", "somatic-standard",
         "--tumor-reads", tumor_bam, "--normal-reads", normal_bam,
         "--odds", "20", "--out", som_vcf],
        check=True, env=env, capture_output=True, timeout=900,
    )

    planted = {
        (contig, int(p)): alt
        for contig in ("deep1m", "shallow8m")
        for p, alt in zip(
            truth[contig]["snv_pos"], truth[contig]["snv_alt"]
        )
    }
    called = read_vcf_snvs(gs_vcf)
    fp = sorted(set(called) - set(planted))
    fn = sorted(set(planted) - set(called))

    cols = decode_bam_columnar(germ_bam)
    cols = cols.select(cols.is_mapped_mask)
    source = ReadSource.from_columnar(cols)

    def oracle_calls_snv(contig, pos):
        """Exact oracle + the same --min-likelihood 40 filter the scale
        run uses. Returns (calls_variant_snv, diag)."""
        pileup = source.pileup_at(contig, pos)
        calls = call_variants_at_locus(pileup)
        calls = apply_genotype_filters(calls, min_likelihood=40)
        snvs = [
            c for c in calls
            if len(c.allele.ref_bases) == 1 and len(c.allele.alt_bases) == 1
        ]
        depth = pileup.depth
        # variant-supporting read count of the best snv (diagnostics)
        alt_support = 0
        if snvs:
            alt = snvs[0].allele.alt_bases
            alt_support = sum(
                1 for e in pileup.elements if e.allele.alt_bases == alt
            )
        return bool(snvs), {"depth": depth, "alt_support": alt_support}

    def classify(contig, pos, kind):
        agrees, diag = oracle_calls_snv(contig, pos)
        pipeline_called = (contig, pos) in called
        if agrees != pipeline_called:
            return "divergence", diag
        # Oracle agrees with the pipeline: reference-semantics behavior.
        mech = "other"
        if contig == "deep1m" and band_distance(pos, bands) <= 150:
            mech = "band-edge"
        elif kind == "fp" and diag["alt_support"] <= 3:
            mech = "error-flip-het"
        elif kind == "fn" and diag["depth"] <= 8:
            mech = "shallow-dropout"
        near_indel = False
        for t in ("ins_pos", "del_pos"):
            arr = np.asarray(truth[contig][t])
            if len(arr) and np.abs(arr - pos).min() <= 150:
                near_indel = True
        if near_indel and mech == "other":
            mech = "indel-shadow"
        return f"oracle-agrees:{mech}", diag

    taxonomy = {"fp": {}, "fn": {}, "examples": {"fp": [], "fn": []}}
    for kind, loci in (("fp", fp), ("fn", fn)):
        for contig, pos in loci:
            label, diag = classify(contig, pos, kind)
            taxonomy[kind][label] = taxonomy[kind].get(label, 0) + 1
            if len(taxonomy["examples"][kind]) < 8:
                taxonomy["examples"][kind].append(
                    {"contig": contig, "pos": pos, "label": label, **diag}
                )

    # Somatic: planted germline het sites that leaked into somatic calls.
    som_called = {
        p for (c, p) in read_vcf_snvs(som_vcf) if c == "deep1m"
    }
    germ_set = set(int(p) for p in truth["deep1m"]["snv_pos"])
    som_sites = set(int(p) for p in truth["deep1m"]["somatic_pos"])
    germline_fp = sorted(som_called & germ_set)

    t_cols = decode_bam_columnar(tumor_bam)
    t_cols = t_cols.select(t_cols.is_mapped_mask)
    n_cols = decode_bam_columnar(normal_bam)
    n_cols = n_cols.select(n_cols.is_mapped_mask)
    t_src = ReadSource.from_columnar(t_cols)
    n_src = ReadSource.from_columnar(n_cols)

    som_tax = {}
    som_examples = []
    for pos in germline_fp:
        tp = t_src.pileup_at("deep1m", pos)
        npi = n_src.pileup_at("deep1m", pos)
        oracle = find_potential_variant_at_locus(tp, npi, 20, 1)
        agrees = bool(oracle)
        n_depth = npi.depth
        # normal variant support at this locus
        alt = None
        for e in tp.elements:
            if e.allele.is_variant and len(e.allele.alt_bases) == 1:
                alt = e.allele.alt_bases
                break
        n_support = sum(
            1 for e in npi.elements if alt and e.allele.alt_bases == alt
        )
        if not agrees:
            label = "divergence"
        elif n_support <= 1:
            label = "oracle-agrees:normal-undersampled"
        else:
            # The reference's gate is odds = tumorL / sum(normal variant
            # genotype likelihoods) x 100 >= threshold
            # (SomaticStandardCaller.scala:217-221): when BOTH samples
            # are confidently variant (a germline het), odds ~ 1 and
            # 100 >= 20 passes — the gate measures tumor confidence
            # relative to normal variant mass, not subtraction. Most such
            # sites are removed by the somatic filter stack; these leaked
            # through it, with the oracle in exact agreement.
            label = "oracle-agrees:shared-variant-odds-gate"
        som_tax[label] = som_tax.get(label, 0) + 1
        if len(som_examples) < 8:
            som_examples.append(
                {
                    "pos": pos,
                    "label": label,
                    "tumor_depth": tp.depth,
                    "normal_depth": n_depth,
                    "normal_alt_support": n_support,
                }
            )

    out = {
        "germline_standard": {
            "called_snvs": len(called),
            "planted_snvs": len(planted),
            "fp_total": len(fp),
            "fn_total": len(fn),
            "fp_taxonomy": taxonomy["fp"],
            "fn_taxonomy": taxonomy["fn"],
            "examples": taxonomy["examples"],
        },
        "somatic": {
            "germline_fp_total": len(germline_fp),
            "somatic_recall": round(
                len(som_called & som_sites) / max(1, len(som_sites)), 4
            ),
            "taxonomy": som_tax,
            "examples": som_examples,
        },
    }
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
