"""chip_smoke.py off the card: it refuses to run without a GPU or outside
a checkout, and its comparison and planted-truth helpers."""

import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_exits_nonzero_without_a_gpu():
    proc = _run(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_exits_nonzero_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(tmp_path, "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


TRUTH = {
    "c1": {"snv_pos": [10, 20, 30], "snv_alt": ["A", "C", "G"],
           "somatic_pos": [40]},
    "c2": {"snv_pos": [5], "snv_alt": ["T"], "somatic_pos": []},
}


def _vcf(path, records):
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.1\n#CHROM\tPOS\tID\tREF\tALT\n")
        for contig, pos0, ref, alt in records:
            fh.write(f"{contig}\t{pos0 + 1}\t.\t{ref}\t{alt}\n")
    return str(path)


def test_sites_vcf_reads_back_as_the_planted_snvs(tmp_path):
    path = str(tmp_path / "sites.vcf")
    assert chip_smoke.write_sites_vcf(path, TRUTH) == 4
    assert chip_smoke.read_vcf_snvs(path) == {
        ("c1", 10), ("c1", 20), ("c1", 30), ("c2", 5)
    }


def test_read_vcf_snvs_skips_indels(tmp_path):
    path = _vcf(tmp_path / "a.vcf", [("c1", 10, "A", "G"), ("c1", 12, "AT", "A"),
                                     ("c1", 14, "A", "AT")])
    assert chip_smoke.read_vcf_snvs(path) == {("c1", 10)}


@pytest.mark.parametrize("caller", ["germline-threshold", "germline-standard"])
def test_germline_truth_gate(tmp_path, caller):
    good = _vcf(tmp_path / "good.vcf", [("c1", 10, "N", "A"), ("c1", 20, "N", "C"),
                                        ("c1", 30, "N", "G"), ("c2", 5, "N", "T")])
    res = chip_smoke.truth_gates(caller, good, TRUTH, 4)
    assert res == {"snv_recall": 1.0, "snv_precision": 1.0}
    bad = _vcf(tmp_path / "bad.vcf", [("c1", 10, "N", "A"), ("c1", 11, "N", "A")])
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.truth_gates(caller, bad, TRUTH, 4)


def test_somatic_truth_gate(tmp_path):
    hit = _vcf(tmp_path / "hit.vcf", [("c1", 40, "N", "A")])
    assert chip_smoke.truth_gates("somatic-standard", hit, TRUTH, 4) == {
        "somatic_recall": 1.0, "germline_fp": 0}
    miss = _vcf(tmp_path / "miss.vcf", [("c1", 10, "N", "A")])
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.truth_gates("somatic-standard", miss, TRUTH, 4)


def test_csv_truth_gates(tmp_path):
    rows = tmp_path / "support.csv"
    rows.write_text("".join(f"row{i}\n" for i in range(4)))
    assert chip_smoke.truth_gates("variant-support", str(rows), TRUTH, 4) == {
        "rows": 4}
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.truth_gates("variant-support", str(rows), TRUTH, 5)
    hist = tmp_path / "hist.csv"
    hist.write_text("header\n" + "".join(f"b{i}\n" for i in range(5)))
    assert chip_smoke.truth_gates("vaf-histogram", str(hist), TRUTH, 0) == {
        "histogram_rows": 5}


def test_parse_clusters():
    out = ("noise\nCluster 0: mean=0.25, std. deviation=0.5, weight=0.75\n"
           "Cluster 1: mean=1.0, std. deviation=2.0, weight=0.25\n")
    assert chip_smoke.parse_clusters(out) == [(0.25, 0.5, 0.75), (1.0, 2.0, 0.25)]


@pytest.mark.parametrize("caller", chip_smoke.CALLERS)
def test_caller_argv_writes_its_output(tmp_path, caller):
    files = {k: f"{k}.bam" for k in ("germline", "tumor", "normal")}
    out = chip_smoke.out_path(str(tmp_path), caller, "warm")
    argv = chip_smoke.caller_argv(caller, files, "sites.vcf", out)
    assert argv[0] == caller and out in argv
    assert out.endswith(
        ".csv" if caller in ("variant-support", "vaf-histogram") else ".vcf")


def test_smoke_helpers_on_a_tiny_fixture(tmp_path, monkeypatch):
    """The fixture phase and a caller run through run_cli on a tiny seeded
    fixture: outputs compare byte for byte and recover planted SNVs."""
    monkeypatch.setattr(chip_smoke, "FIXTURE_DIR", str(tmp_path))
    manifest, files, sites, n_sites = chip_smoke.fixture(scale=0.005)
    assert n_sites == sum(len(t["snv_pos"]) for t in manifest["truth"].values())
    outs = []
    for tag in ("a", "b"):
        out = chip_smoke.out_path(str(tmp_path), "germline-threshold", tag)
        wall, _stdout = chip_smoke.run_cli(
            chip_smoke.caller_argv("germline-threshold", files, sites, out))
        assert wall > 0
        outs.append(out)
    assert chip_smoke.same_bytes(*outs)
    planted = {(c, p) for c, t in manifest["truth"].items() for p in t["snv_pos"]}
    assert chip_smoke.read_vcf_snvs(outs[0]) & planted
