"""Simulator self-consistency: generated SAMs must parse through the
production loaders with MD/CIGAR consistent with the planted reference,
and the callers must recover the planted variants (the correctness gate
the scale benchmark reuses)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from guacamole.utils.simulate import (
    READ_LEN,
    make_scale_fixture,
    overflow_clump,
    plant_germline_variants,
    simulate_band,
    simulate_reference,
    write_sam,
    _hap1_sequence,
)


@pytest.fixture(scope="module")
def small_fixture(tmp_path_factory):
    out = tmp_path_factory.mktemp("sim")
    manifest = make_scale_fixture(
        str(out), scale=0.02, depth_scale=1.0, seed=7
    )
    return str(out), manifest


def test_fixture_idempotent(small_fixture):
    out, manifest = small_fixture
    again = make_scale_fixture(str(out), scale=0.02, depth_scale=1.0, seed=7)
    assert again == manifest


def test_generated_sam_parses_and_mdref_matches_planted_reference(
    small_fixture,
):
    """Every read's MD-reconstructed reference must equal the planted
    reference over the read's span — through the native SAM decoder."""
    from guacamole.runtime.columnar import decode_sam_columnar
    from guacamole.utils.simulate import simulate_reference

    out, manifest = small_fixture
    cols = decode_sam_columnar(os.path.join(out, manifest["files"]["germline"]))
    assert cols is not None
    assert cols.n == manifest["counts"]["germline"]
    # regenerate the deep contig reference deterministically
    rng = np.random.default_rng(np.random.PCG64(manifest["key"]["seed"]))
    deep_len = manifest["contigs"]["deep1m"]
    ref = simulate_reference(rng, deep_len)
    deep_id = cols.ref_names.index("deep1m")
    sel = np.flatnonzero(np.asarray(cols.ref_id) == deep_id)[:2000]
    checked = 0
    for i in sel:
        lo, hi = int(cols.ev_off[i]), int(cols.ev_off[i + 1])
        mdref = np.asarray(cols.ev_mdref[lo:hi])
        span = hi - lo
        start = int(cols.start[i])
        want = ref[start : start + span]
        known = mdref != ord("N")
        assert np.array_equal(mdref[known], want[known]), f"read {i}"
        checked += int(known.sum())
    assert checked > 10000  # the check actually exercised reference bases


def test_germline_threshold_recovers_planted_snvs(small_fixture, tmp_path):
    """Full CLI on the simulated germline sample: recall >= 0.9 of planted
    het SNVs in adequately-covered regions; >= 90% of called SNV sites are
    planted (background 25x band — errors at 0.2% cannot reach the 8%
    threshold at that depth)."""
    out, manifest = small_fixture
    vcf = str(tmp_path / "sim.vcf")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "guacamole.cli", "germline-threshold",
         "--reads", os.path.join(out, manifest["files"]["germline"]),
         "--threshold", "25",
         "--out", vcf],
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    called = set()
    with open(vcf) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.split("\t")
            if len(f[3]) == 1 and len(f[4]) == 1:  # SNV records
                called.add((f[0], int(f[1]) - 1))
    truth = manifest["truth"]
    planted = set()
    for contig in ("deep1m", "shallow8m"):
        for pos in truth[contig]["snv_pos"]:
            planted.add((contig, pos))
    hits = len(called & planted)
    assert hits / max(1, len(planted)) >= 0.9, (
        f"recall {hits}/{len(planted)}"
    )
    # precision: called SNVs should overwhelmingly be planted sites
    assert hits / max(1, len(called)) >= 0.9, (
        f"precision {hits}/{len(called)}"
    )


def test_somatic_pair_recovers_planted_somatic_snvs(small_fixture, tmp_path):
    out, manifest = small_fixture
    vcf = str(tmp_path / "som.vcf")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "guacamole.cli", "somatic-standard",
         "--tumor-reads", os.path.join(out, manifest["files"]["tumor"]),
         "--normal-reads", os.path.join(out, manifest["files"]["normal"]),
         "--odds", "20",
         "--out", vcf],
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    called = set()
    with open(vcf) as fh:
        for line in fh:
            if not line.startswith("#"):
                f = line.split("\t")
                called.add(int(f[1]) - 1)
    somatic = set(manifest["truth"]["deep1m"]["somatic_pos"])
    assert somatic, "fixture must plant somatic sites"
    hits = len(called & somatic)
    assert hits / len(somatic) >= 0.5, f"somatic recall {hits}/{len(somatic)}"
    # germline het SNVs must NOT be somatic calls (present in normal too)
    germline = set(manifest["truth"]["deep1m"]["snv_pos"])
    fp = len(called & germline)
    assert fp <= max(2, len(germline) // 20), (
        f"{fp} germline hets miscalled somatic"
    )


def test_overflow_loci_present_and_exercised(small_fixture):
    """The overflow clumps must actually push >K distinct alleles at their
    anchor loci so the bench exercises the exact-host fallback."""
    from guacamole.callers.source import ReadSource
    from guacamole.gio.load import load_read_set
    from guacamole.loci.lociset import LociSet
    from guacamole.reads.read import InputFilters

    out, manifest = small_fixture
    path = os.path.join(out, manifest["files"]["germline"])
    reads = load_read_set(path, InputFilters.empty).mapped_reads
    source = ReadSource.from_reads(
        sorted(
            (r for r in reads if r.reference_contig == "deep1m"),
            key=lambda r: r.start,
        )
    )
    deep_len = manifest["contigs"]["deep1m"]
    spike = manifest["bands"]["spike"]
    band = manifest["bands"]["band"]
    anchors = [
        spike[0] + (spike[1] - spike[0]) // 2,
        band[0] + 1000,
    ]
    found_overflow = 0
    for anchor in anchors:
        tiles = source.pack_tiles(
            "deep1m",
            LociSet.of("deep1m", anchor, anchor + 1).on_contig("deep1m"),
        )
        for t in tiles:
            for li in range(t.L):
                if int(t.loci[li]) == anchor and t.overflow[li]:
                    found_overflow += 1
    assert found_overflow == len(anchors), (
        f"only {found_overflow}/{len(anchors)} overflow anchors"
    )


def test_deep_band_depth_reached(small_fixture):
    """The spike band must actually reach its target depth (scaled)."""
    from guacamole.runtime.columnar import decode_sam_columnar

    out, manifest = small_fixture
    cols = decode_sam_columnar(
        os.path.join(out, manifest["files"]["germline"])
    )
    spike = manifest["bands"]["spike"]
    mid = (spike[0] + spike[1]) // 2
    deep_id = cols.ref_names.index("deep1m")
    on = np.asarray(cols.ref_id) == deep_id
    depth = int(
        (
            (np.asarray(cols.start)[on] <= mid)
            & (np.asarray(cols.end)[on] > mid)
        ).sum()
    )
    want = manifest["bands"]["spike_x"] + manifest["bands"]["background_x"]
    assert depth >= 0.7 * want, f"spike depth {depth} < 0.7*{want}"


def test_sv_fixture_planted_deletions_recovered(tmp_path):
    """The paired-read SV fixture's planted het deletions must be
    recovered by the structural-variant pipeline (discordant insert
    pairs -> compatibility graph -> cliques), each within 200 bp."""
    from guacamole.callers.structural_variant import (
        call_structural_variants,
    )
    from guacamole.gio.load import load_read_set
    from guacamole.reads.read import InputFilters, PairedMappedRead
    from guacamole.utils.simulate import make_sv_fixture

    manifest = make_sv_fixture(
        str(tmp_path), length=300_000, depth=18,
        deletions=((120_000, 5_000),), seed=7,
    )
    sam = tmp_path / manifest["files"]["sv_sam"]
    read_set = load_read_set(str(sam), InputFilters.create(non_duplicate=True))
    pairs = [
        pm
        for r in read_set.reads
        if (pm := PairedMappedRead.from_paired_read(r)) is not None
    ]
    assert len(pairs) > 10_000
    _max_normal, results = call_structural_variants(pairs)
    ranges = results.get(manifest["contig"], [])
    (truth_lo, truth_hi), = manifest["truth_deletions"]
    hits = [
        g for g in ranges
        if abs(g.start - truth_lo) <= 200 and abs(g.stop - truth_hi) <= 200
    ]
    assert len(hits) == 1, (ranges, manifest["truth_deletions"])
    assert len(ranges) <= 2
