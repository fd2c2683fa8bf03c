#!/usr/bin/env python3
"""Smoke test of the variant-calling main path on the GPU.

With no arguments (one card):

  1. device    the JAX devices and the card's name and power limit;
  2. fixture   the seeded scale fixture (2.37M reads; utils/simulate.py
               make_scale_fixture, seed 2026) in .bench_scale/, reused
               when its manifest matches;
  3. callers   germline-threshold, germline-standard, somatic-standard,
               variant-support and vaf-histogram (with its EM clustering)
               through guacamole.cli.main, cold then warm, on the default
               device path; each must launch device screens and move
               bytes to the card;
  4. reference each output byte-identical to the same command with
               GUAC_HOST_SCREEN=1 (native host screens and the exact f64
               confirm, no device screens, clustering on the CPU), and the
               planted-truth gates;
  5. kernels   every device screen on tiles packed from the fixture,
               against the same XLA function on the CPU device: CSR counts
               and candidates exactly equal; likelihood flags counted where
               they differ, and no miss of a row whose exact f64 argmax
               genotype (likelihood.py) is variant; no dot_general in any
               screen.

With --four-cards: germline-threshold, germline-standard and
somatic-standard across four cards, as one mesh (--mesh on) and as four
processes with one card each, each output byte-identical to the
single-card --mesh off run.

Every line is one JSON object; the last is the result
{"ok": true, "device": {...}}, printed only when every phase passed. Exits
non-zero on any failure, before any phase when JAX finds no GPU, and when
run outside a checkout of the repository.

Usage: python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE_DIR = os.path.join(REPO, ".bench_scale")
SEED = 2026
CALLERS = (
    "germline-threshold",
    "germline-standard",
    "somatic-standard",
    "variant-support",
    "vaf-histogram",
)
MESH_CALLERS = CALLERS[:3]
# The platform every device phase must find (JAX's name for CUDA cards).
PLATFORM = "gpu"
# The genotype-likelihood screens' flags at a real width: rows of the
# deep contig's 1000x band and 8000x spike, and of its 25x background.
KERNEL_REGIONS = {"deep1m": [(280_000, 300_000), (345_000, 356_000)]}


class SmokeFailure(RuntimeError):
    """A phase failed; the message says which check."""


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Fixture, command lines and the planted-truth gates
# ---------------------------------------------------------------------------


def write_sites_vcf(path: str, truth: dict) -> int:
    """A sites VCF of the planted SNVs (variant-support's input)."""
    n = 0
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.1\n")
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for contig in sorted(truth):
            for pos, alt in zip(
                truth[contig]["snv_pos"], truth[contig]["snv_alt"]
            ):
                fh.write(f"{contig}\t{pos + 1}\t.\tN\t{alt}\t.\tPASS\t.\n")
                n += 1
    return n


def caller_argv(name: str, files: dict, sites: str, out: str) -> list:
    """The command line of one caller over the fixture, writing `out`."""
    germ, tumor, normal = files["germline"], files["tumor"], files["normal"]
    return {
        "germline-threshold": [
            name, "--reads", germ, "--threshold", "25", "--out", out],
        "germline-standard": [
            name, "--reads", germ, "--min-likelihood", "40", "--out", out],
        "somatic-standard": [
            name, "--tumor-reads", tumor, "--normal-reads", normal,
            "--odds", "20", "--out", out],
        "variant-support": [name, "-v", sites, "-o", out, germ],
        "vaf-histogram": [
            name, "--bins", "20", "--min-read-depth", "10", "--cluster",
            "--local-out", out, germ],
    }[name]


def out_path(work: str, name: str, tag: str) -> str:
    """Where one run of a caller writes (a .vcf, or the .csv tools)."""
    ext = "csv" if name in ("variant-support", "vaf-histogram") else "vcf"
    return os.path.join(work, f"{name}.{tag}.{ext}")


def read_vcf_snvs(path: str) -> set:
    """{(contig, pos0)} of the single-base SNV records of a VCF."""
    out = set()
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            f = line.rstrip("\n").split("\t")
            if len(f[3]) == 1 and all(len(a) == 1 for a in f[4].split(",")):
                out.add((f[0], int(f[1]) - 1))
    return out


def truth_gates(name: str, out: str, truth: dict, n_sites: int) -> dict:
    """The planted-truth gates of each caller (the scale fixture's
    measured recall and precision less a reseed margin). Returns the
    measured values; raises SmokeFailure when a gate fails."""
    planted = {
        (contig, pos) for contig in truth for pos in truth[contig]["snv_pos"]
    }
    res: dict = {}
    if name in ("germline-threshold", "germline-standard"):
        called = read_vcf_snvs(out)
        hits = len(called & planted)
        res["snv_recall"] = hits / max(1, len(planted))
        res["snv_precision"] = hits / max(1, len(called))
        floor = (0.93, 0.97) if name == "germline-threshold" else (0.95, 0.92)
        ok = res["snv_recall"] >= floor[0] and res["snv_precision"] >= floor[1]
    elif name == "somatic-standard":
        called = read_vcf_snvs(out)
        somatic = {
            (contig, pos)
            for contig in truth for pos in truth[contig].get("somatic_pos", ())
        }
        res["somatic_recall"] = len(called & somatic) / max(1, len(somatic))
        res["germline_fp"] = len(called & planted)
        ok = res["somatic_recall"] >= 0.9 and res["germline_fp"] <= 13
    elif name == "variant-support":
        with open(out) as fh:
            res["rows"] = len(fh.read().strip().splitlines())
        ok = res["rows"] >= n_sites
    else:
        with open(out) as fh:
            res["histogram_rows"] = len(fh.read().strip().splitlines()) - 1
        ok = res["histogram_rows"] >= 5
    if not ok:
        raise SmokeFailure(f"{name}: planted-truth gate failed: {res}")
    return res


def same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def parse_clusters(stdout: str) -> list:
    """[(mean, std, weight)] from vaf-histogram's --cluster lines."""
    rows = []
    for line in stdout.splitlines():
        if line.startswith("Cluster "):
            fields = dict(
                kv.split("=") for kv in line.split(": ", 1)[1].split(", ")
            )
            rows.append(tuple(float(fields[k]) for k in (
                "mean", "std. deviation", "weight")))
    return rows


@contextlib.contextmanager
def env_set(name: str, value):
    """Set (or with None, unset) one environment variable for a block."""
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def run_cli(argv: list) -> tuple:
    """(wall seconds, captured stdout) of one guacamole.cli.main call;
    raises SmokeFailure on a non-zero exit."""
    from guacamole import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise SmokeFailure(f"{argv[0]} exited {rc}")
    return wall, buf.getvalue()


def fixture(scale: float = 1.0) -> tuple:
    """(manifest, {kind: BAM path}, sites VCF path, n sites)."""
    from guacamole.utils.simulate import make_scale_fixture

    t0 = time.perf_counter()
    manifest = make_scale_fixture(FIXTURE_DIR, scale=scale, seed=SEED)
    gen_s = time.perf_counter() - t0
    files = {
        kind: os.path.join(FIXTURE_DIR, manifest["files"][kind + "_bam"])
        for kind in ("germline", "tumor", "normal")
    }
    # Index once here, so processes started together never build it.
    from guacamole.callers.streaming import ensure_bam_index

    for path in files.values():
        ensure_bam_index(path)
    sites = os.path.join(FIXTURE_DIR, "planted_sites.vcf")
    n_sites = write_sites_vcf(sites, manifest["truth"])
    emit(phase="fixture", seconds=gen_s, reads=manifest["counts"],
         seed=SEED, scale=scale, dir=FIXTURE_DIR)
    return manifest, files, sites, n_sites


def reads_of(name: str, manifest: dict) -> int:
    counts = manifest["counts"]
    if name == "somatic-standard":
        return counts["tumor"] + counts["normal"]
    return counts["germline"]


# ---------------------------------------------------------------------------
# One card
# ---------------------------------------------------------------------------


def phase_callers(card: str, manifest, files, sites, work: str) -> dict:
    """Each caller cold then warm on the default device path. Returns
    {caller: (output path, stdout of the warm run)}."""
    from guacamole.ops import dispatch

    outs = {}
    for name in CALLERS:
        walls, stats = [], []
        for run in ("cold", "warm"):
            out = out_path(work, name, run)
            dispatch.reset_transfer_stats()
            # Transfer accounting blocks on each staged copy, so only the
            # cold run counts bytes; launches are counted either way.
            with env_set("GUAC_TRANSFER_STATS", "1" if run == "cold" else None):
                wall, stdout = run_cli(caller_argv(name, files, sites, out))
            walls.append(wall)
            stats.append(dict(dispatch.TRANSFER_STATS))
        launches = [s["launches"] for s in stats]
        h2d = stats[0]["h2d_bytes"]
        n_reads = reads_of(name, manifest)
        emit(phase="callers", caller=name, card=card,
             cold_s=walls[0], warm_s=walls[1],
             cold_reads_per_s=n_reads / walls[0],
             warm_reads_per_s=n_reads / walls[1], reads=n_reads,
             launches_cold=launches[0], launches_warm=launches[1],
             h2d_bytes=h2d, d2h_bytes=stats[0]["d2h_bytes"])
        if min(launches) <= 0 or h2d <= 0:
            raise SmokeFailure(
                f"{name}: no device screen ran (launches {launches}, "
                f"h2d bytes {h2d})"
            )
        if not same_bytes(
            out_path(work, name, "cold"), out_path(work, name, "warm")
        ):
            raise SmokeFailure(f"{name}: cold and warm outputs differ")
        outs[name] = (out_path(work, name, "warm"), stdout)
    return outs


def phase_reference(card, manifest, files, sites, n_sites, outs, work):
    """Host-screen reference runs, byte comparison and truth gates."""
    import jax

    from guacamole.ops import dispatch

    cpu = jax.devices("cpu")[0]
    for name in CALLERS:
        out = out_path(work, name, "host")
        dispatch.reset_transfer_stats()
        with env_set("GUAC_HOST_SCREEN", "1"), jax.default_device(cpu):
            wall, stdout = run_cli(caller_argv(name, files, sites, out))
        launches = dispatch.TRANSFER_STATS["launches"]
        device_out, device_stdout = outs[name]
        identical = same_bytes(out, device_out)
        gates = truth_gates(name, device_out, manifest["truth"], n_sites)
        row = dict(phase="reference", caller=name, card=card,
                   host_screen_s=wall, launches=launches,
                   identical=identical, gates=gates)
        if name == "vaf-histogram":
            gpu_em, cpu_em = parse_clusters(device_stdout), parse_clusters(stdout)
            row["em_clusters_gpu"] = gpu_em
            row["em_clusters_cpu"] = cpu_em
            row["em_max_abs_diff"] = max(
                (abs(a - b) for g, c in zip(gpu_em, cpu_em)
                 for a, b in zip(g, c)),
                default=float("inf"),
            )
        emit(**row)
        if launches:
            raise SmokeFailure(f"{name}: the host-screen run launched "
                               f"{launches} device screens")
        if not identical:
            raise SmokeFailure(f"{name}: device and host-screen outputs differ")
        if name == "vaf-histogram" and not (
            len(row["em_clusters_gpu"]) == len(row["em_clusters_cpu"]) > 0
            and row["em_max_abs_diff"] <= 1e-3
        ):
            raise SmokeFailure("vaf-histogram: GPU and CPU EM clusters differ")


def _exact_variant_rows(pack, qvals, mapq, is_variant, is_standard):
    """Rows whose exact f64 argmax genotype (likelihood.py) carries a
    variant allele, decoded from a likelihood-packed tile."""
    import numpy as np

    from guacamole.likelihood import genotype_probs_for_rows

    if qvals is None:
        keep = pack != 0xFFFF
        quals = (pack >> 4).astype(np.int64)
    else:
        keep = pack != 0xFF
        table = np.zeros(16, np.int64)
        table[: len(qvals)] = qvals
        quals = table[pack >> 4]
    aid = np.where(keep, pack & 0xF, -1).astype(np.int64)
    rows = np.flatnonzero(keep.any(axis=1))
    probs = genotype_probs_for_rows(
        aid[rows], quals[rows], keep[rows], is_standard[rows],
        mapqs=None if mapq is None else mapq[rows].astype(np.int64),
        log_space=True,
    )
    out = []
    for r, (pairs, lls) in zip(rows, probs):
        if not pairs:
            continue
        a1, a2 = pairs[int(np.argmax(lls))]
        if is_variant[r, a1] or is_variant[r, a2]:
            out.append(int(r))
    return np.asarray(out, np.int64)


def _no_dot(lowered, what: str) -> None:
    text = lowered.as_text()
    if "dot_general" in text or "stablehlo.dot" in text:
        raise SmokeFailure(f"{what}: a matrix product is on the device path")


def phase_kernels(card: str, files: dict) -> None:
    """Device screens against the XLA functions on the CPU device."""
    import jax
    import numpy as np

    from guacamole.callers.common import load_read_source
    from guacamole.loci.lociset import parse_loci
    from guacamole.ops import dispatch, kernels
    from guacamole.reads.read import InputFilters

    cpu = jax.devices("cpu")[0]
    K = 8
    sources = {
        kind: load_read_source(files[kind], InputFilters.empty)[0]
        for kind in ("germline", "tumor")
    }

    def tiles(kind, fields):
        for contig, spans in KERNEL_REGIONS.items():
            expr = ",".join(f"{contig}:{a}-{b}" for a, b in spans)
            loci = parse_loci(expr).result(None).on_contig(contig)
            yield from sources[kind].iter_tiles(
                contig, loci, max_alleles=K, fields=fields, min_mapq=1
            )

    # CSR counting screen: exact equality with the CPU device and with the
    # native packer's own counts.
    rows = elements = 0
    for t in tiles("germline", "screen"):
        if not t.L:
            continue
        iv = np.asarray(t.is_variant)
        for thr in (None, 25):
            gpu = dispatch.screen_csr_launch(
                t.csr_nib, t.csr_off, iv, t.K, threshold_percent=thr
            ).result()
            with jax.default_device(cpu):
                ref = dispatch.screen_csr_launch(
                    t.csr_nib, t.csr_off, iv, t.K, threshold_percent=thr
                ).result()
            if not (
                np.array_equal(gpu.counts, ref.counts)
                and np.array_equal(gpu.candidates, ref.candidates)
                and np.array_equal(gpu.counts, np.asarray(t.counts32)[: t.L])
            ):
                raise SmokeFailure("CSR screen: GPU counts differ from CPU")
        rows += t.L
        elements += int(np.asarray(gpu.counts, np.int64).sum())
        blob = np.asarray(t.csr_nib)[: 1 << 20]
        off = np.minimum(np.asarray(t.csr_off, np.int32)[:1025], len(blob))
        _no_dot(kernels.tile_stats_csr.lower(
            blob, off, iv[:1024], t.K, threshold_percent=25), "CSR screen")
    emit(phase="kernels", screen="csr", card=card, rows=rows,
         elements=elements, equal=True)

    # Likelihood screens.
    for kind, fields, launch in (
        ("germline", "likelihood", dispatch.germline_screen_launch),
        ("tumor", "likelihood_mapq", dispatch.tumor_screen_launch),
    ):
        gates = (0.0, 40.0) if kind == "germline" else (0.0,)
        rows = flagged = differ = exact_variant = misses = 0
        for t in tiles(kind, fields):
            if not t.L:
                continue
            pack = np.asarray(t.ll_pack8 if t.ll_pack8 is not None else t.ll_pack)
            qvals = None if t.ll_pack8 is None else np.asarray(t.ll_qvals)
            mapq = None if kind == "germline" else np.asarray(t.ll_mapq)
            iv, st = np.asarray(t.is_variant), np.asarray(t.is_standard_alt)
            fn, args = _xla_screen(kind, pack, qvals, mapq, iv, st, t.K)
            if not rows:
                _no_dot(fn.lower(*args), f"{kind} likelihood screen")
            for min_phred in gates:
                kw = {"min_phred": min_phred} if kind == "germline" else {}
                gpu = np.asarray(launch(t, min_mapq=1, **kw).result())
                with jax.default_device(cpu):
                    ref = np.asarray(fn(*args, **kw))
                differ += int((gpu != ref).sum())
                if min_phred == 0.0:
                    exact = _exact_variant_rows(pack, qvals, mapq, iv, st)
                    exact_variant += len(exact)
                    misses += int((~gpu[exact]).sum())
                    flagged += int(gpu.sum())
            rows += t.L
        emit(phase="kernels", screen=f"{kind}-likelihood", card=card,
             rows=rows, flagged=flagged, flags_differ_from_cpu=differ,
             exact_variant_rows=exact_variant, exact_misses=misses)
        if misses:
            raise SmokeFailure(
                f"{kind} likelihood screen missed {misses} rows whose exact "
                "argmax genotype is variant"
            )


def _xla_screen(kind, pack, qvals, mapq, iv, st, K):
    """(jitted XLA screen, its positional arguments) for one tile."""
    from guacamole.ops import kernels

    if kind == "germline":
        if qvals is not None:
            return kernels.germline_likelihood_screen8, (pack, qvals, iv, st, K)
        return kernels.germline_likelihood_screen, (pack, iv, st, K)
    if qvals is not None:
        return kernels.tumor_likelihood_screen8, (pack, qvals, mapq, iv, st, K)
    return kernels.tumor_likelihood_screen, (pack, mapq, iv, st, K)


def run_one_card(work: str, scale: float = 1.0) -> None:
    import jax

    from guacamole.platform import compile_cache_dir

    card = card_line()
    dev = jax.devices()[0]
    emit(phase="device", devices=[str(d) for d in jax.devices()],
         kind=dev.device_kind, card=card, compile_cache=compile_cache_dir())
    manifest, files, sites, n_sites = fixture(scale)
    outs = phase_callers(card, manifest, files, sites, work)
    phase_reference(card, manifest, files, sites, n_sites, outs, work)
    phase_kernels(card, files)


# ---------------------------------------------------------------------------
# Four cards
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_processes(name: str, files, sites, out: str, n: int) -> float:
    """One caller as n cooperating processes (one card each) against a
    localhost coordinator; process 0 writes `out`. Returns the wall."""
    coordinator = f"localhost:{_free_port()}"
    argv = caller_argv(name, files, sites, out)
    procs = []
    t0 = time.perf_counter()
    for pid in range(n):
        log = open(out + f".p{pid}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "guacamole.cli", *argv,
             "--coordinator", coordinator, "--num-processes", str(n),
             "--process-id", str(pid)],
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
        ), log))
    failed = []
    for pid, (proc, log) in enumerate(procs):
        try:
            rc = proc.wait(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append((pid, rc))
    if failed:
        for proc, _log in procs:
            if proc.poll() is None:
                proc.kill()
        raise SmokeFailure(f"{name}: processes failed {failed}; see {out}.p*.log")
    return time.perf_counter() - t0


def run_four_cards(work: str, scale: float = 1.0) -> None:
    card = card_line()
    from guacamole.parallel.multihost import host_gpu_count

    if host_gpu_count() < 4:
        raise SmokeFailure(f"--four-cards needs 4 GPUs, found {host_gpu_count()}")
    manifest, files, sites, _n = fixture(scale)
    # The process runs come first, while this process holds no card.
    mp_walls = {
        name: run_processes(
            name, files, sites, out_path(work, name, "procs"), 4
        )
        for name in MESH_CALLERS
    }
    import jax

    devices = jax.devices()
    emit(phase="device", devices=[str(d) for d in devices],
         kind=devices[0].device_kind, card=card)
    if len(devices) != 4 or devices[0].platform != PLATFORM:
        raise SmokeFailure(f"--four-cards needs 4 GPUs, found {devices}")
    for name in MESH_CALLERS:
        single = out_path(work, name, "single")
        mesh = out_path(work, name, "mesh")
        procs = out_path(work, name, "procs")
        walls = {}
        for tag, out, extra in (
            ("single", single, ["--mesh", "off"]),
            ("mesh_cold", out_path(work, name, "mesh-cold"), ["--mesh", "on"]),
            ("mesh", mesh, ["--mesh", "on"]),
        ):
            walls[tag] = run_cli(caller_argv(name, files, sites, out) + extra)[0]
        row = dict(phase="four-cards", caller=name, card=card,
                   single_s=walls["single"], mesh_cold_s=walls["mesh_cold"],
                   mesh_s=walls["mesh"], processes_s=mp_walls[name],
                   reads=reads_of(name, manifest),
                   mesh_identical=same_bytes(single, mesh),
                   processes_identical=same_bytes(single, procs))
        emit(**row)
        if not (row["mesh_identical"] and row["processes_identical"]):
            raise SmokeFailure(f"{name}: four-card output differs from one card")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run the mesh and one-process-per-card paths on four cards",
    )
    args = ap.parse_args(argv)
    try:
        import guacamole  # noqa: F401
    except ImportError:
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    from guacamole.platform import configure_platform

    configure_platform()
    if args.four_cards:
        from guacamole.parallel.multihost import host_gpu_count

        found = host_gpu_count()
    else:
        import jax

        found = int(jax.devices()[0].platform == PLATFORM)
    if not found:
        print("chip_smoke: no GPU found", file=sys.stderr)
        return 1
    work = os.path.join(FIXTURE_DIR, "smoke")
    shutil.rmtree(work, ignore_errors=True)  # the callers never overwrite
    os.makedirs(work)
    t0 = time.perf_counter()
    try:
        if args.four_cards:
            run_four_cards(work)
        else:
            run_one_card(work)
    except SmokeFailure as exc:
        emit(phase="failed", error=str(exc))
        return 1
    import jax

    dev = jax.devices()[0]
    emit(phase="done", seconds=time.perf_counter() - t0)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
