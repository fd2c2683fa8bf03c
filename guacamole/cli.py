"""Command-line interface: the `guacamole` driver.

Subcommand registry and flag surface mirror the reference CLI
(cf. the reference's .../Guacamole.scala:37-77 and the per-command args4j
argument traits), dispatching into the callers.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from guacamole import __version__
from guacamole.parallel.multihost import DEFAULT_DCN_TIMEOUT_S
from guacamole.utils.progress import DelayedMessages, progress


def _add_base_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--debug", action="store_true", help="Print debug output")


def _add_loci_args(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--loci",
        default="",
        help="Loci at which to call variants. Either 'all' or "
        "contig:start-end,contig:start-end,...",
    )
    p.add_argument(
        "--loci-from-file",
        default="",
        help="Path to file giving loci at which to call variants.",
    )


def _add_reads_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--reads", required=True, help="Aligned reads (BAM/SAM)")
    _add_read_loading_args(p)


def _add_tumor_normal_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--tumor-reads", required=True, help="Aligned tumor reads")
    p.add_argument("--normal-reads", required=True, help="Aligned normal reads")
    _add_read_loading_args(p)


def _add_read_loading_args(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--no-sequence-dictionary",
        action="store_true",
        help="Get contigs and lengths from reads, not the sequence dictionary",
    )
    p.add_argument(
        "--bam-reader-api",
        default="best",
        choices=["best", "native", "samtools", "hadoopbam", "python"],
        help="BAM decoding backend: 'best'/'native' use the multithreaded "
        "C++ runtime when available; 'samtools'/'hadoopbam'/'python' use "
        "the pure-Python decoder (the reference's API names are accepted "
        "for compatibility)",
    )
    p.add_argument(
        "--recompute-md-tags",
        action="store_true",
        help="Recompute MD tags from the reference fasta",
    )


def _add_concordance_args(p: argparse.ArgumentParser) -> None:
    """Concordance arg trait (cf. reference Concordance.scala:40-52)."""
    p.add_argument(
        "--truth", default="", help="Truth VCF to compute concordance against"
    )
    p.add_argument(
        "--exclude-snv",
        action="store_true",
        help="Exclude SNV variants in comparison",
    )
    p.add_argument(
        "--exclude-indel",
        action="store_true",
        help="Exclude indel variants in comparison",
    )
    p.add_argument("--chr", default="", help="Chromosome to filter to")


def _print_concordance(args, records) -> None:
    from guacamole.concordance import print_genotype_concordance

    print_genotype_concordance(
        records,
        args.truth,
        exclude_snvs=args.exclude_snv,
        exclude_indels=args.exclude_indel,
        chromosome=args.chr,
    )


def _add_output_args(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--out",
        default="",
        help="Variant output path (.vcf or .json). Default: print to stdout.",
    )
    p.add_argument(
        "--max-genotypes",
        type=int,
        default=0,
        help="Maximum number of genotypes to output (0 = all)",
    )
    # Accepted for reference CLI compatibility (Common.scala:113-115):
    # there it only set how many chunks Spark coalesced the genotype RDD
    # into before the driver's serial JSON write; the output is identical.
    # Our JSON writer streams in one pass, so the knob has no effect.
    p.add_argument("--out-chunks", type=int, default=1, help=argparse.SUPPRESS)
    # Also accepted-but-inert: the reference's Arguments.Reference trait
    # (Common.scala:122-129) declares --fragment-length, but no command
    # mixes the trait in — dead config there. Its sibling --reference is
    # deliberately NOT accepted: an exact --reference option would
    # silently shadow argparse's --reference(-fasta) abbreviation in the
    # callers that take a FASTA (see DEVIATIONS.md).
    p.add_argument(
        "--fragment-length", type=int, default=10000, help=argparse.SUPPRESS
    )
    p.add_argument(
        "--vcf-header-compat",
        default="",
        choices=["", "adam016"],
        dest="vcf_header_compat",
        help="VCF header boilerplate: default (this framework's header) "
        "or 'adam016' (the ADAM-0.16-era saveAsVcf header the reference "
        "emitted, Common.scala:290-293) — record content is identical "
        "either way; see BASELINE.md for the record-level parity "
        "contract.",
    )


def _add_distributed_args(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--parallelism",
        type=int,
        default=0,
        help="Number of variant-calling shards (0 = number of devices)",
    )
    p.add_argument(
        "--partition-accuracy",
        type=int,
        default=250,
        help="Micro-partitions per task for depth-balanced loci partitioning "
        "(0 = partition uniformly)",
    )
    p.add_argument(
        "--tile-size",
        type=int,
        default=0,
        help="Loci per device tile (0 = auto: size tiles to a memory "
        "budget so a whole region screens in O(1) kernel launches)",
    )
    p.add_argument(
        "--mesh",
        default="auto",
        choices=["auto", "on", "off"],
        help="Run device screens as one shard_map step per tile group over "
        "all devices (one tile per device). 'auto' enables it when a "
        "process has several GPUs; 'on' forces it (e.g. on the virtual CPU "
        "mesh in tests); 'off' screens tiles sequentially on one device.",
    )
    # Multi-host runtime (the reference's driver+executors across machines,
    # Command.scala:51-62 / README.md:66-88). A cluster launcher starts one
    # process per host with identical flags except --process-id (or the
    # GUAC_COORDINATOR / GUAC_NUM_PROCESSES / GUAC_PROCESS_ID env vars).
    p.add_argument(
        "--coordinator",
        default="",
        help="host:port of process 0 for multi-process runs "
        "(jax.distributed coordinator)",
    )
    p.add_argument(
        "--num-processes",
        type=int,
        default=0,
        help="Total processes in a multi-host run (0/1 = single process)",
    )
    p.add_argument(
        "--process-id",
        type=int,
        default=-1,
        help="This process's index in a multi-host run",
    )
    p.add_argument(
        "--recover",
        action="store_true",
        help="Resume a failed multi-process run from its completed "
        "per-shard results (<out>.shards/): re-execute only the missing "
        "shards' loci in this single process, merge, and write output "
        "identical to an undisturbed run. The task-retry analog of the "
        "reference's Spark lineage recovery (README.md:66-88); see "
        "docs/MULTIHOST.md.",
    )
    p.add_argument(
        "--timeout",
        type=float,
        default=-1.0,
        dest="dcn_timeout",
        help="Abort (exit 42, one-line error) if any cross-process DCN "
        "collective stalls longer than this many seconds — a dead peer "
        "then fails the job promptly instead of hanging the survivors. "
        "Default %d; 0 disables. (Also GUAC_TIMEOUT.)"
        % int(DEFAULT_DCN_TIMEOUT_S),
    )


def _default_parallelism() -> int:
    try:
        import jax

        return max(1, len(jax.devices()))
    except Exception:
        return 1


def _resolve_mesh(args):
    """The device mesh for this run, or None for sequential screening.

    'auto' uses the mesh exactly when a process has several GPUs (on CPU
    the extra devices are virtual test shards, not parallel hardware —
    force with --mesh on there). In a multi-process run each process holds
    one card, so its mesh is off: the cross-process axis is the
    per-process loci shard, merged over DCN, not a global shard_map."""
    if getattr(args, "mesh", "off") == "off":
        return None
    import jax

    devices = jax.local_devices()
    if args.mesh == "auto" and (
        len(devices) < 2 or devices[0].platform == "cpu"
    ):
        return None
    from guacamole.parallel.mesh import loci_mesh

    return loci_mesh(devices)


def _bootstrap_multihost(args):
    """Join the multi-process runtime (no-op single-process). Must run
    before any other JAX use, so call it ahead of _resolve_mesh."""
    from guacamole.parallel.multihost import bootstrap

    return bootstrap(
        getattr(args, "coordinator", ""),
        getattr(args, "num_processes", 0),
        getattr(args, "process_id", -1),
        getattr(args, "dcn_timeout", -1.0),
    )


def _multihost_shard_builder(mh, loci_builder, reads_path, args=None):
    """Restrict the loci builder to this process's shard (each process
    then .bai-reads only its own shard's byte ranges). Returns
    (builder-or-None, shard_is_empty).

    With --recover (single process): load the failed run's completed
    shard records from <out>.shards/, stash them for _multihost_finalize,
    and restrict the builder to the MISSING shards' loci only."""
    from guacamole.gio.load import header_contig_lengths
    from guacamole.loci.lociset import parse_loci

    if (
        args is not None
        and getattr(args, "recover", False)
        and not mh.active
    ):
        from guacamole.parallel.multihost import (
            load_shards,
            missing_shards_expression,
        )

        out = getattr(args, "out", "")
        count, have = load_shards(out)
        if count == 0:
            raise SystemExit(
                f"guacamole: --recover found no shard files at "
                f"{out}.shards/ — nothing to resume"
            )
        lengths = header_contig_lengths(reads_path)
        loci_set = loci_builder.result(lengths)
        expr = missing_shards_expression(loci_set, count, have)
        args._recovered_records = [
            r for idx in sorted(have) for r in have[idx]
        ]
        progress(
            "Recovering: %d/%d shards on disk; re-executing %s"
            % (len(have), count, expr or "(nothing — all present)")
        )
        if not expr:
            return None, True
        return parse_loci(expr), False

    if not mh.active:
        return loci_builder, False
    from guacamole.parallel.multihost import shard_loci_expression

    lengths = header_contig_lengths(reads_path)
    loci_set = loci_builder.result(lengths)
    expr = shard_loci_expression(mh, loci_set)
    progress(
        "Process %d/%d loci shard: %s"
        % (mh.process_index, mh.process_count, expr or "(empty)")
    )
    if expr is None:
        return None, True
    return parse_loci(expr), False


def _multihost_counters(mh, **counters):
    """Sum named counters across processes over DCN (the Spark-accumulator
    analog); identity in single-process runs."""
    from guacamole.parallel.multihost import allreduce_counters

    return allreduce_counters(mh, counters)


def _multihost_finalize(mh, records, args=None):
    """Merge per-process VCF records over DCN; every process receives the
    full set (progress counters stay truthful everywhere) but only
    process 0 should write (mh.is_writer).

    Multi-process: each process persists its shard to <out>.shards/
    BEFORE the merge, so completed work survives a peer's death and
    --recover can resume (the Spark task-retry analog); shard files are
    cleaned up once the merge succeeds. --recover (single process):
    merge this run's recomputed records with the loaded shards."""
    out = getattr(args, "out", "") if args is not None else ""
    if mh.active:
        import os as _os

        from guacamole.parallel.multihost import (
            gather_objects,
            persist_shard,
        )

        # Test-only fault injection: simulate this process dying mid-run
        # (before it persists or merges anything), so the recovery test
        # exercises a genuinely lost shard.
        die = _os.environ.get("GUAC_TEST_EXIT_BEFORE_MERGE", "")
        if die != "" and int(die) == mh.process_index:
            sys.stderr.write(
                "guacamole: GUAC_TEST_EXIT_BEFORE_MERGE fault hook — "
                "exiting before shard persist/merge\n"
            )
            _os._exit(43)
        if out:
            persist_shard(
                out, mh.process_index, mh.process_count, records
            )
        merged = gather_objects(mh, records)
        merged.sort(
            key=lambda r: (r.contig, r.start, r.sample_name, r.ref, r.alt)
        )
        return merged
    recovered = (
        getattr(args, "_recovered_records", None)
        if args is not None
        else None
    )
    if recovered is not None:
        merged = list(records) + list(recovered)
        merged.sort(
            key=lambda r: (r.contig, r.start, r.sample_name, r.ref, r.alt)
        )
        return merged
    return records


def _clear_shards_after_write(mh, args) -> None:
    """Remove a run's crash-recovery shard files — called ONLY after the
    writer's output has been durably written (clearing any earlier would
    reopen the window the persist-before-merge design closes)."""
    out = getattr(args, "out", "")
    if out and (mh.active or getattr(args, "recover", False)):
        from guacamole.parallel.multihost import clear_shards

        clear_shards(out)


def _partition(args, loci_set, *read_lists):
    from guacamole.loci.partition import partition_loci_from_args

    return partition_loci_from_args(
        args.parallelism,
        args.partition_accuracy,
        loci_set,
        *read_lists,
        default_parallelism=_default_parallelism(),
    )


def _streaming_partitions(args, loci_set, path):
    """Loci partitions for the per-task .bai-pushdown streaming path:
    uniform when --partition-accuracy 0, else depth-balanced from the BAM
    index's byte-density histogram (no read decode — the default, matching
    the reference's depth-balanced default at DistributedUtil.scala:41-48).
    None when depth balancing needs an index that can't be built."""
    from guacamole.loci.partition import (
        partition_loci_by_index_depth,
        partition_loci_uniformly,
    )

    tasks = args.parallelism
    if not tasks:
        # Each task's IO + decode runs on a background thread while the
        # previous task packs/screens, so on big inputs more tasks than
        # devices keeps the pipeline full (~16 MB compressed per task;
        # small inputs stay single-task). Explicit --parallelism wins.
        import os as _os

        try:
            size = _os.stat(path).st_size
        except OSError:
            size = 0
        # ~3 MB compressed per task: enough tasks that the per-task
        # decode (background thread) fully overlaps the previous task's
        # pack/classify AND the pipeline-head (first decode) cost stays
        # small (measured best at 2.37M-read scale after the round-5
        # pooled chunk inflate; 8 MB tasks left ~0.5 s of head + tail
        # stall), and per-task working memory stays flat as inputs grow
        # (the O(task) memory claim, gated by the bench's memory_scaling
        # section).
        tasks = max(
            _default_parallelism(), min(64, max(1, size // (3 << 20)))
        )
    if args.partition_accuracy == 0:
        return partition_loci_uniformly(tasks, loci_set)
    from guacamole.callers.streaming import ensure_bam_index

    bai_path = ensure_bam_index(path)
    if bai_path is None:
        return None
    return partition_loci_by_index_depth(
        tasks, loci_set, args.partition_accuracy, path, bai_path
    )


def _streaming_eligible(args) -> bool:
    """The read-loading configurations the streaming path supports.
    GUAC_NO_STREAMING=1 forces the whole-file load path (the memory-
    scaling bench's comparator; also useful for debugging)."""
    import os as _os

    if _os.environ.get("GUAC_NO_STREAMING", "") == "1":
        return False
    return (
        not args.no_sequence_dictionary
        and not args.recompute_md_tags
        and args.bam_reader_api in ("best", "native")
    )


def _try_streaming_threshold(args, loci_builder, reference, mesh=None):
    """Streaming germline-threshold (per-task BAM pushdown); None when
    the streaming path is unavailable or unprofitable."""
    from guacamole.callers.germline_threshold import (
        call_variants_streaming,
    )
    from guacamole.reads.read import InputFilters

    try:
        # Availability probing only: a non-BAM input (or malformed header)
        # falls back to the whole-file loader, which reports its own
        # errors properly.
        from guacamole.gio.bam import BamFile

        dictionary = dict(BamFile(args.reads).references)
    except Exception:
        return None
    loci_set = loci_builder.result(dictionary)
    partitions = _streaming_partitions(args, loci_set, args.reads)
    if partitions is None:
        return None
    filters = InputFilters.create(
        overlaps_loci=loci_builder, non_duplicate=True, has_mdtag=True
    )
    return call_variants_streaming(
        args.reads,
        filters,
        partitions,
        threshold_percent=args.threshold,
        emit_ref=args.emit_ref,
        emit_no_call=args.emit_no_call,
        tile_size=args.tile_size,
        reference_genome=reference,
        mesh=mesh,
    )


def cmd_germline_threshold(argv: List[str]) -> int:
    p = argparse.ArgumentParser(
        prog="guacamole germline-threshold",
        description="call variants by thresholding read counts (toy example)",
    )
    _add_base_args(p)
    _add_loci_args(p)
    _add_reads_args(p)
    _add_output_args(p)
    _add_distributed_args(p)
    p.add_argument(
        "--threshold",
        type=int,
        default=8,
        metavar="X",
        help="Make a call if at least X%% of reads support it. Default: 8",
    )
    p.add_argument(
        "--emit-ref", action="store_true", help="Output homozygous reference calls"
    )
    p.add_argument(
        "--emit-no-call", action="store_true", help="Output no-call calls"
    )
    p.add_argument("--reference-fasta", default=None, help="Reference FASTA")
    _add_concordance_args(p)
    args = p.parse_args(argv)

    from guacamole.callers.common import (
        load_read_source,
        resolve_loci_builder,
        validate_output_path,
        write_variants,
    )
    from guacamole.callers.germline_threshold import call_variants
    from guacamole.gio.fasta import ReferenceGenome
    from guacamole.reads.read import InputFilters

    validate_output_path(args.out)
    loci_builder = resolve_loci_builder(args.loci, args.loci_from_file)
    mh = _bootstrap_multihost(args)
    loci_builder, empty_shard = _multihost_shard_builder(
        mh, loci_builder, args.reads, args
    )
    reference = (
        ReferenceGenome.from_fasta(args.reference_fasta)
        if args.reference_fasta
        else None
    )
    filters = InputFilters.create(
        overlaps_loci=loci_builder, non_duplicate=True, has_mdtag=True
    )
    mesh = _resolve_mesh(args)
    calls = None
    contig_lengths = None
    if empty_shard:
        from guacamole.gio.load import header_contig_lengths

        calls = []
        contig_lengths = header_contig_lengths(args.reads)
    elif _streaming_eligible(args):
        # Partitioning needs only the header's contig lengths (uniform) or
        # the BAM index's byte-density histogram (depth-balanced), so each
        # task can decode just its own BAM byte ranges (.bai pushdown),
        # overlapping the next task's IO with device screens.
        calls = _try_streaming_threshold(args, loci_builder, reference, mesh)
        if calls is not None:
            from guacamole.gio.bam import BamFile

            contig_lengths = dict(BamFile(args.reads).references)
    if calls is None:
        source, contig_lengths = load_read_source(
            args.reads,
            filters,
            contig_lengths_from_dictionary=not args.no_sequence_dictionary,
            reference_genome=reference,
            recompute_mdtags=args.recompute_md_tags,
            use_native=args.bam_reader_api in ("best", "native"),
        )
        progress(
            "Loaded %d mapped non-duplicate MdTag-containing reads."
            % source.n
        )
        loci_set = loci_builder.result(contig_lengths)
        loci_partitions = _partition(args, loci_set, source)
        calls = call_variants(
            source,
            loci_partitions,
            threshold_percent=args.threshold,
            emit_ref=args.emit_ref,
            emit_no_call=args.emit_no_call,
            tile_size=args.tile_size,
            reference_genome=reference,
            mesh=mesh,
        )
    progress("Called %d genotypes." % len(calls))
    records = _multihost_finalize(
        mh, [c.to_vcf_record() for c in calls], args
    )
    if mh.active:
        progress(
            "Merged %d genotypes across %d processes."
            % (len(records), mh.process_count)
        )
    if mh.is_writer:
        write_variants(
            records,
            args.out,
            contig_lengths=contig_lengths,
            max_genotypes=args.max_genotypes,
            vcf_header_compat=getattr(args, "vcf_header_compat", ""),
        )
        _clear_shards_after_write(mh, args)
        if args.truth:
            _print_concordance(args, records)
    DelayedMessages.default.print()
    return 0


def cmd_germline_standard(argv: List[str]) -> int:
    from guacamole.callers.germline_standard import main as standard_main

    return standard_main(argv, _add_fns=ARG_HELPERS)


def cmd_somatic_standard(argv: List[str]) -> int:
    from guacamole.callers.somatic_standard import main as somatic_main

    return somatic_main(argv, _add_fns=ARG_HELPERS)


def cmd_variant_support(argv: List[str]) -> int:
    from guacamole.callers.variant_support import main as vs_main

    return vs_main(argv, _add_fns=ARG_HELPERS)


def cmd_vaf_histogram(argv: List[str]) -> int:
    from guacamole.callers.vaf_histogram import main as vaf_main

    return vaf_main(argv, _add_fns=ARG_HELPERS)


def cmd_structural_variant(argv: List[str]) -> int:
    from guacamole.callers.structural_variant import main as sv_main

    return sv_main(argv, _add_fns=ARG_HELPERS)


ARG_HELPERS = {
    "base": _add_base_args,
    "loci": _add_loci_args,
    "reads": _add_reads_args,
    "tumor_normal": _add_tumor_normal_args,
    "output": _add_output_args,
    "distributed": _add_distributed_args,
    "concordance": _add_concordance_args,
    "read_config": _add_read_loading_args,
    "print_concordance": _print_concordance,
    "partition": _partition,
    "default_parallelism": _default_parallelism,
    "resolve_mesh": _resolve_mesh,
    "bootstrap_multihost": _bootstrap_multihost,
    "multihost_shard_builder": _multihost_shard_builder,
    "multihost_counters": _multihost_counters,
    "multihost_finalize": _multihost_finalize,
    "clear_shards_after_write": _clear_shards_after_write,
    "streaming_partitions": _streaming_partitions,
    "streaming_eligible": _streaming_eligible,
}

def cmd_index(argv: List[str]) -> int:
    """Build a .bai index for a coordinate-sorted BAM (enables the
    BAM-index region pushdown in the loaders)."""
    p = argparse.ArgumentParser(
        prog="guacamole index",
        description="build a .bai index for a coordinate-sorted BAM",
    )
    p.add_argument("bam", help="Coordinate-sorted BAM to index")
    p.add_argument(
        "--out", default="", help="Index path (default: <bam>.bai)"
    )
    args = p.parse_args(argv)
    from guacamole.gio.bai import build_bam_index

    out = build_bam_index(args.bam, args.out or None)
    progress(f"Wrote index: {out}")
    return 0


COMMANDS = {
    "germline-threshold": (
        cmd_germline_threshold,
        "call variants by thresholding read counts (toy example)",
    ),
    "germline-standard": (
        cmd_germline_standard,
        "call variants using a simple quality-based probability",
    ),
    "somatic-standard": (
        cmd_somatic_standard,
        "call somatic variants using independent callers on tumor and normal",
    ),
    "variant-support": (
        cmd_variant_support,
        "Find number of reads that support each variant across BAMs",
    ),
    "vaf-histogram": (
        cmd_vaf_histogram,
        "Compute and cluster the variant allele frequencies",
    ),
    "structural-variant": (
        cmd_structural_variant,
        "Find structural variants, e.g. large deletions",
    ),
    "index": (
        cmd_index,
        "Build a .bai index for a coordinate-sorted BAM",
    ),
}


def main(argv: Optional[List[str]] = None) -> int:
    import os

    from guacamole.platform import configure_platform

    configure_platform()
    argv = list(sys.argv[1:] if argv is None else argv)

    # Device-level tracing (the XLA-profiler analog of the reference's
    # progress/YourKit instrumentation): set GUAC_PROFILE_DIR to capture a
    # jax profiler trace of the whole command.
    profile_dir = os.environ.get("GUAC_PROFILE_DIR")
    if profile_dir:
        import jax

        jax.profiler.start_trace(profile_dir)
        try:
            return _dispatch(argv)
        finally:
            jax.profiler.stop_trace()
            progress(f"Wrote device profile trace to {profile_dir}")
    return _dispatch(argv)


def _dispatch(argv: List[str]) -> int:
    if not argv or argv[0] in ("-h", "--help"):
        print(f"guacamole {__version__}: variant caller on JAX/XLA.")
        print("Usage: guacamole <command> [args]\n\nCommands:")
        for name, (_, description) in COMMANDS.items():
            print(f"  {name:20s} {description}")
        return 0 if argv else 1
    command = argv[0]
    if command not in COMMANDS:
        print(f"Unknown command: {command}", file=sys.stderr)
        print(f"Valid commands: {', '.join(COMMANDS)}", file=sys.stderr)
        return 1
    try:
        return COMMANDS[command][0](argv[1:])
    except BrokenPipeError:
        return 1  # e.g. `guacamole ... | head`
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
        return 130
    except Exception as exc:
        # One-line operational errors (bad paths, malformed inputs);
        # --debug (anywhere in argv) keeps the full traceback.
        if "--debug" in argv:
            raise
        print(
            f"guacamole {command}: error: {type(exc).__name__}: {exc}",
            file=sys.stderr,
        )
        print("(re-run with --debug for the full traceback)", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
