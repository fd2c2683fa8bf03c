"""BAM-index region pushdown: the native chunked decoder and our own .bai
builder must reproduce the whole-file-decode + loci-filter path exactly
(the samtools QueryInterval pushdown of the reference, Read.scala:395-406,
with htsjdk's BAMIndexer capability replaced by gio.bai.build_bam_index)."""

import os
import shutil

import numpy as np
import pytest

from guacamole.callers.common import bai_chunks_for_loci
from guacamole.gio.bai import BamIndex, build_bam_index, optimize_chunks
from guacamole.loci.lociset import parse_loci
from guacamole.runtime.columnar import (
    decode_bam_columnar,
    filter_columnar,
    native_available,
)

from conftest import resource_path

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native runtime not built"
)

GATK = "gatk_mini_bundle_extract.bam"
CHRM = "chrM.sorted.bam"


def _assert_equal_filtered(sub, full, loci):
    a = filter_columnar(sub, loci_set=loci).compact()
    b = filter_columnar(full, loci_set=loci).compact()
    assert a.n == b.n
    for f in (
        "ref_id", "start", "end", "mapq", "flags_", "mismatches",
        "seq", "qual", "cigar_len", "cigar_op", "md_text",
        "ev_kind", "ev_base", "ev_qual", "ev_mdref",
    ):
        np.testing.assert_array_equal(
            getattr(a, f), getattr(b, f), err_msg=f
        )
    return a.n


@pytest.mark.parametrize(
    "expr", ["20:10000000-10005000", "20:10100000-10100100"]
)
def test_chunked_decode_matches_whole_decode_htsjdk_index(expr):
    path = resource_path(GATK)
    builder = parse_loci(expr)
    chunks = bai_chunks_for_loci(path, builder)
    assert chunks, "pushdown should engage (real .bai present)"
    full = decode_bam_columnar(path)
    sub = decode_bam_columnar(path, chunks=chunks)
    assert 0 < sub.n < full.n  # actually skipped most of the file
    loci = builder.result(full.contig_lengths)
    n = _assert_equal_filtered(sub, full, loci)
    assert n > 0


def test_built_index_matches_htsjdk_index_record_sets(tmp_path):
    src = resource_path(GATK)
    dst = str(tmp_path / "gatk.bam")
    shutil.copy(src, dst)
    bai = build_bam_index(dst)
    assert os.path.exists(bai)
    ours = BamIndex(bai)
    theirs = BamIndex(src + ".bai")
    full = decode_bam_columnar(src)
    for beg, end in [(10000000, 10005000), (9999901, 9999902)]:
        ca = optimize_chunks([ours.chunks_for_region(19, beg, end)])
        cb = optimize_chunks([theirs.chunks_for_region(19, beg, end)])
        loci = parse_loci(f"20:{beg}-{end}").result(full.contig_lengths)
        fa = filter_columnar(
            decode_bam_columnar(dst, chunks=ca), loci_set=loci
        ).compact()
        fb = filter_columnar(
            decode_bam_columnar(src, chunks=cb), loci_set=loci
        ).compact()
        assert fa.n == fb.n > 0
        np.testing.assert_array_equal(fa.start, fb.start)
        np.testing.assert_array_equal(fa.seq, fb.seq)


def test_build_index_and_pushdown_chrm(tmp_path):
    dst = str(tmp_path / CHRM)
    shutil.copy(resource_path(CHRM), dst)
    build_bam_index(dst)
    full = decode_bam_columnar(dst)
    for expr in ["chrM:4000-6000", "chrM:0-100", "chrM:16000-16571"]:
        builder = parse_loci(expr)
        chunks = bai_chunks_for_loci(dst, builder)
        assert chunks is not None
        sub = decode_bam_columnar(dst, chunks=chunks)
        loci = builder.result(full.contig_lengths)
        n = _assert_equal_filtered(sub, full, loci)
        assert n > 0


def test_no_pushdown_for_whole_genome_loci():
    # "all" covers everything: whole-file decode is the right plan.
    assert bai_chunks_for_loci(resource_path(GATK), parse_loci("all")) is None
