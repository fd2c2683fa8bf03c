"""BAM writer round-trips: columnar -> BAM -> columnar must preserve every
field the columnar pipeline carries, through the native decoder, and the
written BAM must be indexable + region-queryable (.bai pushdown)."""

import os

import numpy as np
import pytest

from guacamole.gio.bamwrite import sam_to_bam, write_bam_from_columnar
from guacamole.runtime.columnar import (
    decode_bam_columnar,
    decode_sam_columnar,
    native_available,
)

from conftest import resource_path

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native runtime not built"
)

ROUNDTRIP_FIELDS = (
    "ref_id", "start", "end", "mapq", "flags_", "mismatches", "sample_id",
    "seq_off", "seq", "qual", "cigar_off", "cigar_len", "cigar_op",
    "md_off", "md_text", "ev_off", "ev_kind", "ev_base", "ev_qual",
    "ev_mdref",
)


def _assert_roundtrip(cols, back):
    assert back is not None
    assert back.n == cols.n
    assert back.ref_names == cols.ref_names
    assert [int(x) for x in back.ref_lengths] == [
        int(x) for x in cols.ref_lengths
    ]
    assert back.samples == cols.samples
    for field in ROUNDTRIP_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(cols, field)),
            np.asarray(getattr(back, field)),
            err_msg=field,
        )


@pytest.mark.parametrize(
    "fixture", ["chrM.sorted.bam", "gatk_mini_bundle_extract.bam"]
)
def test_bam_roundtrip(fixture, tmp_path):
    cols = decode_bam_columnar(resource_path(fixture))
    # mapped-only: the writer targets the mapped-read columnar pipeline
    cols = cols.select(cols.is_mapped_mask).compact()
    out = str(tmp_path / "rt.bam")
    assert write_bam_from_columnar(cols, out) == cols.n
    back = decode_bam_columnar(out)
    back = back.select(back.is_mapped_mask).compact()
    _assert_roundtrip(cols, back)


@pytest.mark.parametrize(
    "fixture", ["tumor.chr20.tough.sam", "rna_chr17_41244936.sam"]
)
def test_sam_to_bam_roundtrip(fixture, tmp_path):
    out = str(tmp_path / "conv.bam")
    n = sam_to_bam(resource_path(fixture), out)
    assert n > 0
    cols = decode_sam_columnar(resource_path(fixture))
    back = decode_bam_columnar(out)
    _assert_roundtrip(cols, back)


def test_written_bam_supports_index_pushdown(tmp_path):
    """ensure_bam_index must index the written BAM, and a region query
    must return exactly the overlapping reads."""
    from guacamole.callers.streaming import ensure_bam_index
    from guacamole.gio.bai import BamIndex, optimize_chunks
    from guacamole.runtime.native import decode_bam_native

    cols = decode_bam_columnar(resource_path("chrM.sorted.bam"))
    cols = cols.select(cols.is_mapped_mask).compact()
    out = str(tmp_path / "indexed.bam")
    write_bam_from_columnar(cols, out)
    bai = ensure_bam_index(out)
    assert bai is not None and os.path.exists(bai)
    lo, hi = 5000, 6000
    index = BamIndex(bai)
    chunks = optimize_chunks([index.chunks_for_region(0, lo, hi)])
    sub = decode_bam_native(out, chunks=chunks)
    assert sub is not None
    starts = np.asarray(sub["start"])
    ends = np.asarray(sub["end"])
    got = {
        (int(s), int(e))
        for s, e in zip(starts, ends)
        if e > lo and s < hi
    }
    want = {
        (int(s), int(e))
        for s, e in zip(cols.start, cols.end)
        if e > lo and s < hi
    }
    assert got == want and len(want) > 0


def test_cli_on_written_bam_matches_golden(tmp_path):
    """The full germline-threshold CLI on a rewritten chrM BAM (which
    takes the streaming .bai pushdown path) must reproduce the golden
    VCF byte-for-byte."""
    import subprocess
    import sys

    cols = decode_bam_columnar(resource_path("chrM.sorted.bam"))
    cols = cols.select(cols.is_mapped_mask).compact()
    bam = str(tmp_path / "chrM.rewritten.bam")
    write_bam_from_columnar(cols, bam)
    out = str(tmp_path / "out.vcf")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "guacamole.cli", "germline-threshold",
         "--reads", bam, "--parallelism", "2", "--out", out],
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    golden = os.path.join(
        os.path.dirname(__file__), "golden", "chrM.germline-threshold.vcf"
    )
    with open(out) as fh, open(golden) as gh:
        assert fh.read() == gh.read()
