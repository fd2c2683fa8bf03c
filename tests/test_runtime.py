"""Native runtime cross-checks: the C++ decoder's columnar output must match
the Python decoder + event builder field-for-field."""

import numpy as np
import pytest

from guacamole.gio.load import load_read_set
from guacamole.reads.read import InputFilters
from guacamole.runtime.columnar import (
    columnar_from_reads,
    decode_bam_columnar,
    native_available,
)

from conftest import resource_path

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native runtime not built"
)


@pytest.fixture(scope="module", params=["chrM.sorted.bam", "gatk_mini_bundle_extract.bam"])
def pair(request, resources_dir):
    path = resource_path(request.param)
    native = decode_bam_columnar(path)
    assert native is not None
    # Python oracle: all reads incl. duplicates/unmapped-excluded
    read_set = load_read_set(path, InputFilters.empty)
    mapped = [r.as_mapped_read for r in read_set.reads if r.is_mapped]
    python = columnar_from_reads(mapped)
    # native includes unmapped records; restrict to mapped. compact() so the
    # raw-storage comparisons below see cumulative offsets + trimmed data.
    native_mapped = native.select(native.is_mapped_mask).compact()
    return native_mapped, python, read_set


def test_read_counts_match(pair):
    native, python, _ = pair
    assert native.n == python.n


def test_scalar_columns_match(pair):
    native, python, _ = pair
    np.testing.assert_array_equal(native.start, python.start)
    np.testing.assert_array_equal(native.end, python.end)
    np.testing.assert_array_equal(native.mapq, python.mapq)
    np.testing.assert_array_equal(
        native.flags_ & 0x611, python.flags_ & 0x611
    )  # paired/reverse/dup/vendor bits
    np.testing.assert_array_equal(native.mismatches, python.mismatches)


def test_sequences_match(pair):
    native, python, _ = pair
    np.testing.assert_array_equal(native.seq_off, python.seq_off)
    np.testing.assert_array_equal(native.seq, python.seq)
    np.testing.assert_array_equal(native.qual, python.qual)


def test_cigars_match(pair):
    native, python, _ = pair
    np.testing.assert_array_equal(native.cigar_off, python.cigar_off)
    np.testing.assert_array_equal(native.cigar_len, python.cigar_len)
    np.testing.assert_array_equal(native.cigar_op, python.cigar_op)


def test_event_arrays_match(pair):
    native, python, _ = pair
    np.testing.assert_array_equal(native.ev_off, python.ev_off)
    np.testing.assert_array_equal(native.ev_kind, python.ev_kind)
    np.testing.assert_array_equal(native.ev_base, python.ev_base)
    np.testing.assert_array_equal(native.ev_qual, python.ev_qual)
    np.testing.assert_array_equal(native.ev_mdref, python.ev_mdref)


def test_specials_match(pair):
    native, python, _ = pair

    def normalize(c):
        out = []
        for i in range(len(c.sp_read)):
            payload = bytes(
                c.special_payload[
                    c.sp_payload_offset[i] : c.sp_payload_offset[i]
                    + c.sp_payload_len[i]
                ]
            )
            out.append(
                (int(c.sp_read[i]), int(c.sp_offset[i]), int(c.sp_kind[i]),
                 payload, int(c.sp_qual[i]))
            )
        return sorted(out)

    assert normalize(native) == normalize(python)


def test_samples_match(pair):
    native, python, read_set = pair
    native_samples = [native.samples[i] for i in native.sample_id]
    python_samples = [python.samples[i] for i in python.sample_id]
    assert native_samples == python_samples


def test_to_mapped_read_roundtrip(pair):
    native, python, read_set = pair
    mapped = [r.as_mapped_read for r in read_set.reads if r.is_mapped]
    for i in range(0, native.n, max(1, native.n // 50)):
        got = native.to_mapped_read(i)
        want = mapped[i]
        assert got.start == want.start
        assert got.sequence == want.sequence
        assert got.base_qualities == want.base_qualities
        assert got.cigar == want.cigar
        assert got.mdtag == want.mdtag
        assert got.sample_name == want.sample_name
        assert got.is_positive_strand == want.is_positive_strand


@pytest.mark.parametrize(
    "fixture",
    [
        "tumor.chr20.tough.sam",
        "normal.chr20.tough.sam",
        "same_start_reads.sam",
        "rna_chr17_41244936.sam",
        "gatk_mini_bundle_extract.bam",
    ],
)
def test_build_events_native_matches_oracle(fixture, resources_dir):
    """columnar_from_reads(native=True) — the SAM/object ingest path that
    fills event arrays with guac_build_events — must be bit-identical to
    the pure-Python oracle (native=False)."""
    from guacamole.loci.lociset import parse_loci
    from guacamole.runtime.native import load_library

    # A stale libguac_runtime.so without guac_build_events would make
    # columnar_from_reads(native=True) silently fall back to the oracle,
    # turning this into a vacuous oracle-vs-oracle comparison.
    lib = load_library()
    assert lib is not None and hasattr(lib, "guac_build_events"), (
        "native runtime lacks guac_build_events — rebuild native/ "
        "(make -C native)"
    )

    filters = InputFilters.create(overlaps_loci=parse_loci("all"))
    reads = load_read_set(resource_path(fixture), filters).mapped_reads
    oracle = columnar_from_reads(reads, native=False)
    fast = columnar_from_reads(reads, native=True)
    for field in (
        "ref_id", "start", "end", "mapq", "flags_", "mismatches",
        "sample_id", "seq_off", "seq", "qual", "cigar_off", "cigar_len",
        "cigar_op", "md_off", "md_text", "ev_off", "ev_kind", "ev_base",
        "ev_qual", "ev_mdref", "sp_read", "sp_offset", "sp_kind",
        "sp_payload_offset", "sp_payload_len", "sp_qual", "special_payload",
    ):
        np.testing.assert_array_equal(
            getattr(oracle, field), getattr(fast, field), err_msg=field
        )


@pytest.mark.parametrize(
    "fixture",
    [
        "tumor.chr20.tough.sam",
        "normal.chr20.tough.sam",
        "different_start_reads.sam",  # cigar-inconsistent read w/ MD tag
        "same_start_reads.sam",
        "rna_chr17_41244936.sam",
        "testrna.sam",
        "mdtagissue.sam",
    ],
)
def test_decode_sam_native_matches_oracle(fixture, resources_dir):
    """The native SAM text decoder must produce the same columnar content
    as the Python loader + oracle event builder (mapped reads)."""
    from guacamole.runtime.columnar import decode_sam_columnar

    native = decode_sam_columnar(resource_path(fixture))
    assert native is not None
    read_set = load_read_set(resource_path(fixture), InputFilters.empty)
    mapped = [r.as_mapped_read for r in read_set.reads if r.is_mapped]
    oracle = columnar_from_reads(mapped)
    nm = native.select(native.is_mapped_mask).compact()
    assert nm.n == oracle.n
    for field in (
        "start", "end", "mapq", "mismatches", "seq_off", "seq", "qual",
        "cigar_off", "cigar_len", "cigar_op", "md_off", "md_text",
        "ev_off", "ev_kind", "ev_base", "ev_qual", "ev_mdref",
    ):
        np.testing.assert_array_equal(
            getattr(nm, field), getattr(oracle, field), err_msg=field
        )
    np.testing.assert_array_equal(
        nm.flags_ & 0x611, oracle.flags_ & 0x611
    )  # paired/reverse/dup/vendor bits
    assert [nm.samples[i] for i in nm.sample_id] == [
        oracle.samples[i] for i in oracle.sample_id
    ]
    assert [nm.ref_names[i] for i in nm.ref_id] == [
        oracle.ref_names[i] for i in oracle.ref_id
    ]

    def norm(c):
        out = []
        for i in range(len(c.sp_read)):
            lo = int(c.sp_payload_offset[i])
            pl = bytes(c.special_payload[lo : lo + int(c.sp_payload_len[i])])
            out.append(
                (int(c.sp_read[i]), int(c.sp_offset[i]), int(c.sp_kind[i]),
                 pl, int(c.sp_qual[i]))
            )
        return sorted(out)

    assert norm(nm) == norm(oracle)


# ---- hostile/corrupt-input hardening (advisor round-2 findings) ----

SAM_HEADER = "@SQ\tSN:chr1\tLN:10000\n"


def _sam_line(qname="r", flag=0, pos=100, cigar="10M", seq="ACGTACGTAC",
              qual="IIIIIIIIII", tags=""):
    line = (
        f"{qname}\t{flag}\tchr1\t{pos}\t60\t{cigar}\t*\t0\t0\t{seq}\t{qual}"
    )
    if tags:
        line += "\t" + tags
    return line + "\n"


def _decode_sam_text(tmp_path, text):
    from guacamole.runtime.native import decode_sam_native

    p = tmp_path / "hostile.sam"
    p.write_text(text)
    return decode_sam_native(str(p))


def test_sam_negative_cigar_length_rejected(tmp_path):
    """'-5M' must be a parse error, not a negative event span (which used
    to drive a negative-span memset and corrupt the heap)."""
    text = SAM_HEADER + _sam_line(cigar="-5M") + _sam_line(qname="r2")
    assert _decode_sam_text(tmp_path, text) is None
    # single hostile read: previously threw std::length_error through the
    # C ABI and killed the process
    assert _decode_sam_text(tmp_path, SAM_HEADER + _sam_line(cigar="-5M")) is None


def test_sam_oversized_cigar_length_rejected(tmp_path):
    text = SAM_HEADER + _sam_line(cigar="99999999999999M")
    assert _decode_sam_text(tmp_path, text) is None


def test_sam_duplicate_md_tags_use_first(tmp_path):
    """Two MD:Z tags on one record must not desynchronize the MD column of
    later reads (only the first is kept)."""
    text = (
        SAM_HEADER
        + _sam_line(qname="a", tags="MD:Z:10\tMD:Z:5A4")
        + _sam_line(qname="b", pos=200, tags="MD:Z:4C5")
    )
    out = _decode_sam_text(tmp_path, text)
    assert out is not None
    md_off, md_text = out["md_off"], out["md_text"]
    mds = [
        bytes(md_text[md_off[i]: md_off[i + 1]]).decode()
        for i in range(len(md_off) - 1)
    ]
    assert mds == ["10", "4C5"]
    # and the second read's mismatch count reflects ITS OWN tag
    np.testing.assert_array_equal(out["mismatches"], [0, 1])


def test_sam_low_qual_char_rejected(tmp_path):
    text = SAM_HEADER + _sam_line(qual="IIII IIIII")  # space < '!'
    assert _decode_sam_text(tmp_path, text) is None


def test_base_quality_string_low_char_raises():
    from guacamole.reads.read import base_quality_string_to_bytes

    with pytest.raises(ValueError):
        base_quality_string_to_bytes("III III", 7)
    assert base_quality_string_to_bytes("", 4) == bytes(4)
    assert base_quality_string_to_bytes("!I", 2) == bytes([0, 40])


def test_sam_zero_span_read_with_md_counts_mismatches(tmp_path):
    """A cigar-consistent zero-reference-span read with an MD tag: the MD
    pass must still run (matching the BAM decoder's phase 2 and the Python
    oracle), even though there are no events to build."""
    text = (
        SAM_HEADER
        + _sam_line(qname="z", cigar="10I", tags="MD:Z:0")
        + _sam_line(qname="b", pos=200, tags="MD:Z:4C5")
    )
    out = _decode_sam_text(tmp_path, text)
    assert out is not None
    np.testing.assert_array_equal(out["mismatches"], [0, 1])
