import pytest

from guacamole.reads.cigar import Cigar
from guacamole.reads.mdtag import (
    MdTag,
    build_md_tag,
    get_reference,
    reference_from_reads,
)
from guacamole.reads.read import make_read


def test_all_match():
    md = MdTag("8", 0, Cigar.from_string("8M"))
    assert md.mismatches == {}
    assert md.deletions == {}
    assert md.count_of_mismatches == 0


def test_mismatches():
    md = MdTag("0A3T1", 10, Cigar.from_string("6M"))
    assert md.mismatches == {10: ord("A"), 14: ord("T")}
    assert md.count_of_mismatches == 2


def test_deletion():
    md = MdTag("4^CC4", 5, Cigar.from_string("4M2D4M"))
    assert md.deletions == {9: ord("C"), 10: ord("C")}
    assert md.mismatches == {}


def test_insertion_does_not_consume_md():
    md = MdTag("8", 0, Cigar.from_string("4M2I4M"))
    assert md.mismatches == {} and md.deletions == {}


def test_splice_gap():
    # N gaps are not covered by the MD tag: reference positions skip ahead.
    md = MdTag("4T3", 0, Cigar.from_string("4M10N4M"))
    assert md.mismatches == {14: ord("T")}


def test_get_reference_match():
    cigar = Cigar.from_string("8M")
    md = MdTag("8", 0, cigar)
    assert get_reference(md, b"ACGTACGT", cigar, True) == b"ACGTACGT"


def test_get_reference_mismatch():
    cigar = Cigar.from_string("5M")
    md = MdTag("2T2", 0, cigar)
    assert get_reference(md, b"AATAA", cigar, True) == b"AATAA"[:2] + b"T" + b"AA"
    md2 = MdTag("0G4", 0, cigar)
    assert get_reference(md2, b"AATAA", cigar, True) == b"GATAA"


def test_get_reference_deletion():
    cigar = Cigar.from_string("3M2D3M")
    md = MdTag("3^GG3", 0, cigar)
    assert get_reference(md, b"ACTACT", cigar, True) == b"ACTGGACT"


def test_get_reference_insertion():
    cigar = Cigar.from_string("3M2I3M")
    md = MdTag("6", 0, cigar)
    assert get_reference(md, b"ACTGGACT"[:8], cigar, True) == b"ACTACT"


def test_get_reference_splice():
    cigar = Cigar.from_string("3M2N3M")
    md = MdTag("6", 0, cigar)
    assert get_reference(md, b"ACTACT", cigar, True) == b"ACTNNACT"


def test_build_md_tag_roundtrip():
    cigar = Cigar.from_string("3M2D3M")
    ref = b"ACTGGACT"
    read = b"ACTACT"
    tag = build_md_tag(read, ref, cigar)
    assert tag == "3^GG3"
    md = MdTag(tag, 0, cigar)
    assert get_reference(md, read, cigar, True) == ref


def test_build_md_tag_mismatch():
    cigar = Cigar.from_string("5M")
    assert build_md_tag(b"AATAA", b"AAGAA", cigar) == "2G2"
    assert build_md_tag(b"TATAT", b"TATAT", cigar) == "5"


def test_reference_from_reads_with_gap():
    # Two reads with a gap between them: gap is N-padded.
    read1 = make_read("ACGT", cigar_string="4M", mdtag="4", start=0)
    read2 = make_read("TTTT", cigar_string="4M", mdtag="4", start=6)
    ref = reference_from_reads([read1, read2], 0, 10)
    assert ref == b"ACGTNNTTTT"


def test_reference_from_reads_overlapping():
    read1 = make_read("ACGTACGT", cigar_string="8M", mdtag="8", start=0)
    read2 = make_read("GTACGTTT", cigar_string="8M", mdtag="8", start=2)
    ref = reference_from_reads([read1, read2], 0, 10)
    assert ref == b"ACGTACGTTT"


def test_mismatch_count_in_read():
    read = make_read("TCGATCGA", cigar_string="8M", mdtag="0C0C6", start=0)
    assert read.mdtag.count_of_mismatches == 2
    assert read.mdtag_reference_bases == b"CCGATCGA"
    assert read.get_reference_base_at_locus(0) == ord("C")
    assert read.get_reference_base_at_locus(4) == ord("T")
