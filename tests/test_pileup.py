"""Pileup engine tests: element advance through M/I/D/N/S/H/=/X CIGARs.

Scenario coverage ported from the reference's pileup suite behaviors
(cf. upstream .../pileup/PileupSuite.scala:51-430).
"""

import pytest

from guacamole.gio.load import load_read_set
from guacamole.pileup.element import (
    AlignmentKind,
    InvalidCigarElementError,
    PileupElement,
)
from guacamole.pileup.pileup import Pileup
from guacamole.utils import bases as Bases
from guacamole.variants.allele import Allele

from conftest import resource_path
from fixtures import make_test_read


def element_at(read, locus):
    return PileupElement.at_locus(
        read, locus, read.get_reference_base_at_locus(locus)
    )


def advance(element, locus):
    return element.advance_to_locus(
        locus, element.read.get_reference_base_at_locus(locus)
    )


def load_pileup(filename, locus=0):
    reads = load_read_set(resource_path(filename)).mapped_reads
    return Pileup.from_reads(reads, reads[0].reference_contig, locus)


class TestInsertions:
    def reads(self, quals=None):
        kw = {"quality_scores": quals} if quals else {}
        return [
            make_test_read("TCGATCGA", "8M", "8", 1, **kw),
            make_test_read("TCGATCGA", "8M", "8", 1, **kw),
            make_test_read("TCGACCCTCGA", "4M3I4M", "8", 1, **kw),
        ]

    def test_pileup_before_reads(self):
        assert Pileup.from_reads(self.reads(), "chr1", 0).depth == 0

    def test_pileup_at_first_locus(self):
        pileup = Pileup.from_reads(self.reads(), "chr1", 1)
        assert all(e.is_match for e in pileup.elements)
        assert all(e.quality_score == 31 for e in pileup.elements)

    def test_insertion_anchored_to_preceding_base(self):
        pileup = Pileup.from_reads(self.reads(), "chr1", 4)
        assert any(e.is_insertion for e in pileup.elements)
        assert all(e.quality_score == 31 for e in pileup.elements)
        a0, a1, a2 = [e.alignment for e in pileup.elements]
        assert a0.kind is AlignmentKind.MATCH and a0.sequenced_bases == b"A"
        assert a1.kind is AlignmentKind.MATCH and a1.sequenced_bases == b"A"
        assert a2.kind is AlignmentKind.INSERTION
        assert a2.sequenced_bases == b"ACCC"
        assert a2.insertion_qualities == bytes([31, 31, 31, 31])

    def test_insertion_quality_is_min(self):
        quals_m = [10, 15, 20, 25, 10, 15, 20, 25]
        quals_i = [10, 15, 20, 25, 5, 5, 5, 10, 15, 20, 25]
        reads = [
            make_test_read("TCGATCGA", "8M", "8", 1, quality_scores=quals_m),
            make_test_read("TCGATCGA", "8M", "8", 1, quality_scores=quals_m),
            make_test_read(
                "TCGACCCTCGA", "4M3I4M", "8", 1, quality_scores=quals_i
            ),
        ]
        pileup = Pileup.from_reads(reads, "chr1", 4)
        assert any(e.is_insertion for e in pileup.elements)
        assert any(e.quality_score == 5 for e in pileup.elements)
        for e in pileup.elements:
            a = e.alignment
            if a.kind is AlignmentKind.MATCH:
                assert a.base_quality == 25
            elif a.kind is AlignmentKind.INSERTION:
                assert list(a.insertion_qualities) == [25, 5, 5, 5]
            else:
                pytest.fail(f"unexpected alignment {a}")
        # right after the insertion: all matches with base qual 10
        after = Pileup.from_reads(reads, "chr1", 5)
        assert all(e.is_match for e in after.elements)
        assert all(e.quality_score == 10 for e in after.elements)

    def test_after_insertion(self):
        pileup = Pileup.from_reads(self.reads(), "chr1", 7)
        assert all(e.sequenced_bases == b"G" for e in pileup.elements)
        assert all(e.is_match for e in pileup.elements)

    def test_end_of_read(self):
        quals_m = [10, 15, 20, 25, 10, 15, 20, 25]
        quals_i = [10, 15, 20, 25, 5, 5, 5, 10, 15, 20, 25]
        reads = [
            make_test_read("TCGATCGA", "8M", "8", 1, quality_scores=quals_m),
            make_test_read("TCGATCGA", "8M", "8", 1, quality_scores=quals_m),
            make_test_read(
                "TCGACCCTCGA", "4M3I4M", "8", 1, quality_scores=quals_i
            ),
        ]
        pileup = Pileup.from_reads(reads, "chr1", 8)
        assert all(e.sequenced_bases == b"A" for e in pileup.elements)
        assert all(e.is_match for e in pileup.elements)
        assert all(e.quality_score == 25 for e in pileup.elements)

    def test_insertion_at_contig_start_includes_trailing_base(self):
        read = make_test_read("AAAAAACGT", "5I4M", "4", 0)
        elem = element_at(read, 0)
        a = elem.alignment
        assert a.kind is AlignmentKind.INSERTION
        assert a.sequenced_bases == b"AAAAAA"
        assert list(a.insertion_qualities) == [31] * 6

    def test_alignment_at_insertion_cigar_element_throws(self):
        read = make_test_read("AAAAAACGT", "5I4M", "4", 0)
        elem = PileupElement(
            read=read,
            locus=1,
            reference_base=Bases.N,
            read_position=0,
            cigar_element_index=0,
            cigar_element_locus=1,
            index_within_cigar_element=0,
        )
        with pytest.raises(InvalidCigarElementError):
            _ = elem.alignment


class TestElementAdvance:
    def test_element_creation(self):
        read = make_test_read("AATTG", "5M", "5", 0)
        first = element_at(read, 0)
        assert first.is_match and first.index_within_cigar_element == 0
        second = advance(first, 1)
        assert second.is_match and second.index_within_cigar_element == 1
        third = advance(second, 2)
        assert third.is_match and third.index_within_cigar_element == 2

    def test_multiple_cigar_elements(self):
        read = make_test_read("AAATTT", "3M3M", "6", 0)
        second_match = element_at(read, 3)
        assert second_match.is_match
        assert second_match.index_within_cigar_element == 0
        second_second = element_at(read, 4)
        assert second_second.is_match
        assert second_second.index_within_cigar_element == 1

    def test_deletion_elements(self):
        read = make_test_read("AATTGAATTG", "5M1D5M", "5^C5", 0)
        first = element_at(read, 0)
        assert first.is_match and first.index_within_cigar_element == 0

        deletion = advance(first, 4)
        a = deletion.alignment
        assert a.kind is AlignmentKind.DELETION
        assert a.reference_bases == b"GC"
        assert a.sequenced_bases == b"G"
        assert deletion.index_within_cigar_element == 4

        mid = advance(deletion, 5)
        assert mid.is_mid_deletion
        assert mid.index_within_cigar_element == 0

        past = advance(mid, 6)
        assert past.is_match and past.index_within_cigar_element == 0

        cont = advance(past, 9)
        assert cont.is_match and cont.index_within_cigar_element == 3

    def test_advance_same_locus_noop_and_rewind_fails(self):
        read = make_test_read("AATTG", "5M", "5", 0)
        elem = element_at(read, 2)
        same = advance(elem, 2)
        assert same.locus == elem.locus
        assert same.read_position == elem.read_position
        with pytest.raises(AssertionError):
            advance(elem, 1)
        with pytest.raises(AssertionError):
            advance(elem, 5)


class TestDifferentStartReads:
    @pytest.fixture(scope="class")
    def reads(self, resources_dir):
        return load_read_set(
            resource_path("different_start_reads.sam")
        ).mapped_reads

    def test_read1_basic(self, reads):
        # read1: start SAM:6 -> 0-based 5, CIGAR 29M10D31M, length 70
        read1 = reads[0]
        with pytest.raises(AssertionError):
            element_at(read1, 0)
        with pytest.raises(AssertionError):
            element_at(read1, 4)
        with pytest.raises(AssertionError):
            element_at(read1, 5 + 70)
        at5 = element_at(read1, 5)
        assert at5.sequenced_bases == b"A"
        assert element_at(read1, 74) is not None
        with pytest.raises(AssertionError):
            element_at(read1, 75)
        # just before the deletion
        deletion = element_at(read1, 5 + 28)
        assert deletion.alignment.kind is AlignmentKind.DELETION
        assert deletion.alignment.reference_bases == b"AGGGGGGGGGG"
        # inside the deletion
        assert element_at(read1, 5 + 29).sequenced_bases == b""
        assert element_at(read1, 5 + 38).sequenced_bases == b""
        # just after
        assert element_at(read1, 5 + 39).sequenced_bases == b"A"

    def test_read3_advance(self, reads):
        read3 = reads[2]
        at15 = element_at(read3, 15)
        assert at15.sequenced_bases == b"A"
        assert advance(at15, 16).sequenced_bases == b"T"
        assert advance(at15, 17).sequenced_bases == b"C"
        assert advance(advance(at15, 16), 17).sequenced_bases == b"C"
        assert advance(at15, 18).sequenced_bases == b"G"

    def test_read4_insertion(self, reads):
        # read4: CIGAR 10M10I10D40M, ACGT repeated 15 times
        read4 = reads[3]
        at20 = element_at(read4, 20)
        for i in range(2):
            assert advance(at20, 20 + i * 4 + 0).sequenced_bases[0] == ord("A")
            assert advance(at20, 20 + i * 4 + 1).sequenced_bases[0] == ord("C")
            assert advance(at20, 20 + i * 4 + 2).sequenced_bases[0] == ord("G")
            assert advance(at20, 20 + i * 4 + 3).sequenced_bases[0] == ord("T")
        at29 = advance(at20, 20 + 9)
        assert at29.is_insertion
        assert at29.sequenced_bases == b"CGTACGTACGT"

    def test_read5_eq_and_x_ops(self, reads):
        # read5: ACGTACGTACGTACG, 5M4=1X5=, [10, 25)
        read5 = reads[4]
        at10 = element_at(read5, 10)
        assert advance(at10, 10).sequenced_bases == b"A"
        assert advance(at10, 14).sequenced_bases == b"A"
        assert advance(at10, 18).sequenced_bases == b"A"
        assert advance(at10, 19).sequenced_bases == b"C"
        assert advance(at10, 20).sequenced_bases == b"G"
        assert advance(at10, 21).sequenced_bases == b"T"
        assert advance(at10, 22).sequenced_bases == b"A"
        assert advance(at10, 24).sequenced_bases == b"G"

    def test_read6_n_and_soft_clip(self, reads):
        # read6: ACGTACGTACGT 4=1N4=4S
        read6 = reads[5]
        at40 = element_at(read6, 40)
        assert advance(at40, 40).sequenced_bases == b"A"
        assert advance(at40, 41).sequenced_bases == b"C"
        assert advance(at40, 42).sequenced_bases == b"G"
        assert advance(at40, 43).sequenced_bases == b"T"
        assert advance(at40, 44).sequenced_bases == b""  # in the N gap
        assert advance(at40, 45).sequenced_bases == b"A"
        assert advance(at40, 48).sequenced_bases == b"T"
        with pytest.raises(AssertionError):
            advance(at40, 49)

    def test_read7_n_and_hard_clip(self, reads):
        read7 = reads[6]
        at40 = element_at(read7, 40)
        assert advance(at40, 44).sequenced_bases == b""
        assert advance(at40, 45).sequenced_bases == b"A"
        assert advance(at40, 48).sequenced_bases == b"T"
        with pytest.raises(AssertionError):
            advance(at40, 49)


class TestRnaReads:
    def test_rna_read_advance_through_intron(self):
        read = make_test_read(
            "CCCCAGCCTAGGCCTTCGACACTGGGGGGCTGAGGGAAGGGGCACCTGCC",
            "7M191084N43M",
            "9T24T7G7",
            start=229538779,
        )
        elem = PileupElement.at_locus(read, 229538779, Bases.C)
        assert advance(elem, 229538780).sequenced_bases == b"C"
        assert advance(elem, 229538781).sequenced_bases == b"C"
        # in the intron (N gap): clipped, no sequenced bases
        assert advance(elem, 229539779).sequenced_bases == b""
        # last base
        assert advance(elem, 229729912).sequenced_bases == b"C"

    def test_rna_pileup(self, resources_dir):
        pileup = load_pileup("testrna.sam", locus=229580594)
        assert pileup.depth == 94
        moved = pileup.at_greater_locus(229580706, Bases.A, iter([]))
        assert moved.depth == 4
        assert moved.at_greater_locus(229580707, Bases.N, iter([])).depth == 1


class TestSameStartReads:
    def test_pileup_from_sam(self, resources_dir):
        pileup = load_pileup("same_start_reads.sam", 0)
        assert pileup.depth == 10

    def test_first_60_loci_have_all_10_reads(self, resources_dir):
        pileup = load_pileup("same_start_reads.sam", 0)
        for i in range(1, 60):
            next_pileup = pileup.at_greater_locus(i, Bases.N, iter([]))
            assert next_pileup.depth == 10

    def test_deletion_in_half_the_reads(self, resources_dir):
        pileup = load_pileup("same_start_reads.sam", 0)
        deletion_pileup = pileup.at_greater_locus(9, Bases.A, iter([]))
        deletion_count = 0
        for e in deletion_pileup.elements:
            if e.alignment.kind is AlignmentKind.DELETION:
                assert e.alignment.reference_bases == b"AAAAAAAAAAA"
                deletion_count += 1
        assert deletion_count == 5
        for i in range(10, 20):
            next_pileup = pileup.at_greater_locus(i, Bases.N, iter([]))
            assert sum(1 for e in next_pileup.elements if e.is_mid_deletion) == 5

    def test_loci_60_to_69_have_5_reads(self, resources_dir):
        pileup = load_pileup("same_start_reads.sam", 0)
        for i in range(60, 70):
            assert pileup.at_greater_locus(i, Bases.N, iter([])).depth == 5


class TestMidDeletionAlleles:
    def test_deletion_and_mid_deletion_alleles(self):
        reads = [
            make_test_read("TCGAAAAGCT", "5M6D5M", "5^GCTTCG5", 0)
            for _ in range(3)
        ]
        deletion_pileup = Pileup.from_reads(reads, "chr1", 4)
        alleles = deletion_pileup.distinct_alleles
        assert len(alleles) == 1
        assert alleles[0] == Allele.from_strings("AGCTTCG", "A")

        mid = Pileup.from_reads(reads, "chr1", 5)
        mid_alleles = mid.distinct_alleles
        assert len(mid_alleles) == 1
        assert mid_alleles[0] == Allele.from_strings("G", "")
