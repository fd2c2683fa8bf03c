"""Test fixture builders, mirroring the reference suite's defaults
(base quality 31, alignment quality 30, contig chr1, start 1)."""

from typing import Optional, Sequence

from guacamole.reads.read import (
    MappedRead,
    MateAlignmentProperties,
    PairedRead,
    make_read,
)


def make_test_read(
    sequence: str,
    cigar: str,
    mdtag: Optional[str] = None,
    start: int = 1,
    chrom: str = "chr1",
    quality_scores: Optional[Sequence[int]] = None,
    alignment_quality: int = 30,
    sample_name: str = "",
    is_positive_strand: bool = True,
    token: int = 0,
    is_duplicate: bool = False,
) -> MappedRead:
    if quality_scores is not None:
        quals = "".join(chr(q + 33) for q in quality_scores)
    else:
        quals = "@" * len(sequence)  # '@' - 33 == 31
    return make_read(
        sequence,
        cigar_string=cigar,
        mdtag=mdtag,
        start=start,
        reference_contig=chrom,
        base_qualities=quals,
        alignment_quality=alignment_quality,
        sample_name=sample_name,
        is_positive_strand=is_positive_strand,
        token=token,
        is_duplicate=is_duplicate,
    )


def make_paired_read(
    chrom: str = "chr1",
    start: int = 1,
    alignment_quality: int = 30,
    is_positive_strand: bool = True,
    is_mate_mapped: bool = False,
    mate_reference_contig: Optional[str] = None,
    mate_start: Optional[int] = None,
    is_mate_positive_strand: bool = False,
    sequence: str = "ACTGACTGACTG",
    cigar: str = "12M",
    mdtag: str = "12",
    inferred_insert_size: Optional[int] = None,
) -> PairedRead:
    read = make_test_read(
        sequence,
        cigar,
        mdtag,
        start=start,
        chrom=chrom,
        alignment_quality=alignment_quality,
        is_positive_strand=is_positive_strand,
    )
    mate = (
        MateAlignmentProperties(
            reference_contig=mate_reference_contig or chrom,
            start=mate_start if mate_start is not None else 0,
            inferred_insert_size=inferred_insert_size,
            is_positive_strand=is_mate_positive_strand,
        )
        if is_mate_mapped
        else None
    )
    return PairedRead(read, is_first_in_pair=True, mate_alignment_properties=mate)
