"""I/O layer tests against the real SAM/BAM/FASTA fixtures.

Expected counts ported from the reference test suite behaviors
(cf. upstream .../ReadSetSuite.scala:69-86 etc.).
"""

import os

import pytest

from guacamole.gio.bam import BamFile
from guacamole.gio.bgzf import BgzfReader, BgzfWriter
from guacamole.gio.fasta import ReferenceGenome, get_gc_fraction
from guacamole.gio.load import load_read_set
from guacamole.loci.lociset import parse_loci
from guacamole.reads.read import InputFilters

from conftest import resource_path


def test_load_sam_and_filters(resources_dir):
    all_reads = load_read_set(resource_path("mdtagissue.sam"))
    assert len(all_reads.reads) == 8

    mapped = load_read_set(
        resource_path("mdtagissue.sam"), InputFilters.create(mapped=True)
    )
    assert len(mapped.reads) == 5

    non_duplicate = load_read_set(
        resource_path("mdtagissue.sam"),
        InputFilters.create(mapped=True, non_duplicate=True),
    )
    assert len(non_duplicate.reads) == 3


def test_load_rna_reads(resources_dir):
    read_set = load_read_set(resource_path("rna_chr17_41244936.sam"))
    assert len(read_set.reads) == 23


def test_token_assignment(resources_dir):
    read_set = load_read_set(
        resource_path("mdtagissue.sam"),
        InputFilters.create(mapped=True, non_duplicate=True),
        token=1,
    )
    assert all(r.token == 1 for r in read_set.reads)


def test_bam_header_chrm(resources_dir):
    bam = BamFile(resource_path("chrM.sorted.bam"))
    assert ("chrM", 16571) in bam.references
    assert bam.header.contig_lengths["chrM"] == 16571


def test_load_chrm_bam(resources_dir):
    read_set = load_read_set(resource_path("chrM.sorted.bam"))
    reads = read_set.mapped_reads
    assert len(reads) > 1000
    assert all(r.reference_contig == "chrM" for r in reads)
    # sorted by start (it's chrM.sorted.bam)
    starts = [r.start for r in reads]
    assert starts == sorted(starts)
    # all within the contig
    assert all(0 <= r.start and r.end <= 16571 for r in reads)


def test_chrm_bam_loci_filter(resources_dir):
    filters = InputFilters.create(
        overlaps_loci=parse_loci("chrM:3000-5000"), non_duplicate=True, has_mdtag=True
    )
    read_set = load_read_set(resource_path("chrM.sorted.bam"), filters)
    for read in read_set.mapped_reads:
        assert read.start < 5000
        assert read.start + read.cigar.reference_length > 3000
        assert read.mdtag is not None


def test_bam_matches_sam_on_gatk_bundle(resources_dir):
    """Cross-format equivalence: BAM and (generated) SAM views of the same
    records decode identically (cf. ReadSetSuite cross-API test)."""
    bam_reads = load_read_set(resource_path("gatk_mini_bundle_extract.bam"))
    assert len(bam_reads.reads) > 0
    # With index-backed loci query vs without must agree.
    loci_filter = InputFilters.create(
        overlaps_loci=parse_loci("20:10220390-10220490")
    )
    with_index = load_read_set(
        resource_path("gatk_mini_bundle_extract.bam"), loci_filter
    )
    # Index file exists for this fixture, so the chunk path was used; compare
    # against brute-force post-filtering of the full scan.
    full = load_read_set(resource_path("gatk_mini_bundle_extract.bam"))
    loci = loci_filter.overlaps_loci.result(full.sequence_dictionary)
    brute = [
        r
        for r in full.reads
        if r.is_mapped
        and loci.on_contig(r.as_mapped_read.reference_contig).intersects(
            r.as_mapped_read.start,
            r.as_mapped_read.start + r.as_mapped_read.cigar.reference_length,
        )
    ]
    key = lambda r: (
        r.as_mapped_read.reference_contig,
        r.as_mapped_read.start,
        bytes(r.sequence),
        str(r.as_mapped_read.cigar),
    )
    assert sorted(map(key, with_index.reads)) == sorted(map(key, brute))


def test_bgzf_roundtrip(tmp_path):
    path = str(tmp_path / "test.bgzf")
    payload = b"hello bgzf world " * 10000
    with BgzfWriter(path) as w:
        w.write(payload)
    reader = BgzfReader(path)
    assert reader.read_all() == payload


def test_fasta_reading(resources_dir):
    ref = ReferenceGenome.from_fasta(resource_path("sample.fasta"))
    assert len(ref.contigs) > 0
    for name, seq in ref.contigs.items():
        assert len(seq) > 0
        assert seq == seq.upper()


def test_fasta_chrm(resources_dir):
    ref = ReferenceGenome.from_fasta(
        resource_path("human_GRCh37_75_dna_chrMT.fasta")
    )
    (name,) = ref.contigs.keys()
    assert len(ref.get_contig(name)) == 16569  # GRCh37 MT length
    gc = get_gc_fraction(ref.get_contig(name))
    assert 0.3 < gc < 0.6


def test_md_reconstruction_consistent_across_reads(resources_dir):
    """Reference bases reconstructed from MD tags must agree between
    overlapping reads: at any locus, every read's reconstructed reference
    base (excluding N placeholders) must be identical.

    (The bundled FASTA is GRCh37 MT, a *different* mitochondrial reference
    than the hg19 chrM these reads align to, so cross-read consistency is
    the right oracle here.)
    """
    read_set = load_read_set(
        resource_path("chrM.sorted.bam"), InputFilters.create(has_mdtag=True)
    )
    by_locus = {}
    checked = 0
    for read in read_set.mapped_reads[:500]:
        rebuilt = read.mdtag_reference_bases
        for offset, base in enumerate(rebuilt):
            if base == ord("N"):
                continue
            locus = read.start + offset
            prev = by_locus.get(locus)
            if prev is None:
                by_locus[locus] = base
            else:
                assert prev == base, (
                    f"Reads disagree on reference base at locus {locus}"
                )
                checked += 1
    assert checked > 10000


def test_paired_read_mate_properties(resources_dir):
    read_set = load_read_set(resource_path("gatk_mini_bundle_extract.bam"))
    paired = read_set.mapped_paired_reads
    assert len(paired) > 0
    for p in paired:
        if p.mate_alignment_properties is not None:
            assert p.mate_alignment_properties.start >= 0
