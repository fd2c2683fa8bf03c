"""Serialization round-trips.

The reference ships Kryo serializers for every shuffled type
(cf. upstream .../Serialization.scala:27-51, MappedReadSerializer);
in this framework host-side objects cross process/host boundaries via
pickle and tiles via numpy buffers — these tests pin that both round-trip
losslessly (the ReadSetSuite serialize/deserialize analog)."""

import pickle

import numpy as np
import pytest

from guacamole.gio.load import load_read_set
from guacamole.loci.lociset import parse_loci
from guacamole.pack.tiles import pack_tile
from guacamole.reads.read import InputFilters
from guacamole.variants.allele import Allele, Genotype
from guacamole.variants.called import CalledAllele
from guacamole.variants.evidence import AlleleEvidence

from conftest import resource_path
from fixtures import make_paired_read, make_test_read


def roundtrip(obj):
    return pickle.loads(pickle.dumps(obj))


def test_mapped_read_roundtrip(resources_dir):
    reads = load_read_set(
        resource_path("mdtagissue.sam"), InputFilters.create(mapped=True)
    ).mapped_reads
    for read in reads:
        restored = roundtrip(read)
        assert restored.token == read.token
        assert restored.reference_contig == read.reference_contig
        assert restored.alignment_quality == read.alignment_quality
        assert restored.start == read.start
        assert restored.cigar == read.cigar
        assert restored.mdtag == read.mdtag
        assert (
            restored.failed_vendor_quality_checks
            == read.failed_vendor_quality_checks
        )
        assert restored.is_positive_strand == read.is_positive_strand
        assert restored.is_paired == read.is_paired
        assert restored == read


def test_paired_read_roundtrip():
    paired = make_paired_read(
        is_mate_mapped=True, mate_start=100, inferred_insert_size=112
    )
    restored = roundtrip(paired)
    assert restored == paired


def test_allele_genotype_roundtrip():
    allele = Allele.from_strings("A", "ACT")
    assert roundtrip(allele) == allele
    genotype = Genotype.of(allele, Allele.from_strings("A", "A"))
    assert roundtrip(genotype) == genotype


def test_called_allele_roundtrip():
    evidence = AlleleEvidence(
        likelihood=0.99,
        read_depth=30,
        allele_read_depth=15,
        forward_depth=16,
        allele_forward_depth=8,
        mean_mapping_quality=58.5,
        median_mapping_quality=60.0,
        mean_base_quality=33.0,
        median_base_quality=34.0,
        median_mismatches_per_read=1.0,
    )
    call = CalledAllele(
        sample_name="s1",
        reference_contig="chr1",
        start=100,
        allele=Allele.from_strings("T", "G"),
        evidence=evidence,
    )
    assert roundtrip(call) == call


def test_loci_structures_roundtrip():
    loci = parse_loci("chr1:100-200,chr2:5-10").result()
    assert roundtrip(loci) == loci
    from guacamole.loci.locimap import LociMapBuilder

    m = LociMapBuilder().put("chr1", 0, 10, 3).put("chr1", 10, 20, 4).result()
    assert roundtrip(m) == m


def test_tile_roundtrip():
    reads = [
        make_test_read("TCGATCGA", "8M", "8", 1),
        make_test_read("TCGCTCGA", "8M", "3A4", 1),
    ]
    tile = pack_tile(reads, "chr1", range(1, 9))
    restored = roundtrip(tile)
    np.testing.assert_array_equal(restored.allele_id, tile.allele_id)
    np.testing.assert_array_equal(restored.valid, tile.valid)
    assert restored.alleles == tile.alleles
