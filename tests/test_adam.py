"""ADAM Parquet I/O tests.

Mirrors the reference's ADAM round-trip test ("load read from ADAM",
upstream .../reads/ReadSetSuite.scala:88-109): save reads loaded
from mdtagissue.sam as ADAM Parquet, reload through the generic loader,
and check counts/filters/token propagation. Plus genotype Parquet output
(Common.scala:295-303 adamParquetSave equivalent).
"""

import pytest

pytest.importorskip("pyarrow")

from guacamole.gio.adam import (
    read_adam,
    read_genotypes_parquet,
    write_adam,
    write_genotypes_parquet,
)
from guacamole.gio.load import load_read_set, load_reads
from guacamole.gio.vcf import VcfRecord
from guacamole.reads.read import InputFilters

from conftest import resource_path


@pytest.fixture()
def adam_path(resources_dir, tmp_path):
    reads, dictionary = load_reads(resource_path("mdtagissue.sam"))
    out = str(tmp_path / "mdtagissue.adam")
    write_adam(out, reads, dictionary)
    return out


def test_adam_round_trip_counts(adam_path):
    all_reads, dictionary = read_adam(adam_path)
    assert len(all_reads) == 8
    # ReadSetSuite.scala:101-108: mapped + nonDuplicate with token 1.
    filtered = load_read_set(
        adam_path,
        InputFilters.create(mapped=True, non_duplicate=True),
        token=1,
    )
    assert len(filtered.reads) == 3
    assert all(r.token == 1 for r in filtered.reads)


def test_adam_round_trip_field_parity(adam_path, resources_dir):
    orig, _ = load_reads(resource_path("mdtagissue.sam"))
    back, _ = load_reads(adam_path)
    assert len(orig) == len(back)

    def key(read):
        mapped = read.as_mapped_read
        return (
            read.sequence,
            bytes(read.base_qualities),
            read.is_duplicate,
            read.sample_name,
            read.failed_vendor_quality_checks,
            read.is_paired,
            None
            if mapped is None
            else (
                mapped.reference_contig,
                mapped.start,
                str(mapped.cigar),
                mapped.alignment_quality,
                mapped.mdtag.tag if mapped.mdtag else None,
                mapped.is_positive_strand,
            ),
        )

    assert sorted(map(key, orig)) == sorted(map(key, back))


def test_adam_sequence_dictionary_aggregation(adam_path):
    _, dictionary = read_adam(adam_path)
    # Aggregated from the records' contig structs (Read.scala:470).
    assert dictionary.get("2") == 243199373


def test_genotype_parquet_round_trip(tmp_path):
    records = [
        VcfRecord(
            contig="chrM",
            start=72,
            ref="G",
            alt="A",
            sample_name="s1",
            genotype=("Ref", "Alt"),
            read_depth=30,
            reference_read_depth=14,
            alternate_read_depth=16,
            genotype_quality=99,
        )
    ]
    out = str(tmp_path / "genotypes.adam")
    write_genotypes_parquet(records, out)
    rows = read_genotypes_parquet(out)
    assert len(rows) == 1
    row = rows[0]
    assert row["variant"]["contig"]["contigName"] == "chrM"
    assert row["variant"]["start"] == 72
    assert row["variant"]["end"] == 73
    assert row["variant"]["referenceAllele"] == "G"
    assert row["variant"]["alternateAllele"] == "A"
    assert row["alleles"] == ["Ref", "Alt"]
    assert row["readDepth"] == 30
    assert row["alternateReadDepth"] == 16
    assert abs(row["expectedAlleleDosage"] - 16 / 30) < 1e-6


def test_write_variants_dispatches_parquet(tmp_path):
    from guacamole.callers.common import write_variants

    records = [
        VcfRecord(contig="chrM", start=10, ref="C", alt="T", read_depth=5,
                  reference_read_depth=2, alternate_read_depth=3)
    ]
    out = str(tmp_path / "calls.genotypes.adam")
    write_variants(records, out)
    rows = read_genotypes_parquet(out)
    assert len(rows) == 1 and rows[0]["variant"]["start"] == 10


def test_avro_schema_metadata_embedded(adam_path, tmp_path):
    """ADAM-era interop: the Parquet footer must carry the bdg-formats
    Avro schema under the keys parquet-avro readers look for
    ('parquet.avro.schema' + legacy 'avro.schema'), with the record
    names/namespace and field list matching the Parquet columns."""
    import json
    import os

    import pyarrow.parquet as pq

    part = os.path.join(adam_path, "part-r-00000.parquet")
    meta = pq.read_schema(part).metadata
    assert b"parquet.avro.schema" in meta
    assert b"avro.schema" in meta
    assert meta[b"writer.model.name"] == b"avro"
    schema = json.loads(meta[b"parquet.avro.schema"].decode())
    assert schema["name"] == "AlignmentRecord"
    assert schema["namespace"] == "org.bdgenomics.formats.avro"
    avro_fields = [f["name"] for f in schema["fields"]]
    parquet_fields = [f.name for f in pq.read_schema(part)]
    assert avro_fields == parquet_fields
    # Every field is a bdg-style nullable union with default null.
    for f in schema["fields"]:
        assert isinstance(f["type"], list) and f["type"][0] == "null"
        assert f["default"] is None

    # Genotype output carries its schema too.
    from guacamole.gio.adam import write_genotypes_parquet

    class _Rec:
        contig = "chr1"
        start = 5
        ref = "A"
        alt = "T"
        sample_name = "s"
        genotype = ("Ref", "Alt")
        genotype_quality = 30
        read_depth = 10
        reference_read_depth = 6
        alternate_read_depth = 4

    out = str(tmp_path / "genotypes.adam")
    write_genotypes_parquet([_Rec()], out)
    gmeta = pq.read_schema(
        os.path.join(out, "part-r-00000.parquet")
    ).metadata
    gschema = json.loads(gmeta[b"parquet.avro.schema"].decode())
    assert gschema["name"] == "Genotype"
    assert gschema["namespace"] == "org.bdgenomics.formats.avro"
