import pytest

from guacamole.loci.locimap import LociMapBuilder
from guacamole.loci.lociset import LociSet, LociSetBuilder, parse_loci
from guacamole.loci.partition import (
    partition_loci_by_approximate_depth,
    partition_loci_uniformly,
)
from guacamole.reads.read import make_read


def lengths(**kw):
    return dict(kw)


class TestLociSet:
    def test_parse_single_contig_range(self):
        loci = parse_loci("chr1:100-200").result()
        assert loci.contigs == ["chr1"]
        assert loci.count == 100
        assert loci.on_contig("chr1").contains(100)
        assert loci.on_contig("chr1").contains(199)
        assert not loci.on_contig("chr1").contains(200)
        assert not loci.on_contig("chr1").contains(99)

    def test_parse_multiple(self):
        loci = parse_loci("chr1:100-200,chr2:5-10,chr1:300-400").result()
        assert loci.contigs == ["chr1", "chr2"]
        assert loci.count == 100 + 5 + 100

    def test_parse_whole_contig_requires_lengths(self):
        builder = parse_loci("chr1")
        with pytest.raises(AssertionError):
            builder.result()
        loci = builder.result({"chr1": 1000})
        assert loci.count == 1000

    def test_parse_all_excludes_final_base(self):
        # Parity quirk: "all" covers [0, length-1) per contig.
        loci = parse_loci("all").result({"chr1": 100, "chr2": 50})
        assert loci.count == 99 + 49

    def test_invalid_contig(self):
        with pytest.raises(ValueError):
            parse_loci("chrX:1-5").result({"chr1": 10})

    def test_invalid_range(self):
        with pytest.raises(ValueError):
            parse_loci("chr1:5-50").result({"chr1": 10})

    def test_union_and_coalesce(self):
        a = LociSet.of("chr1", 0, 10)
        b = LociSet.of("chr1", 10, 20)
        u = a.union(b)
        assert u.count == 20
        assert u.on_contig("chr1").ranges == [(0, 20)]

    def test_overlapping_union(self):
        a = LociSet.of("chr1", 0, 15)
        b = LociSet.of("chr1", 10, 20)
        assert a.union(b).count == 20

    def test_intersects(self):
        loci = parse_loci("chr1:100-200").result()
        contig = loci.on_contig("chr1")
        assert contig.intersects(150, 160)
        assert contig.intersects(199, 300)
        assert contig.intersects(0, 101)
        assert not contig.intersects(200, 300)
        assert not contig.intersects(0, 100)

    def test_take(self):
        loci = parse_loci("chr1:0-10,chr2:0-10").result()
        first, second = loci.take(4)
        assert first.count == 4
        assert second.count == 16
        assert first.on_contig("chr1").ranges == [(0, 4)]
        first, second = loci.take(14)
        assert first.count == 14
        assert first.on_contig("chr2").ranges == [(0, 4)]

    def test_iterator(self):
        loci = parse_loci("chr1:0-3,chr1:8-10").result()
        assert list(loci.on_contig("chr1")) == [0, 1, 2, 8, 9]

    def test_iterator_skip_to(self):
        loci = parse_loci("chr1:0-5,chr1:10-15").result()
        it = loci.on_contig("chr1").iterator()
        it.skip_to(3)
        assert next(it) == 3
        it.skip_to(7)
        assert next(it) == 10
        it.skip_to(100)
        assert not it.has_next()

    def test_empty(self):
        assert LociSet.empty().count == 0
        assert LociSet.empty().is_empty
        assert parse_loci("").result().count == 0

    def test_string_roundtrip(self):
        loci = parse_loci("chr1:100-200,chr2:5-10").result()
        reparsed = parse_loci(str(loci)).result()
        assert reparsed == loci


class TestLociMap:
    def test_builder_coalescing(self):
        m = (
            LociMapBuilder()
            .put("chr1", 0, 10, "A")
            .put("chr1", 10, 20, "A")
            .put("chr1", 20, 30, "B")
            .result()
        )
        assert m.on_contig("chr1").items == [(0, 20, "A"), (20, 30, "B")]

    def test_get(self):
        m = LociMapBuilder().put("chr1", 5, 10, 7).result()
        contig = m.on_contig("chr1")
        assert contig.get(5) == 7
        assert contig.get(9) == 7
        assert contig.get(10) is None
        assert contig.get(4) is None

    def test_get_all(self):
        m = (
            LociMapBuilder()
            .put("chr1", 0, 10, 1)
            .put("chr1", 10, 20, 2)
            .put("chr1", 30, 40, 3)
            .result()
        )
        contig = m.on_contig("chr1")
        assert contig.get_all(5, 15) == {1, 2}
        assert contig.get_all(0, 100) == {1, 2, 3}
        assert contig.get_all(20, 30) == set()
        assert contig.get_all(25, 35) == {3}

    def test_overwrite_semantics(self):
        m = (
            LociMapBuilder()
            .put("chr1", 0, 20, "A")
            .put("chr1", 5, 10, "B")
            .result()
        )
        assert m.on_contig("chr1").items == [
            (0, 5, "A"),
            (5, 10, "B"),
            (10, 20, "A"),
        ]

    def test_inverse_map(self):
        m = (
            LociMapBuilder()
            .put("chr1", 0, 10, 0)
            .put("chr1", 10, 20, 1)
            .put("chr2", 0, 5, 0)
            .result()
        )
        inv = m.inverse_map()
        assert inv[0].count == 15
        assert inv[1].count == 10
        assert inv[0].on_contig("chr2").ranges == [(0, 5)]

    def test_count_and_contigs_sorted(self):
        m = (
            LociMapBuilder()
            .put("chrB", 0, 10, 1)
            .put("chrA", 0, 5, 1)
            .result()
        )
        assert m.contigs == ["chrA", "chrB"]
        assert m.count == 15


class TestPartitioning:
    def test_uniform_exact(self):
        loci = parse_loci("chr1:0-100").result()
        result = partition_loci_uniformly(2, loci)
        assert result.on_contig("chr1").items == [(0, 50, 0), (50, 100, 1)]

    def test_uniform_uneven(self):
        loci = parse_loci("chr1:0-10").result()
        result = partition_loci_uniformly(3, loci)
        # every task gets some loci and all loci are assigned
        assert result.count == 10
        inv = result.inverse_map()
        assert set(inv.keys()) == {0, 1, 2}

    def test_uniform_across_contigs(self):
        loci = parse_loci("chr1:0-10,chr2:0-10").result()
        result = partition_loci_uniformly(2, loci)
        assert result.count == 20
        inv = result.inverse_map()
        assert inv[0].count == 10
        assert inv[1].count == 10

    def test_uniform_more_tasks_than_loci(self):
        loci = parse_loci("chr1:0-2").result()
        result = partition_loci_uniformly(5, loci)
        assert result.count == 2

    def test_uniform_whole_genome_fast(self):
        # Perf guard (cf. DistributedUtilSuite.scala:66-75): partitioning a
        # 3.1 Gbp genome into 2000 tasks should be near-instant.
        import time

        contig_lengths = {f"chr{i}": 130_000_000 for i in range(1, 25)}
        loci = parse_loci(",".join(contig_lengths)).result(contig_lengths)
        t0 = time.time()
        result = partition_loci_uniformly(2000, loci)
        elapsed = time.time() - t0
        assert result.count == loci.count
        assert elapsed < 5.0

    def test_depth_balanced(self):
        loci = parse_loci("chr1:0-100").result()
        # 9 reads piled on [0, 10); 1 read on [90, 100)
        reads = [
            make_read("A" * 10, cigar_string="10M", mdtag="10", start=0,
                      reference_contig="chr1")
            for _ in range(9)
        ] + [
            make_read("A" * 10, cigar_string="10M", mdtag="10", start=90,
                      reference_contig="chr1")
        ]
        result = partition_loci_by_approximate_depth(2, loci, 100, reads)
        assert result.count == 100
        inv = result.inverse_map()
        # task 0 should get roughly the deep region only
        assert inv[0].count < inv[1].count

    def test_depth_balanced_even_depth(self):
        loci = parse_loci("chr1:0-100").result()
        reads = [
            make_read("A" * 10, cigar_string="10M", mdtag="10", start=s,
                      reference_contig="chr1")
            for s in range(0, 90, 10)
        ]
        result = partition_loci_by_approximate_depth(3, loci, 100, reads)
        assert result.count == 100
        assert set(result.inverse_map().keys()) == {0, 1, 2}
