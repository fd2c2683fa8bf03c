"""Generic engine API tests (ported from DistributedUtilSuite: pileup
flatmap parallelism-invariance, multi-sample demux, windowFoldLoci)."""

import pytest

from guacamole.engine import (
    TaskStats,
    pileup_flat_map,
    pileup_flat_map_multiple,
    pileup_flat_map_two,
    window_fold_loci,
)
from guacamole.loci.lociset import parse_loci
from guacamole.loci.partition import partition_loci_uniformly
from guacamole.utils import bases as Bases

from fixtures import make_test_read


def sequenced(pileups):
    return [
        [e.sequenced_bases.decode() for e in p.elements] for p in pileups
    ]


class TestPileupFlatMapMultiple:
    def reads(self):
        reads1 = [
            make_test_read("TCGATCGA", "8M", "8", 1),
            make_test_read("CCCCCCCC", "8M", "8", 1),
            make_test_read("GGGGGGGG", "8M", "8", 1),
            make_test_read("TTTTTTTT", "8M", "8", 1),
            make_test_read("XYX", "3M", "3", 9),
        ]
        reads2 = [
            make_test_read("AAAAAAAA", "8M", "8", 1),
            make_test_read("CCCCCCCC", "8M", "8", 1),
            make_test_read("TTTTTTTT", "8M", "8", 1),
            make_test_read("XYX", "3M", "3", 9),
        ]
        reads3 = [
            make_test_read("AAGGCCTT", "8M", "8", 1),
            make_test_read("GGAATTCC", "8M", "8", 1),
            make_test_read("GGGGGGGG", "8M", "8", 1),
            make_test_read("XZX", "3M", "3", 99),
        ]
        return reads1, reads2, reads3

    def test_parallelism_invariance(self):
        reads1, reads2, reads3 = self.reads()
        plain = pileup_flat_map_multiple(
            [reads1, reads2, reads3],
            partition_loci_uniformly(
                1, parse_loci("chr1:1-500,chr2:10-20").result()
            ),
            True,
            lambda pileups: [sequenced(pileups)],
        )
        parallel = pileup_flat_map_multiple(
            [reads1, reads2, reads3],
            partition_loci_uniformly(
                511, parse_loci("chr1:1-500,chr2:10-20").result()
            ),
            True,
            lambda pileups: [sequenced(pileups)],
        )
        assert plain == parallel
        assert plain[0] == [
            ["T", "C", "G", "T"],
            ["A", "C", "T"],
            ["A", "G", "G"],
        ]

    def test_skip_empty_false_includes_empty(self):
        reads1, reads2, reads3 = self.reads()
        with_empty = pileup_flat_map_multiple(
            [reads1, reads2, reads3],
            partition_loci_uniformly(
                5, parse_loci("chr1:1-100").result()
            ),
            False,
            lambda pileups: [sequenced(pileups)],
        )
        assert len(with_empty) == 99  # every locus visited
        assert with_empty[50] == [[], [], []]


def test_pileup_flat_map_depths():
    reads = [make_test_read("TCGATCGA", "8M", "8", 1) for _ in range(3)]
    for tasks in (1, 5):
        partitions = partition_loci_uniformly(
            tasks, parse_loci("chr1:1-9").result()
        )
        depths = pileup_flat_map(
            reads, partitions, True, lambda p: [p.depth]
        )
        assert depths == [3] * 8


def test_pileup_flat_map_two_samples():
    reads1 = [make_test_read("TCGATCGA", "8M", "8", 1)]
    reads2 = [make_test_read("TCGATCGA", "8M", "8", 5)]
    partitions = partition_loci_uniformly(
        2, parse_loci("chr1:0-20").result()
    )
    out = pileup_flat_map_two(
        reads1,
        reads2,
        partitions,
        True,
        lambda p1, p2: [(p1.locus, p1.depth, p2.depth)],
    )
    # union coverage [1, 13): sample1 covers [1,9), sample2 [5,13)
    assert [o[0] for o in out] == list(range(1, 13))
    assert out[0] == (1, 1, 0)
    assert out[5] == (6, 1, 1)
    assert out[-1] == (12, 0, 1)


def test_window_fold_loci_average_depth():
    # ported expectations (DistributedUtilSuite.scala:389-416)
    reads = [
        make_test_read("TCGATCGGC", "8M", "8", 0),
        make_test_read("CCCCCCCC", "8M", "8", 1),
        make_test_read("TCGATCGA", "8M", "8", 4),
        make_test_read("GGGGGGG", "7M", "7", 9),
    ]
    partitions = partition_loci_uniformly(
        5, parse_loci("chr1:0-20").result()
    )

    def agg(acc, windows):
        depth = sum(
            sum(
                1
                for r in w.current_regions()
                if r.overlaps_locus(w.current_locus)
            )
            for w in windows
        )
        return (acc[0] + depth, acc[1] + 1)

    counts = window_fold_loci(
        [reads], partitions, False, 0, (0, 0), agg
    )
    assert counts == [(7, 4), (12, 4), (8, 4), (4, 4), (0, 4)]


def test_task_stats_collected():
    reads = [make_test_read("TCGATCGA", "8M", "8", s) for s in (1, 5, 100)]
    partitions = partition_loci_uniformly(
        4, parse_loci("chr1:0-200").result()
    )
    stats = TaskStats()
    pileup_flat_map(reads, partitions, True, lambda p: [p.depth], stats=stats)
    assert stats.total_regions == 3
    assert len(stats.per_task_regions) == 4
    # boundary reads are duplicated across shards
    assert stats.expanded_regions >= 3
    stats.report()
