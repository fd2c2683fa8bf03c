"""structural-variant caller tests (ported from the reference suite:
median/MAD, pair compatibility, graph construction, clique growth)."""

import pytest

from guacamole.callers.structural_variant import (
    GenomeRange,
    MedianStats,
    PairGraph,
    are_reads_compatible,
    build_variant_graph,
    find_cliques,
    get_exceptional_reads,
    median_stats,
)
from guacamole.reads.read import MateAlignmentProperties, PairedMappedRead

from fixtures import make_test_read


def make_paired_mapped_read(
    start=1,
    mate_start=1,
    is_positive_strand=True,
    is_mate_positive_strand=False,
    sequence="ACTGACTGACTG",
    inferred_insert_size=None,
):
    if inferred_insert_size is None:
        inferred_insert_size = abs(mate_start - start) + len(sequence)
    mate = MateAlignmentProperties(
        reference_contig="chr1",
        start=mate_start,
        inferred_insert_size=inferred_insert_size,
        is_positive_strand=is_mate_positive_strand,
    )
    read = make_test_read(
        sequence,
        f"{len(sequence)}M",
        str(len(sequence)),
        start=start,
        is_positive_strand=is_positive_strand,
    )
    return PairedMappedRead(read, True, inferred_insert_size, mate)


def make_pair(start, end, mate_start, mate_end):
    assert mate_end - mate_start == end - start
    return make_paired_mapped_read(
        start=start, mate_start=mate_start, sequence="A" * (end - start)
    )


def test_median_stats():
    assert median_stats([2, 4, 1, 1, 2, 6, 9]) == MedianStats(2, 1)
    assert median_stats([0, 1, 2, 2]) == MedianStats(1.5, 0.5)
    assert median_stats([1]) == MedianStats(1.0, 0.0)
    assert median_stats([]) == MedianStats(0.0, 0.0)


def test_read_compatibility():
    # Scenario 1
    assert not are_reads_compatible(
        make_pair(0, 10, 90, 100), make_pair(10, 20, 90, 100), 10
    )
    assert are_reads_compatible(
        make_pair(0, 10, 90, 100), make_pair(10, 20, 90, 100), 29
    )  # DELLY inaccuracy, kept for parity
    assert are_reads_compatible(
        make_pair(0, 10, 90, 100), make_pair(10, 20, 90, 100), 30
    )
    assert are_reads_compatible(
        make_pair(0, 10, 90, 100), make_pair(10, 20, 90, 100), 40
    )
    # Scenario 2
    assert not are_reads_compatible(
        make_pair(0, 10, 100, 110), make_pair(10, 20, 90, 100), 10
    )
    assert are_reads_compatible(
        make_pair(0, 10, 100, 110), make_pair(10, 20, 90, 100), 20
    )
    assert are_reads_compatible(
        make_pair(0, 10, 100, 110), make_pair(10, 20, 90, 100), 40
    )
    # Scenario 3
    assert are_reads_compatible(
        make_pair(0, 10, 90, 100), make_pair(10, 20, 100, 110), 30
    )
    # Scenario 4: far apart
    assert not are_reads_compatible(
        make_pair(0, 10, 90, 100), make_pair(95, 105, 195, 205), 1000
    )


def test_read_filtering():
    reads = [
        make_paired_mapped_read(start=9, mate_start=97),  # insert 100
        make_paired_mapped_read(start=10, mate_start=97),  # 99
        make_paired_mapped_read(start=11, mate_start=98),  # 99
        make_paired_mapped_read(start=12, mate_start=101),  # 101
        make_paired_mapped_read(start=13, mate_start=101),  # 100
        # inverted pair (same strand): dropped
        make_paired_mapped_read(
            start=100,
            mate_start=150,
            is_positive_strand=True,
            is_mate_positive_strand=True,
        ),
        # unusually large inserts (300bp)
        make_paired_mapped_read(start=1000, mate_start=1288),
        make_paired_mapped_read(start=1001, mate_start=1289),
        # insert too large: dropped
        make_paired_mapped_read(start=2000, mate_start=2000000),
    ]
    result = get_exceptional_reads(reads)
    assert len(result.reads_in_range) == 7
    assert result.insert_stats == MedianStats(100, 1)
    assert result.max_normal_insert_size == 105
    assert [p.read.start for p in result.exceptional_reads] == [1000, 1001]


def test_graph_construction():
    reads = [
        make_paired_mapped_read(start=100, mate_start=288),
        make_paired_mapped_read(start=1000, mate_start=1288),
        make_paired_mapped_read(start=1001, mate_start=1289),
    ]
    graph = build_variant_graph(reads, 100)
    assert len(graph.edges) == 1
    _, i, j = graph.edges[0]
    assert {graph.nodes[i].read.start, graph.nodes[j].read.start} == {1000, 1001}


def clique_starts(graph, max_normal):
    return [
        sorted(graph.nodes[n].read.start for n in clique.read_pairs)
        for clique in find_cliques(graph, max_normal)
    ]


def make_graph(nodes, edges):
    graph = PairGraph(nodes)
    for i, j, weight in edges:
        graph.add_edge(i, j, weight)
    return graph


def test_clique_detection():
    a = make_paired_mapped_read(start=1000, mate_start=1287)
    b = make_paired_mapped_read(start=1001, mate_start=1288)
    c = make_paired_mapped_read(start=1002, mate_start=1289)
    d = make_paired_mapped_read(start=1003, mate_start=1290)
    nodes = [a, b, c, d]

    # two compatible reads
    g = make_graph(nodes, [(0, 1, 1)])
    assert clique_starts(g, 100) == [[1000, 1001]]

    # third doesn't form a clique; lowest-weight edge wins
    g = make_graph(nodes, [(0, 1, 1), (1, 2, 2)])
    assert clique_starts(g, 100) == [[1000, 1001]]

    # fully connected triple
    g = make_graph(nodes, [(0, 1, 1), (1, 2, 2), (0, 2, 3)])
    assert clique_starts(g, 100) == [[1000, 1001, 1002]]

    # c not in the clique, but d is
    g = make_graph(
        nodes, [(0, 1, 1), (1, 2, 2), (2, 3, 3), (0, 3, 4), (3, 1, 5)]
    )
    assert clique_starts(g, 100) == [[1000, 1001, 1003]]

    # {a, c, d} is maximal but a~b has stronger agreement
    g = make_graph(nodes, [(0, 1, 1), (0, 2, 2), (0, 3, 3), (2, 3, 4)])
    assert clique_starts(g, 100) == [[1000, 1001]]

    # disjoint components
    g = make_graph(nodes, [(0, 1, 1), (2, 3, 2)])
    assert sorted(clique_starts(g, 100)) == [[1000, 1001], [1002, 1003]]


def test_clique_detection_with_alignment_limitations():
    a = make_pair(100, 120, 380, 400)
    b = make_pair(200, 220, 480, 500)
    c = make_pair(0, 20, 580, 600)
    g = make_graph([a, b, c], [(0, 1, 1), (1, 2, 2), (0, 2, 3)])
    cliques = find_cliques(g, 400)
    assert len(cliques) == 1
    sv = cliques[0]
    assert sorted(g.nodes[n].read.start for n in sv.read_pairs) == [100, 200]
    assert sv.span(g) == GenomeRange("chr1", 220, 380)
    assert sv.wiggle == 260


def test_columnar_fast_path_equals_object_path(tmp_path):
    """The vectorized mate-column stage-1 (exceptional_from_columnar)
    must reproduce the object path exactly: same insert-size sample,
    same threshold, same exceptional set, same called ranges."""
    import numpy as np

    from guacamole.callers.structural_variant import (
        call_structural_variants,
        exceptional_from_columnar,
        get_exceptional_reads,
        median_stats,
        oriented_insert_size,
        pairs_in_range,
    )
    from guacamole.gio.load import load_read_set
    from guacamole.reads.read import InputFilters, PairedMappedRead
    from guacamole.runtime.columnar import (
        decode_sam_columnar,
        native_available,
    )
    from guacamole.utils.simulate import make_sv_fixture

    if not native_available():
        import pytest

        pytest.skip("native runtime not built")
    manifest = make_sv_fixture(
        str(tmp_path), length=250_000, depth=16,
        deletions=((90_000, 4_000),), seed=11,
    )
    sam = str(tmp_path / manifest["files"]["sv_sam"])

    # object path
    read_set = load_read_set(sam, InputFilters.create(non_duplicate=True))
    pairs = [
        pm
        for pm in (
            PairedMappedRead.from_paired_read(pr)
            for pr in read_set.mapped_paired_reads
            if pr.is_first_in_pair
        )
        if pm is not None
    ]
    exc = get_exceptional_reads(pairs)
    _mn, obj_results = call_structural_variants(pairs)

    # columnar fast path
    cols = decode_sam_columnar(sam)
    sizes, make_exceptional = exceptional_from_columnar(cols)
    np.testing.assert_array_equal(
        sizes, [oriented_insert_size(p) for p in pairs_in_range(pairs)]
    )
    stats = median_stats(sizes[:100000])
    max_normal = int(stats.median + 5 * stats.mad)
    assert max_normal == exc.max_normal_insert_size
    fast_exc = make_exceptional(max_normal)
    assert len(fast_exc) == len(exc.exceptional_reads)
    for a, b in zip(fast_exc, exc.exceptional_reads):
        assert a.read.start == b.read.start
        assert a.inferred_insert_size == b.inferred_insert_size
        assert a.mate.start == b.mate.start
    _mn2, fast_results = call_structural_variants(
        fast_exc, max_normal_insert_size=max_normal
    )
    assert {
        c: [str(r) for r in rs] for c, rs in fast_results.items()
    } == {c: [str(r) for r in rs] for c, rs in obj_results.items()}


def test_sv_simulator_zygosity_and_noise(tmp_path):
    """Hom deletions are excised from both haplotypes (so ~all spanning
    fragments are discordant, vs ~half for het) and noise fragments plant
    isolated discordant pairs; the caller still recovers het and hom
    deletions within tolerance (StructuralVariantCaller.scala:102-264)."""
    from guacamole.callers.structural_variant import (
        call_structural_variants,
        get_exceptional_reads,
    )
    from guacamole.gio.load import load_read_set
    from guacamole.reads.read import InputFilters, PairedMappedRead
    from guacamole.utils.simulate import make_sv_fixture

    manifest = make_sv_fixture(
        str(tmp_path), length=400_000, depth=16,
        deletions=((90_000, 3_000), (250_000, 3_000)),
        zygosities=["het", "hom"], noise_rate=0.002, seed=13,
    )
    sam = str(tmp_path / manifest["files"]["sv_sam"])
    read_set = load_read_set(sam, InputFilters.create(non_duplicate=True))
    pairs = [
        pm
        for pm in (
            PairedMappedRead.from_paired_read(pr)
            for pr in read_set.mapped_paired_reads
            if pr.is_first_in_pair
        )
        if pm is not None
    ]
    exc = get_exceptional_reads(pairs)

    def discordant_near(lo, hi):
        return [
            p for p in exc.exceptional_reads
            if lo - 600 <= p.read.start and p.mate.start + 100 <= hi + 600
        ]

    het_n = len(discordant_near(90_000, 93_000))
    hom_n = len(discordant_near(250_000, 253_000))
    # hom locus yields roughly twice the discordant pairs of the het one
    assert hom_n > 1.5 * het_n > 0
    # noise planted isolated discordants outside both deletion windows
    outside = [
        p for p in exc.exceptional_reads
        if not (80_000 <= p.read.start <= 95_000)
        and not (240_000 <= p.read.start <= 255_000)
    ]
    assert outside

    _mn, results = call_structural_variants(pairs)
    spans = [(r.start, r.stop) for r in results["svcontig"]]
    for lo, hi in manifest["truth_deletions"]:
        assert any(
            abs(s - lo) <= 250 and abs(e - hi) <= 250 for s, e in spans
        ), (lo, hi, spans)
