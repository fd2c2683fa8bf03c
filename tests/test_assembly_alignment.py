"""De Bruijn graph, affine-gap alignment, and concordance tests
(scenarios ported from the reference suites)."""

import pytest

from guacamole.alignment.affine_gap import (
    AlignmentState,
    ReadAlignment,
    align,
    score_alignment_paths,
)
from guacamole.assembly.debruijn import DeBruijnGraph
from guacamole.concordance import compute_concordance
from guacamole.gio.vcf import VcfRecord


class TestDeBruijnGraph:
    def test_merge_kmers(self):
        kmers = [b"TTTC", b"TTCC", b"TCCC", b"CCCC"]
        assert DeBruijnGraph.merge_kmers(kmers) == b"TTTCCCC"

    def test_build_graph(self):
        graph = DeBruijnGraph.from_sequences([b"TCATCTCAAAAGAGATCGA"], 8)
        assert graph.kmer_counts[b"TCATCTCA"] == 1
        assert graph.kmer_counts[b"CATCTCAA"] == 1
        assert graph.kmer_counts[b"GAGATCGA"] == 1

    def test_short_kmer_counts(self):
        graph = DeBruijnGraph.from_sequences([b"TCATCTTAAAAGACATAAA"], 3)
        assert graph.kmer_counts[b"TCA"] == 1
        assert graph.kmer_counts[b"CAT"] == 2
        assert graph.kmer_counts[b"AAA"] == 3

    def test_children_and_parents(self):
        graph = DeBruijnGraph.from_sequences([b"TCATCTTAAAAGACATAAA"], 3)
        assert graph.children(b"TCA") == [b"CAT"]
        assert graph.parents(b"TCA") == [b"ATC"]
        assert graph.parents(b"CAT") == [b"ACA", b"TCA"]
        assert graph.children(b"CAT") == [b"ATA", b"ATC"]

    def test_all_unique_kmers(self):
        sequence = b"AAATCCCTTTTA"
        graph = DeBruijnGraph.from_sequences([sequence], 4)
        assert len(graph.kmer_counts) == len(sequence) - 4 + 1
        assert all(c == 1 for c in graph.kmer_counts.values())

    def test_prune(self):
        graph = DeBruijnGraph.from_sequences(
            [b"TCATCTTAAAAGACATAAA"], 3, min_occurrence=2
        )
        assert b"TCA" not in graph.kmer_counts
        assert b"CAT" in graph.kmer_counts
        assert b"AAA" in graph.kmer_counts

    def test_merge_forward_full(self):
        sequence = b"AAATCCCTGGGT"
        graph = DeBruijnGraph.from_sequences([sequence], 4)
        mergeable = graph.merge_forward(b"AAAT")
        assert len(mergeable) == 9
        assert DeBruijnGraph.merge_kmers(mergeable) == sequence

    def test_merge_backward_full(self):
        sequence = b"AAATCCCTGGGT"
        graph = DeBruijnGraph.from_sequences([sequence], 4)
        mergeable = graph.merge_backward(b"GGGT")
        assert len(mergeable) == 9
        assert DeBruijnGraph.merge_kmers(mergeable) == sequence

    def test_merge_forward_bubble_at_end(self):
        graph = DeBruijnGraph.from_sequences(
            [b"AAATCCCTGGGT", b"AAATCCCTGGAT"], 4
        )
        mergeable = graph.merge_forward(b"AAAT")
        assert len(mergeable) == 7
        assert DeBruijnGraph.merge_kmers(mergeable) == b"AAATCCCTGG"

    def test_merge_forward_bubble_in_middle(self):
        graph = DeBruijnGraph.from_sequences(
            [b"AAATCCCTGGGT", b"AAATCGCTGGGT"], 4
        )
        mergeable = graph.merge_forward(b"AAAT")
        assert len(mergeable) == 2
        assert DeBruijnGraph.merge_kmers(mergeable) == b"AAATC"

    def test_merge_backward_bubble_at_end(self):
        graph = DeBruijnGraph.from_sequences(
            [b"AAATCCCTGGGT", b"AAATCCCTGGAT"], 4
        )
        merge1 = graph.merge_backward(b"GGGT")
        assert DeBruijnGraph.merge_kmers(merge1) == b"TGGGT"
        merge2 = graph.merge_backward(b"GGAT")
        assert DeBruijnGraph.merge_kmers(merge2) == b"TGGAT"

    def test_dfs_path(self):
        sequence = b"AAATCCCTGGGT"
        graph = DeBruijnGraph.from_sequences([sequence], 4)
        paths = graph.depth_first_search(b"AAAT", b"GGGT")
        assert len(paths) == 1
        assert DeBruijnGraph.merge_kmers(paths[0]) == sequence

    def test_dfs_path_after_merge(self):
        sequence = b"AAATCCCTGGGT"
        graph = DeBruijnGraph.from_sequences([sequence], 4, merge_nodes=True)
        paths = graph.depth_first_search(b"AAAT", b"GGGT")
        assert len(paths) == 1
        assert DeBruijnGraph.merge_kmers(paths[0]) == sequence

    def test_non_standard_bases_excluded(self):
        graph = DeBruijnGraph.from_sequences([b"AANTC"], 3)
        assert graph.kmer_counts == {}


class TestAffineGapAlignment:
    def test_score_exact_match(self):
        rows = score_alignment_paths(
            b"TCGA", b"TCGA",
            mismatch_probability=1e-2,
            open_gap_probability=1e-3,
            close_gap_probability=1e-2,
        )
        assert int(rows[4][2]) == 0

    def test_score_single_mismatch(self):
        rows = score_alignment_paths(
            b"TCGA", b"TCCA",
            mismatch_probability=1e-2,
            open_gap_probability=1e-3,
            close_gap_probability=1e-2,
        )
        assert round(rows[4][2]) == 5

    def test_align_exact(self):
        assert align(b"TCGA", b"TCGA").to_cigar() == "4="

    def test_align_single_mismatch(self):
        assert align(b"TCGA", b"TCCA").to_cigar() == "2=1X1="

    def test_align_long_exact(self):
        seq = b"TCGATGATCTGAGA"
        assert align(seq, seq).to_cigar() == f"{len(seq)}="

    def test_short_insertion(self):
        assert align(b"TCCGA", b"TCGA").to_cigar() == "2=1I2="

    def test_long_insertion(self):
        assert align(b"TCGACCCTCTGA", b"TCGATCTGA").to_cigar() == "4=3I5="

    def test_long_deletion(self):
        assert align(b"TCGATCTGA", b"TCGACCCTCTGA").to_cigar() == "4=3D5="

    def test_mixed_mismatch_and_insertion(self):
        assert align(b"TCGACCCTCTTA", b"TCGATCTGA").to_cigar() == "4=3I3=1X1="

    def test_only_mismatch_long(self):
        a = align(
            b"ATTCTCAAGTTTTAAGTGGTATTCTAATTATGGCAGTAATTAACTGAATAAAGAGATTCAT"
            b"CATGTGCAAAAACTAATCTTGTTTACTTAAAATTGAGAGT",
            b"ATTCTCAAGTTTTAAGTGGTTTTCTAATTATGGCAGTAATAAACTGAATAAAGAGATTCAT"
            b"CATGTGCAAAAACTAATCTTGTTTACTTAAAATTGAGAGT",
        )
        assert a.to_cigar() == "20=1X19=1X60="

    def test_two_mismatch_with_deletion(self):
        a = align(
            b"ATTCTCAAGTTTTAAGTGGTATTCTAATTATGGCAGTAATTAACTGAATAAAGAGATTCAT"
            b"CATGTGCAAAAACTAATCTT" + b"GTTTACTTAAAATTGAGAGT",
            b"ATTCTCAAGTTTTAAGTGGTTTTCTAATTATGGCAGTAATAAACTGAATAAAGAGATTCAT"
            b"CATGTGCAAAAACTAATCTTCCCGTTTACTTAAAATTGAGAGT",
        )
        assert a.to_cigar() == "20=1X19=1X40=3D20="

    def test_cigar_run_length_encoding(self):
        M, X, I = (
            AlignmentState.MATCH,
            AlignmentState.MISMATCH,
            AlignmentState.INSERTION,
        )
        assert ReadAlignment([M] * 6, b"", 60).to_cigar() == "6="
        assert ReadAlignment([M, M, M, I, I, M], b"", 60).to_cigar() == "3=2I1="
        assert ReadAlignment([M, I, I, I, I, M], b"", 60).to_cigar() == "1=4I1="
        assert ReadAlignment([M, X, X, M, M, M], b"", 60).to_cigar() == "1=2X3="


class TestConcordance:
    def test_concordance_vs_truth(self, resources_dir, tmp_path):
        from conftest import resource_path

        truth = resource_path("truth.chr20.vcf")
        from guacamole.gio.vcf import read_vcf

        variants = list(read_vcf(truth))
        assert variants
        # calls = first half of the truth + one false positive
        calls = [
            VcfRecord(
                contig=v.contig, start=v.start, ref=v.ref, alt=v.alts[0]
            )
            for v in variants[: len(variants) // 2]
        ] + [VcfRecord(contig="20", start=1, ref="A", alt="T")]
        result = compute_concordance(calls, truth)
        assert result.true_positives == len(set(
            (v.contig, v.start, v.ref, v.alts[0]) for v in variants[: len(variants) // 2]
        ))
        assert result.false_positives == 1
        assert 0 < result.precision < 1
        assert 0 < result.recall <= 1
        assert 0 < result.f1_score < 1

    def test_concordance_variant_type_and_chromosome_filters(self, tmp_path):
        """--exclude-snv / --exclude-indel / --chr semantics
        (Concordance.scala:44-51, 77-83)."""
        truth = tmp_path / "truth.vcf"
        truth.write_text(
            "##fileformat=VCFv4.1\n"
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
            "20\t100\t.\tA\tT\t.\t.\t.\n"  # SNV on 20
            "20\t200\t.\tAC\tA\t.\t.\t.\n"  # deletion on 20
            "21\t300\t.\tG\tC\t.\t.\t.\n"  # SNV on 21
            "20\t400\t.\tAT\tGC\t.\t.\t.\n"  # MNV: never counted
        )
        calls = [
            VcfRecord(contig="20", start=99, ref="A", alt="T"),
            VcfRecord(contig="20", start=199, ref="AC", alt="A"),
            VcfRecord(contig="21", start=299, ref="G", alt="C"),
            VcfRecord(contig="20", start=399, ref="AT", alt="GC"),
        ]
        # No excludes: SNVs + indels on all contigs; MNVs always dropped.
        r = compute_concordance(calls, str(truth))
        assert (r.true_positives, r.false_positives, r.false_negatives) == (3, 0, 0)
        # Exclude SNVs: only the deletion remains.
        r = compute_concordance(calls, str(truth), exclude_snvs=True)
        assert r.true_positives == 1
        # Exclude indels: the two SNVs remain.
        r = compute_concordance(calls, str(truth), exclude_indels=True)
        assert r.true_positives == 2
        # Chromosome filter composes with the type filter.
        r = compute_concordance(
            calls, str(truth), exclude_indels=True, chromosome="20"
        )
        assert (r.true_positives, r.false_positives, r.false_negatives) == (1, 0, 0)
        # Excluding both variant classes leaves nothing.
        r = compute_concordance(
            calls, str(truth), exclude_snvs=True, exclude_indels=True
        )
        assert (r.true_positives, r.false_positives, r.false_negatives) == (0, 0, 0)

    def test_print_concordance_reference_format(self, tmp_path, capsys):
        """printGenotypeConcordance emits the tab-separated header + values
        (Concordance.scala:127-128)."""
        from guacamole.concordance import print_genotype_concordance

        truth = tmp_path / "truth.vcf"
        truth.write_text(
            "##fileformat=VCFv4.1\n"
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
            "20\t100\t.\tA\tT\t.\t.\t.\n"
        )
        calls = [VcfRecord(contig="20", start=99, ref="A", alt="T")]
        result = print_genotype_concordance(calls, str(truth))
        out = capsys.readouterr().out.splitlines()
        assert out[0] == "Precision\tRecall\tF1Score"
        assert out[1] == "1.000000\t1.000000\t1.000000"
        assert result.f1_score == 1.0
