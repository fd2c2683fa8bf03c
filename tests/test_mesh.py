"""Multi-chip sharding tests on the virtual 8-device CPU mesh: the
shard_map'd calling step must equal per-tile single-device results, and
global psum counters must equal host-side sums."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from guacamole.gio.load import load_read_set
from guacamole.loci.lociset import parse_loci
from guacamole.ops.kernels import (
    genotype_log_likelihoods,
    probability_correct,
    tile_stats,
)
from guacamole.pack.tiles import pack_tiles
from guacamole.parallel.mesh import (
    loci_mesh,
    sharded_call_step,
    stack_tiles,
)
from guacamole.reads.read import InputFilters

from conftest import resource_path


@pytest.fixture(scope="module")
def chrm_tiles(resources_dir):
    filters = InputFilters.create(
        overlaps_loci=parse_loci("chrM:0-4096"),
        non_duplicate=True,
        has_mdtag=True,
    )
    reads = load_read_set(resource_path("chrM.sorted.bam"), filters).mapped_reads
    loci = parse_loci("chrM:0-4096").result().on_contig("chrM")
    tiles = pack_tiles(reads, "chrM", loci, tile_size=512)
    # one tile per device; pad depth to a common bucket
    max_d = max(t.D for t in tiles)
    from guacamole.pack.tiles import pad_tile_loci

    uniform = []
    for t in tiles[:8]:
        if t.D < max_d:
            import dataclasses

            pad = max_d - t.D

            def pad_depth(a, fill=0):
                return np.concatenate(
                    [a, np.full((a.shape[0], pad), fill, dtype=a.dtype)],
                    axis=1,
                )

            t = dataclasses.replace(
                t,
                allele_id=pad_depth(t.allele_id, -1),
                qual=pad_depth(t.qual),
                mapq=pad_depth(t.mapq),
                strand=pad_depth(t.strand),
                mismatches=pad_depth(t.mismatches),
                edge_distance=pad_depth(t.edge_distance),
                read_index=pad_depth(t.read_index, -1),
                valid=pad_depth(t.valid),
            )
        uniform.append(t)
    while len(uniform) < 8:
        uniform.append(uniform[-1])
    return uniform[:8]


def test_eight_device_mesh_available():
    assert len(jax.devices()) >= 8


def test_sharded_step_matches_single_device(chrm_tiles):
    mesh = loci_mesh(jax.devices()[:8])
    out = sharded_call_step(chrm_tiles, mesh=mesh)
    total_elements = 0
    total_candidates = 0
    for shard, tile in enumerate(chrm_tiles):
        stats = tile_stats(
            tile.allele_id, tile.strand, tile.valid, tile.is_variant, tile.K
        )
        np.testing.assert_array_equal(
            np.asarray(out.counts[shard]), np.asarray(stats.counts)
        )
        np.testing.assert_array_equal(
            np.asarray(out.depth[shard]), np.asarray(stats.depth)
        )
        np.testing.assert_array_equal(
            np.asarray(out.candidates[shard]),
            np.asarray(stats.variant_evidence),
        )
        pc = probability_correct(tile.qual, tile.mapq, tile.valid)
        ll = genotype_log_likelihoods(tile.allele_id, pc, tile.valid, tile.K)
        np.testing.assert_allclose(
            np.asarray(out.log_likelihoods[shard]),
            np.asarray(ll),
            rtol=1e-5,
            atol=1e-5,
        )
        total_elements += int(np.asarray(stats.depth).sum())
        total_candidates += int(np.asarray(stats.variant_evidence).sum())
    # psum-merged global counters
    assert int(out.total_elements) == total_elements
    assert int(out.total_candidates) == total_candidates


def test_graft_entry_dryrun():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as graft

    fn, args = graft.entry()
    out = jax.jit(fn)(*args)
    assert out[0].shape == (128, 8)
    graft.dryrun_multichip(8)
