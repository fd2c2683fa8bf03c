"""Megabatch transfer-shape guarantees (round-4 VERDICT item 2).

The latency-tolerant device path replaces per-4096-loci-tile streaming
(thousands of H2D/D2H hops — unusable over a high-latency link) with
auto megatiles + slabbed screen launches: O(1) kernel launches and
transfers per region. These tests pin the transfer COUNTS so a
regression back to per-tile streaming is caught without a GPU.
"""

import numpy as np
import pytest

from guacamole.ops import dispatch
from guacamole.pack.columnar import iter_tiles_columnar
from guacamole.runtime.columnar import decode_bam_columnar, native_available

from conftest import resource_path


@pytest.mark.skipif(not native_available(), reason="native runtime not built")
def test_chrm_screen_is_one_megatile_and_one_launch(monkeypatch):
    """Whole-chrM screen tiles: ONE auto megatile, ONE device launch on
    the forced-device path (the blob is far under the slab bound)."""
    cols = decode_bam_columnar(resource_path("chrM.sorted.bam"))
    cols = cols.select(cols.is_mapped_mask)
    tiles = list(
        iter_tiles_columnar(
            cols, "chrM", range(0, 16571), fields="screen"
        )
    )
    assert len(tiles) == 1, "chrM must pack as one auto megatile"

    monkeypatch.setenv("GUAC_HOST_SCREEN", "0")  # force the device path
    launches = []
    real = dispatch._compact_one_launch

    def counting(*a, **k):
        launches.append(1)
        return real(*a, **k)

    monkeypatch.setattr(dispatch, "_compact_one_launch", counting)
    items = [(t, "default", None) for t in tiles]
    results = list(
        dispatch.pipelined_batched_screens(
            iter(items),
            tile_of=lambda it: it[0],
            threshold_percent=8,
            compact_cap=512,
        )
    )
    assert len(results) == 1
    assert len(launches) == 1, (
        f"expected ONE compact screen launch for chrM, got {len(launches)}"
    )
    # The result must actually resolve (sanity: candidates exist on chrM).
    screen = results[0][1].result()
    assert screen.total > 0


@pytest.mark.skipif(not native_available(), reason="native runtime not built")
def test_slab_count_is_blob_bound(monkeypatch):
    """An oversized blob slabs into ceil(bytes/slab) launches — not one
    per 4096-loci tile — and the merged result equals the whole-tile
    screen."""
    cols = decode_bam_columnar(resource_path("chrM.sorted.bam"))
    cols = cols.select(cols.is_mapped_mask)
    (tile,) = iter_tiles_columnar(
        cols, "chrM", range(0, 16571), fields="screen"
    )
    blob = np.asarray(tile.csr_nib)
    row_off = np.asarray(tile.csr_off, np.int32)
    iv = np.asarray(tile.is_variant)

    monkeypatch.setenv("GUAC_HOST_SCREEN", "0")
    whole = dispatch.screen_csr_launch(
        blob, row_off, iv, tile.K, threshold_percent=8
    ).result()

    # Shrink the slab bound so this blob must split.
    monkeypatch.setattr(dispatch, "CSR_SLAB_BYTES", 1 << 18)
    launches = []
    real = dispatch._screen_csr_one_launch

    def counting(*a, **k):
        launches.append(1)
        return real(*a, **k)

    monkeypatch.setattr(dispatch, "_screen_csr_one_launch", counting)
    slabbed = dispatch.screen_csr_launch(
        blob, row_off, iv, tile.K, threshold_percent=8
    ).result()

    expected = -(-len(blob) // (1 << 18))  # ceil
    assert len(launches) <= expected + 1
    assert len(launches) >= 2
    np.testing.assert_array_equal(whole.counts, slabbed.counts)
    np.testing.assert_array_equal(whole.candidates, slabbed.candidates)


@pytest.mark.skipif(not native_available(), reason="native runtime not built")
def test_compact_wire_form_byte_budget(monkeypatch):
    """Pin the compact wire formats' transfer volume (round-5): one
    chrM counting-screen launch must stage ~0.5 B/element of blob plus
    4 B/row of metadata (uint16 nibble-byte counts + uint16 variant
    words) — NOT int32 offsets or K bool bytes per row."""
    monkeypatch.setenv("GUAC_HOST_SCREEN", "0")
    monkeypatch.setenv("GUAC_TRANSFER_STATS", "1")
    cols = decode_bam_columnar(resource_path("chrM.sorted.bam"))
    cols = cols.select(cols.is_mapped_mask)
    (tile,) = list(
        iter_tiles_columnar(cols, "chrM", range(0, 16571), fields="screen")
    )
    dispatch.reset_transfer_stats()
    pending = dispatch.screen_csr_compact_launch(
        np.asarray(tile.csr_nib),
        np.asarray(tile.csr_off, dtype=np.int32),
        np.asarray(tile.is_variant),
        tile.K,
        threshold_percent=8,
    )
    pending.result()
    moved = dispatch.TRANSFER_STATS["h2d_bytes"]
    blob = len(tile.csr_nib)
    rows = tile.L
    # blob pads to its transfer bucket (~<=12%); metadata is 4 B/row.
    budget = int(blob * 1.15) + 4 * rows + 8192
    assert moved <= budget, (moved, budget)
    # The pre-round-5 form (int32 offsets + K bools/row) would move this:
    old = blob + 4 * (rows + 1) + rows * tile.K
    assert moved < old


@pytest.mark.skipif(not native_available(), reason="native runtime not built")
def test_ll_pack8_wire_form_byte_budget(monkeypatch):
    """Likelihood-screen launch over a qual-binned tile must stage
    ~1 B/element (ll_pack8) + 4 B/row of flag words, not the 2 B/element
    uint16 form + 2K bool bytes per row."""
    from guacamole.ops.dispatch import germline_screen_launch
    from guacamole.pack.columnar import pack_tile_columnar

    monkeypatch.setenv("GUAC_HOST_SCREEN", "0")
    monkeypatch.setenv("GUAC_TRANSFER_STATS", "1")
    cols = decode_bam_columnar(resource_path("chrM.sorted.bam"))
    mc = cols.select(cols.is_mapped_mask)
    binned = mc.select(np.ones(mc.n, bool))
    binned.ev_qual[:] = (binned.ev_qual // 16) * 16  # <= 16 distinct
    cid = mc.ref_names.index("chrM")
    t = pack_tile_columnar(
        binned, cid, "chrM", list(range(0, 2048)), fields="likelihood",
        min_mapq=1,
    )
    assert t.ll_pack8 is not None
    dispatch.reset_transfer_stats()
    germline_screen_launch(t, min_mapq=1).result()
    moved = dispatch.TRANSFER_STATS["h2d_bytes"]
    L, D = t.ll_pack8.shape
    budget = L * D + 4 * L + 4096  # pack8 + uint32 words + slack
    assert moved <= budget, (moved, budget)
    old = 2 * L * D + 2 * L * t.K  # uint16 form + two bool planes
    assert moved < old
