"""The launch plans of K4 (``int8_linear_plan``) and K5 (``decode_plan``), as pure Python.

Both kernels split one piece of work over the blocks of a thread block
cluster: K4 a 128-column tile's K, K5 a (batch row, kv head, query-row group)'s
key tiles. The plans are functions of the shapes, the SM count and the
residency (blocks an SM, or the device's clusters of each size), so they are
checked here over the shapes of the decode and verify paths and over cards of
several residencies: every K step and every key tile is walked by exactly one
split (by the formulas the kernels use, ``int8_linear_steps`` and
``decode_tiles``), the grid is one wave, the cluster stays within 8 blocks
and the tiles, and a block keeps enough tiles to keep its loads in flight.
"""

import pytest

from merv_tpu_torch.ops.decode_attention import (DECODE_MAX_CLUSTER, DECODE_MAX_ROWS, DECODE_MIN_TILES_PER_BLOCK,
                                                 DECODE_TILE, DECODE_WARPS, decode_plan, decode_tiles)
from merv_tpu_torch.ops.int8_linear import (INT8_COLS, INT8_MAX_SPLITS, INT8_MIN_STEPS, INT8_STEP_K,
                                             int8_linear_plan, int8_linear_steps)

# (SM count, blocks an SM): an H100 SXM at 1..4 blocks of the kernel an SM, and a smaller card
CARDS = [(132, 1), (132, 2), (132, 3), (132, 4), (114, 2)]
# Llama-2-7B's weight shapes (N, K), a ragged width, and the small K edges
K4_SHAPES = [(4096, 4096), (11008, 4096), (4096, 11008), (32064, 4096), (4100, 4096), (129, 64), (300, 1344),
             (1000, 4160)]
K4_ROWS = [1, 4, 8, 36, 64]
# (B, Hk, query rows per kv head, Tk): decode at B = 1 over 1,120 rows, the engine's 4 slots over 2,058 and their
# verify at gamma 4 and 8, GQA, D = 64's 12 heads, 8 slots, Tk = 1 and 4,096, a row group split
K5_SHAPES = [(1, 32, 1, 1120), (4, 32, 1, 2058), (4, 32, 5, 2058), (4, 32, 9, 2058), (1, 8, 4, 1120), (2, 12, 1, 600),
             (8, 32, 1, 1120), (1, 32, 1, 1), (1, 32, 1, 4096), (2, 8, 20, 200), (1, 4, 1, 2304)]


def _clusters(sms, per_sm, n):
    """The residency the plans assume without the device's figure: sms * per_sm // c clusters of c."""
    return [sms * per_sm // c for c in range(1, n + 1)]


@pytest.mark.parametrize("sms, per_sm", CARDS)
@pytest.mark.parametrize("N, K", K4_SHAPES)
def test_int8_linear_plan_covers_k_once_in_one_wave(sms, per_sm, N, K):
    steps = -(-K // INT8_STEP_K)
    tiles = -(-N // INT8_COLS)
    for M in K4_ROWS:
        s = int8_linear_plan(M, N, K, sms, per_sm)
        assert 1 <= s <= min(INT8_MAX_SPLITS, steps)
        walked = [i for split in range(s) for i in int8_linear_steps(split, s, K)]
        assert sorted(walked) == list(range(steps))  # every k step once
        assert s == 1 or all(len(int8_linear_steps(split, s, K)) >= INT8_MIN_STEPS for split in range(s))
        assert s == 1 or tiles * s <= sms * per_sm  # one wave (more tiles than a wave holds take s = 1)
        assert s == int8_linear_plan(M, N, K, sms, per_sm, _clusters(sms, per_sm, INT8_MAX_SPLITS))


def test_int8_linear_plan_fills_the_card_at_llama_shapes():
    """On an H100: q/k/v/o's 32 column tiles take 4 splits at 1 block an SM (128 blocks) and 8 at 2 (256);
    gate/up's 86 tiles 1 at 1 an SM and 3 at 3; down's 32 tiles of 86 k steps 8 at 2 an SM (11 steps a
    block); the lm_head's 251 tiles one (a wave holds them at 2 an SM, not twice over)."""
    assert int8_linear_plan(1, 4096, 4096, 132, 1) == 4
    assert int8_linear_plan(1, 4096, 4096, 132, 2) == 8
    assert int8_linear_plan(36, 11008, 4096, 132, 1) == 1
    assert int8_linear_plan(36, 11008, 4096, 132, 3) == 4
    assert int8_linear_plan(1, 4096, 11008, 132, 2) == 8
    assert int8_linear_plan(1, 32064, 4096, 132, 2) == 1


def test_int8_linear_plan_follows_the_device_residency():
    """Where a GPC holds fewer clusters than sms * per_sm // s (a cluster must sit in one GPC), the plan takes
    the device's own figure and does not plan a second wave."""
    gpc_bound = [264, 132, 84, 60, 48, 36, 30, 28]  # clusters of 1..8 blocks at 2 blocks an SM
    s = int8_linear_plan(1, 4096, 4096, 132, 2, gpc_bound)
    assert s == 6 and 32 <= gpc_bound[s - 1]  # 7 and 8 would need 32 clusters; the formula gives 37 and 33


@pytest.mark.parametrize("sms, per_sm", CARDS)
@pytest.mark.parametrize("B, Hk, rows, Tk", K5_SHAPES)
def test_decode_plan_covers_every_tile_once_in_one_wave(sms, per_sm, B, Hk, rows, Tk):
    c = decode_plan(B, Hk, rows, Tk, sms, per_sm)
    tiles = -(-Tk // DECODE_TILE)
    units = B * Hk * -(-rows // DECODE_MAX_ROWS)
    assert 1 <= c <= min(DECODE_MAX_CLUSTER, tiles)
    walked = [i for rank in range(c) for w in range(DECODE_WARPS) for i in decode_tiles(rank, w, c, Tk)]
    assert sorted(walked) == list(range(tiles))  # every key tile once
    assert c == 1 or units * c <= sms * per_sm  # one wave
    assert c == 1 or tiles // c >= DECODE_MIN_TILES_PER_BLOCK  # every block's warps have two tiles
    assert c == decode_plan(B, Hk, rows, Tk, sms, per_sm, _clusters(sms, per_sm, DECODE_MAX_CLUSTER))


@pytest.mark.parametrize("per_sm", [1, 2, 3, 4])
def test_decode_plan_b1_is_one_wave(per_sm):
    """B = 1 over the 1,120-row decode cache (32 kv heads): a plan aiming at 16 blocks an SM asks for 576
    blocks, a second wave where 4 fit an SM; this one fits 132 SMs once at any residency: 4 blocks of 18 of the
    70 tiles at one block an SM, 8 of 9 from two."""
    c = decode_plan(1, 32, 1, 1120, 132, per_sm)
    assert 32 * c <= 132 * per_sm
    assert c == (4 if per_sm == 1 else 8)


def test_decode_plan_spreads_ragged_slots():
    """A ragged slot's live tiles (a prefix of the buffer) spread evenly over the cluster's blocks and warps."""
    c = decode_plan(1, 8, 1, 2058, 132, 2)
    assert c > 1
    live = 40  # the slot's first 40 of 129 tiles hold its keys
    per = [sum(t < live for t in decode_tiles(r, w, c, 2058)) for r in range(c) for w in range(DECODE_WARPS)]
    assert sum(per) == live and max(per) - min(per) <= 1


def test_decode_plan_takes_one_split_past_a_wave():
    """Eight slots of 32 kv heads: 256 units, more than one wave holds at one block an SM, so each unit is one
    block; at 2 an SM, still no second wave."""
    assert decode_plan(8, 32, 1, 1120, 132, 1) == 1
    c = decode_plan(8, 32, 1, 1120, 132, 2)
    assert 256 * c <= 264 or c == 1
