"""The host plan of the probes' ring GEMV (``csrc/ring_gemv.cuh``): the
token tile and cluster size that ``ops/scaled_matmul.py`` ``ring_plan``
picks for P3 ``vq_smallk_matmul``, P1c ``w4_i32x8_matmul`` and P1 / P2
``w4_probe_matmul`` on an H100 (132 SMs), and the shared memory the host
counts for a block against the kernels' frames, read from their
sources."""

import re
from pathlib import Path

import pytest

from vptq_tpu_torch.ops import scaled_matmul as sm
from vptq_tpu_torch.ops.vq_smallk_matmul import (
    VQ_ROWS, vq_smallk_plan, vq_smallk_smem,
)
from vptq_tpu_torch.ops.w4_i32x8_matmul import (
    SUPERBLOCK, i32x8_plan, i32x8_rows, i32x8_smem,
)
from vptq_tpu_torch.ops.w4_probe_matmul import (
    W4_PROBE_MODES, probe_plan, probe_rows, probe_smem,
)

CSRC = Path(__file__).resolve().parent.parent / "vptq_tpu_torch" / "csrc"
H100_SMS = 132
# the probe scripts' Llama-2-7B decode shapes (chip_smoke.PROBE_SHAPES);
# P3 runs the first
SHAPES = {"gate_up": (22016, 4096), "down": (4096, 12288),
          "qkv": (12288, 4096), "o": (4096, 4096)}
TOKENS = (1, 8, 16)


def _fills_the_card(blocks: int, smem: int) -> bool:
    """Two blocks or more for each SM, and two of them fit an SM's shared
    memory (each with the block's reserved kilobyte)."""
    return (blocks >= 2 * H100_SMS and smem <= sm._BLOCK_SMEM
            and 2 * (smem + sm._BLOCK_RESERVED) <= sm._SM_SMEM)


@pytest.mark.parametrize("tokens", TOKENS)
@pytest.mark.parametrize("onehot", [False, True])
@pytest.mark.parametrize("v", [4, 8])
def test_p3_plan_makes_two_blocks_an_sm(v, onehot, tokens):
    out_f, in_f = SHAPES["gate_up"]
    tile, split = vq_smallk_plan(out_f, in_f, tokens, v, onehot, H100_SMS)
    stages = -(-(in_f // v) // 128)
    assert tile in (8, 16) and split in sm.DECODE_SPLITS and split <= stages
    blocks = -(-out_f // VQ_ROWS) * -(-tokens // tile) * split
    smem = vq_smallk_smem(v, onehot, min(tokens, tile), -(-stages // split))
    assert _fills_the_card(blocks, smem), (tile, split, blocks, smem)


@pytest.mark.parametrize("tokens", TOKENS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_p1c_plan_makes_two_blocks_an_sm(shape, tokens):
    out_f, in_f = SHAPES[shape]
    tile, split = i32x8_plan(out_f, in_f, tokens, H100_SMS)
    units = in_f // SUPERBLOCK
    assert tile in (8, 16) and split in sm.DECODE_SPLITS and split <= units
    blocks = (-(-out_f // i32x8_rows(min(tokens, tile)))
              * -(-tokens // tile) * split)
    smem = i32x8_smem(min(tokens, tile), -(-units // split))
    assert _fills_the_card(blocks, smem), (tile, split, blocks, smem)


@pytest.mark.parametrize("tokens", TOKENS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("mode", sorted(W4_PROBE_MODES))
def test_p1_p2_plan_makes_two_blocks_an_sm(mode, shape, tokens):
    """Every mode at every probe shape: a part's scale groups (128
    positions, g256 256) split over 1, 2, 4 or 8 blocks, two blocks or
    more an SM, two of which fit its shared memory."""
    out_f, in_p = SHAPES[shape]
    tile, split = probe_plan(out_f, in_p, tokens, H100_SMS, mode)
    stages = 2 if mode == "g256" else 1
    groups = in_p // 2 // (128 * stages)
    assert tile in (8, 16) and split in sm.DECODE_SPLITS and split <= groups
    # the block's rows are its token tile's, whatever the tokens
    blocks = -(-out_f // probe_rows(tile)) * -(-tokens // tile) * split
    smem = probe_smem(min(tokens, tile), -(-groups // split), stages, tile)
    assert _fills_the_card(blocks, smem), (tile, split, blocks, smem)


def test_probe_plan_takes_64_row_blocks_first():
    """P1 / P2 take the 16-token tile's 64-row blocks (x staged once for
    twice the rows) at every token count past one, and at one token where
    a split of 1 or 2 fills the card (gate_up's 344 blocks, qkv's 192 at
    split 2; down's and o's 64 would need a split of 8)."""
    assert probe_plan(22016, 4096, 1, H100_SMS) == (16, 1)
    assert probe_plan(12288, 4096, 1, H100_SMS) == (16, 2)
    assert probe_plan(4096, 12288, 1, H100_SMS) == (8, 4)
    assert probe_plan(4096, 4096, 1, H100_SMS) == (8, 4)
    assert probe_plan(22016, 4096, 8, H100_SMS) == (16, 1)
    assert probe_plan(4096, 12288, 8, H100_SMS) == (16, 8)
    assert probe_plan(12288, 4096, 3, H100_SMS, "g256") == (16, 2)


def test_plan_takes_eight_token_tiles_where_sixteen_leave_sms_idle():
    """o (4096 x 4096) at 16 tokens: 64-row blocks of 16 tokens make at
    most 64 x 4 blocks, fewer than two an SM, so the plan takes two tiles
    of 8 tokens on 32-row blocks; up to 8 tokens the tile is 8."""
    assert i32x8_plan(4096, 4096, 16, H100_SMS) == (8, 2)
    assert i32x8_plan(22016, 4096, 16, H100_SMS)[0] == 16
    assert all(i32x8_plan(4096, 4096, t, H100_SMS)[0] == 8
               for t in (1, 3, 8))
    assert sm.ring_tile(8) == 8 and sm.ring_tile(9) == 16


def test_plan_refuses_what_no_block_holds():
    """An x too wide for any split's block gives split 0 (the wrappers
    raise); a small weight takes the largest split that fits."""
    assert i32x8_plan(64, 1024 * SUPERBLOCK, 16, H100_SMS)[1] == 0
    assert vq_smallk_plan(64, 1 << 20, 16, 4, False, H100_SMS)[1] == 0
    assert i32x8_plan(200, 2048, 1, H100_SMS) == (8, 2)
    assert probe_plan(64, 1 << 20, 16, H100_SMS)[1] == 0
    assert probe_plan(64, 1 << 20, 16, H100_SMS, "g256")[1] == 0
    # 8 groups of a part (4 of g256), 7 row blocks: the largest split
    assert probe_plan(200, 2048, 1, H100_SMS) == (8, 8)
    assert probe_plan(200, 2048, 1, H100_SMS, "g256") == (8, 4)


def _frame(source: str) -> tuple:
    """(consumer warps at up to 8 tokens, past 8, stage bytes, ring slots)
    of a kernel's ring::Frame, the last two from ring_gemv.cuh."""
    src = (CSRC / source).read_text()
    warps = [int(n) for n in re.findall(
        r"\d+", re.search(r"ring::Frame<(\d+|NT == 1 \? \d+ : \d+)>", src)[1])]
    ring = (CSRC / "ring_gemv.cuh").read_text()
    stage, slots = (int(re.search(rf"constexpr int {k} = (\d+);", ring)[1])
                    for k in ("kStage", "kRing"))
    return warps[-2] if len(warps) > 1 else warps[0], warps[-1], stage, slots


def test_host_counts_the_kernels_frames():
    """The rows and the ring the host counts are the frames' own: P3 64
    rows at every tile, P1c 32 up to 8 tokens and 64 past them, stages of
    128 bytes, rings of 4."""
    w1, w2, stage, ring = _frame("vq_smallk_matmul.cu")
    assert (16 * w1, 16 * w2) == (VQ_ROWS, VQ_ROWS)
    # ring and barriers of a block with no table, x or partials
    assert vq_smallk_smem(4, True, 0, 0) == 256 + ring * VQ_ROWS * stage
    w1, w2, stage, ring = _frame("w4_i32x8_matmul.cu")
    assert (16 * w1, 16 * w2) == (i32x8_rows(8), i32x8_rows(16))
    for tokens in (1, 16):
        rows = i32x8_rows(tokens)
        assert i32x8_smem(tokens, 1) == (
            256 + ring * rows * stage + tokens * SUPERBLOCK * 2
            + 8 * rows * 2 + rows * tokens * 4)


def test_host_counts_the_probe_kernels_layout():
    """P1 / P2: 32 rows a block of the 8-token tile, 64 of the 16-token
    one (whatever its tokens), a ring of 4 stages of 128 bytes, x's row of
    a stage of both parts at 2 · 34 places (32 units and 2 spare) rounded
    up to 2 mod 16 places of 8 bytes, a bf16 scale a group, part and row,
    one f32 partial a row and token."""
    src = (CSRC / "w4_probe_matmul.cu").read_text()
    w1, w2, stage, ring = _frame("w4_probe_matmul.cu")
    assert (16 * w1, 16 * w2) == (probe_rows(8), probe_rows(16))
    spare = int(re.search(r"kBlockUnits = kStageUnits \+ (\d+);", src)[1])
    assert re.search(r"return used \+ \(\(2 - used % 16\) \+ 16\) % 16;",
                     src)
    for tokens, tile in ((1, 8), (1, 16), (8, 16), (16, 16)):
        rows = probe_rows(tile)
        for stages in (1, 2):
            for groups in (1, 3, 8):
                used = 2 * (stage // 4 + spare) * groups * stages
                pitch = used + (2 - used) % 16
                assert pitch % 16 == 2
                assert probe_smem(tokens, groups, stages, tile) == (
                    256 + ring * rows * stage + tokens * pitch * 8
                    + groups * 2 * rows * 2 + rows * tokens * 4)
