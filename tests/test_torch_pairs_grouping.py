"""K5a ``w8_matmul_pairs``'s grouping of the pairs by expert on the card,
emulated step by step in numpy (``csrc/expert_select.cuh``
``mark_experts``, ``nth_expert``, ``collect_pairs``; the passes and
column tiles of ``csrc/decode_gemv.cuh`` ``decode_gemv_grouped``), held
against ``np.unique`` / ``np.argsort`` over seeded ids; and the host plan
(``ops/scaled_matmul.py`` ``pairs_plan``) at the main path's shapes. The
constants the kernel takes from its sources (the bitmap's experts, the
columns of a pass, the grouping's shared memory) are read from them."""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest

from vptq_tpu_torch.ops import scaled_matmul as sm

CSRC = Path(__file__).resolve().parent.parent / "vptq_tpu_torch" / "csrc"
H100_SMS = 132


def _constant(source: str, name: str) -> int:
    m = re.search(rf"\b{name} = (\d+)", (CSRC / source).read_text())
    assert m, f"{name} not in {source}"
    return int(m.group(1))


MAX_EXPERTS = _constant("expert_select.cuh", "kMaxExperts")
WORDS = MAX_EXPERTS // 32
MAX_COLS = _constant("decode_gemv.cuh", "kMaxCols")
GROUP_BYTES = _constant("decode_gemv.cuh", "kGroupBytes")
# the ring's slots of a block of 2 consumer warps (32 rows) and of 4 (64)
_RING = re.search(r"kRing = kCons == 2 \? (\d+) : (\d+);",
                  (CSRC / "decode_gemv.cuh").read_text())
RING_SLOTS = {32: int(_RING.group(1)), 64: int(_RING.group(2))}
LANES = np.arange(32)


def _clamp(ids, n_experts):
    """``sel::expert_of``: an id clamped into the stack."""
    return np.clip(np.asarray(ids, np.int64), 0, n_experts - 1)


def mark_experts(ids, n_experts):
    """The bitmap of the experts the pairs pick: WORDS words of 32 bits."""
    bits = np.zeros(WORDS, np.uint64)
    for e in _clamp(ids, n_experts):
        bits[e >> 5] |= np.uint64(1) << np.uint64(e & 31)
    return bits


def _popc(v) -> int:
    return bin(int(v)).count("1")


def nth_expert(bits, s):
    """One warp: lane l < WORDS counts word l, an inclusive shuffle scan
    (``__shfl_up_sync`` by 1, 2, 4, ...) gives each word's first rank, and
    the lane whose word holds rank s clears its lowest bits up to it."""
    word = [int(bits[lane]) if lane < WORDS else 0 for lane in LANES]
    n = [_popc(w) for w in word]
    below = list(n)
    d = 1
    while d < WORDS:
        below = [below[lane] + (below[lane - d] if lane >= d else 0)
                 for lane in LANES]
        d <<= 1
    below = [b - c for b, c in zip(below, n)]
    here = [below[lane] <= s < below[lane] + n[lane] for lane in LANES]
    if not any(here):
        return -1
    lane = here.index(True)
    w = word[lane]
    for _ in range(below[lane], s):
        w &= w - 1
    return 32 * lane + (w & -w).bit_length() - 1


def collect_pairs(ids, n_experts, e, first, n):
    """One warp's ballots over the ids 32 at a time: expert e's pairs of
    rank first .. first + n - 1 (ascending p) and the expert's count."""
    ids = _clamp(ids, n_experts)
    cols, seen = {}, 0
    for base in range(0, len(ids), 32):
        p = base + LANES
        mine = (p < len(ids)) & (ids[np.minimum(p, len(ids) - 1)] == e)
        hit = sum(1 << int(lane) for lane in LANES[mine])
        for lane in LANES[mine]:
            rank = seen + _popc(hit & ((1 << int(lane)) - 1))
            if first <= rank < first + n:
                cols[rank - first] = int(p[lane])
        seen += _popc(hit)
    return seen, [cols[t] for t in sorted(cols)]


def block(ids, n_experts, slot, cols):
    """What the blocks of one slot serve: None past the distinct experts,
    else (expert, the pairs of each pass)."""
    e = nth_expert(mark_experts(ids, n_experts), slot)
    if e < 0:
        return None
    count, _ = collect_pairs(ids, n_experts, e, 0, cols)
    passes = []
    for k in range(-(-count // cols)):
        _, got = collect_pairs(ids, n_experts, e, k * cols, cols)
        assert len(got) == min(cols, count - k * cols)
        passes.append(got)
    return e, passes


def _ids(rng, pattern, pairs, n_experts):
    if pattern == "random":
        return rng.integers(0, n_experts, pairs)
    if pattern == "one expert":
        return np.full(pairs, rng.integers(0, n_experts))
    if pattern == "expert parallel":
        # moe_local: the pairs of the other ranks' experts go to local 0
        ids = rng.integers(0, n_experts, pairs)
        return np.where(rng.random(pairs) < 0.75, 0, ids)
    if pattern == "out of range":
        return rng.integers(-5, n_experts + 5, pairs)
    if pattern == "top-k":
        k = min(8, n_experts)
        return np.concatenate([
            rng.permutation(n_experts)[:k] for _ in range(-(-pairs // k))
        ])[:pairs]
    raise ValueError(pattern)


PATTERNS = ("random", "one expert", "expert parallel", "out of range",
            "top-k")


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("n_experts", [8, 64, 256])
@pytest.mark.parametrize("pairs", [1, 2, 6, 16, 31, 32, 33, 48, 100, 384,
                                   512])
def test_grouping_serves_every_pair_once_in_ascending_order(pairs, n_experts,
                                                            pattern):
    """The slots of a launch (min(P, E) of them) against np.unique /
    np.argsort: slot s takes the s-th distinct (clamped) expert, its pairs
    in ascending p, at most a pass's columns at a time; slots past the
    distinct experts take nothing; every pair lands in one slot, once."""
    rng = np.random.default_rng(pairs * 1000 + n_experts)
    ids = _ids(rng, pattern, pairs, n_experts)
    clamped = _clamp(ids, n_experts)
    distinct = np.unique(clamped)
    cols = sm.pairs_plan(4096, 4096, pairs, n_experts, H100_SMS)[0]
    order = np.argsort(clamped, kind="stable")
    served = []
    for slot in range(min(pairs, n_experts)):
        got = block(ids, n_experts, slot, cols)
        if slot >= len(distinct):
            assert got is None
            continue
        e, passes = got
        assert e == distinct[slot]
        mine = [p for k in passes for p in k]
        assert mine == list(np.flatnonzero(clamped == e))
        assert all(1 <= len(k) <= cols for k in passes)
        served += mine
    # the slots in turn serve the pairs as a stable sort by expert
    assert served == list(order)
    assert sorted(served) == list(range(pairs))


@pytest.mark.parametrize("count", [1, 7, 8, 9, 16, 17, 64])
@pytest.mark.parametrize("cols", [1, 8, 16])
def test_pass_columns_fill_tiles_and_store_only_pairs(cols, count):
    """A pass of T pairs on NT tiles of 8 columns (one tile up to 8
    columns a pass, two past it): column 8j + gid reads x row
    list[min(8j + gid, T - 1)] and is stored to y row list[8j + gid] only
    below T; over the passes every pair is stored once."""
    ids = np.zeros(count, np.int64)
    _, passes = block(ids, 8, 0, cols)
    assert len(passes) == -(-count // cols)
    tiles = 1 if cols <= 8 else 2
    stored = []
    for lst in passes:
        T = len(lst)
        for j in range(tiles):
            for gid in range(8):
                col = 8 * j + gid
                read = lst[min(col, T - 1)]
                assert read in lst
                if col < T:
                    stored.append(lst[col])
    assert stored == list(range(count))


def test_nth_expert_on_the_bitmaps_edges():
    """Bits at each word's ends, every bit, and no bit."""
    full = np.full(WORDS, 2 ** 32 - 1, np.uint64)
    assert [nth_expert(full, s) for s in range(MAX_EXPERTS)] == list(
        range(MAX_EXPERTS))
    assert nth_expert(full, MAX_EXPERTS) == -1
    edges = [0, 31, 32, 63, 200, MAX_EXPERTS - 1]
    bits = mark_experts(edges, MAX_EXPERTS)
    assert [nth_expert(bits, s) for s in range(len(edges) + 1)] == edges + [-1]
    assert nth_expert(np.zeros(WORDS, np.uint64), 0) == -1


def test_constants_agree_with_the_sources():
    """The host's limits are the kernel's: the bitmap's experts, the
    columns of a pass, and the grouping's bytes hold the bitmap, the
    expert and its count and a pass's pairs."""
    assert sm.PAIRS_MAX_EXPERTS == MAX_EXPERTS == 32 * WORDS
    assert sm.PAIRS_MAX_COLS == MAX_COLS == 16
    assert sm.PAIRS_RING == RING_SLOTS
    assert GROUP_BYTES >= 4 * WORDS + 8 + 4 * MAX_COLS
    # the host's count of a block's shared memory, term by term as
    # grouped_smem_bytes adds it: a slot holds a stage of the rows, of
    # each column's x and the rows' scales
    for rows in (32, 64):
        for cols in (1, 8, 16):
            slot = rows * 128 + cols * 256 + rows * 4
            assert sm.pairs_smem(rows, cols) == (
                128 + 128 + RING_SLOTS[rows] * slot + 12 * rows * cols
                + GROUP_BYTES)


# (out, in_p) of the expert stacks on the main path: Mixtral-8x7B's gate_up
# and down, Moonlight-16B-A3B's (down's 1408 padded to the int8 group 512),
# DeepSeek-R1's
MIXTRAL = {"gate_up": (28672, 4096), "down": (4096, 14336)}
MOONLIGHT = {"gate_up": (2816, 2048), "down": (2048, 1536)}
R1 = {"gate_up": (4096, 7168), "down": (7168, 2048)}
PLAN_CASES = (
    [("mixtral", s, p, 8) for s in MIXTRAL for p in (3, 16, 128)]
    + [("moonlight", s, p, 64) for s in MOONLIGHT for p in (6, 48, 384)]
    + [("r1", s, p, 256) for s in R1 for p in (8, 64)]
)


@pytest.mark.parametrize("model,shape,pairs,n_experts", PLAN_CASES)
def test_pairs_plan_makes_two_blocks_an_sm(model, shape, pairs, n_experts):
    """At every pair count the main path sends: a legal split (1, 2, 4 or
    8, at most the row's stages), columns a pass within the kernel's and
    P's, rows of 32 or 64, and two blocks or more for each SM, two of
    which fit an SM's shared memory (each with the block's reserved
    kilobyte)."""
    out_f, in_p = {"mixtral": MIXTRAL, "moonlight": MOONLIGHT,
                   "r1": R1}[model][shape]
    cols, rows, split = sm.pairs_plan(out_f, in_p, pairs, n_experts,
                                      H100_SMS)
    stages = in_p // 128
    assert split in sm.DECODE_SPLITS and split <= stages
    assert split & (split - 1) == 0 and split <= 8
    assert 1 <= cols <= min(MAX_COLS, pairs) and rows in (32, 64)
    slots = min(pairs, n_experts)
    blocks = -(-out_f // rows) * slots * split
    smem = sm.pairs_smem(rows, cols)
    assert blocks >= 2 * H100_SMS
    assert smem <= sm._BLOCK_SMEM
    assert 2 * (smem + sm._BLOCK_RESERVED) <= sm._SM_SMEM


def test_pairs_plan_reads_no_ids():
    """The plan, and so the grid, is a function of P, E and the shapes:
    it takes nothing else, and the same arguments give the same plan."""
    params = list(inspect.signature(sm.pairs_plan).parameters)
    assert params == ["out_f", "in_p", "pairs", "n_experts", "n_sm"]
    sm.pairs_plan.cache_clear()
    first = sm.pairs_plan(28672, 4096, 16, 8, H100_SMS)
    sm.pairs_plan.cache_clear()
    assert sm.pairs_plan(28672, 4096, 16, 8, H100_SMS) == first


def test_pairs_plan_columns_by_pairs_a_slot():
    """Up to 8 columns a pass (one tile) while the pairs are at most four
    a slot on average, up to 16 (two tiles) past it, never more than P;
    64-row blocks where they are two an SM, else 32."""
    assert sm.pairs_plan(2816, 2048, 6, 64, H100_SMS)[0] == 6
    assert sm.pairs_plan(28672, 4096, 3, 8, H100_SMS)[0] == 3
    assert sm.pairs_plan(2816, 2048, 48, 64, H100_SMS)[0] == 8
    assert sm.pairs_plan(28672, 4096, 16, 8, H100_SMS)[0] == 8
    assert sm.pairs_plan(28672, 4096, 32, 8, H100_SMS)[0] == 8
    assert sm.pairs_plan(28672, 4096, 33, 8, H100_SMS)[0] == 16
    assert sm.pairs_plan(2816, 2048, 384, 64, H100_SMS)[0] == 16
    assert sm.pairs_plan(28672, 4096, 3, 8, H100_SMS)[1:] == (64, 1)
    assert sm.pairs_plan(4096, 14336, 3, 8, H100_SMS)[1:] == (32, 1)
    assert sm.pairs_plan(4096, 14336, 6, 8, H100_SMS)[1:] == (64, 1)


@pytest.mark.parametrize("shape", sorted(MIXTRAL))
@pytest.mark.parametrize("pairs", [1, 2, 3])
def test_pairs_plan_routes_by_p_alone(shape, pairs):
    """Up to PAIRS_GEMV_MAX pairs (one token's top 2: every expert one
    pair) the plan's split 0 sends the launch to w8.cuh's GEMV, whatever
    the ids, E or the shape, and at P = 2 that GEMV's grid of 16-row tiles
    times the pairs is two blocks an SM or more at Mixtral's shapes; past
    it the grouped kernel runs. The wrapper's rule says the same."""
    from vptq_tpu_torch.ops.w8_matmul_pairs import takes_decode_gemv

    out_f, in_p = MIXTRAL[shape]
    grouped = pairs > sm.PAIRS_GEMV_MAX
    assert sm.PAIRS_GEMV_MAX == 2
    for n_experts in (8, 64, 256):
        split = sm.pairs_plan(out_f, in_p, pairs, n_experts, H100_SMS)[2]
        assert (split > 0) == grouped == takes_decode_gemv(pairs)
    if pairs == 2:
        assert -(-out_f // 16) * pairs >= 2 * H100_SMS
