"""P3's k-slot map (``csrc/vq_smallk_matmul.cu``, ``Map``): one warp of
the kernel emulated in numpy, step by step, from the pieces of the source.

Each step of the kernel is one ``mma.sync m16n8k16``: 16 weight rows as M,
the tokens as N, and 16 k-slots that the mode's ``Map`` permutes, so that
a thread's four slots of a row (2·tig, +1, +8, +9) are one whole v = 4
vector, one half of a v = 8 vector, or (onehot) four ids. The A fragments
come from the codebook table (256 rows of 128 bytes, the vector repeated,
lane l reading 8 bytes at ``table_lane(l)``) or from the ids' compare
against k, the B fragments from x staged as 8-byte units with spare units
after each chunk and a skewed row a token. This test reads every such
piece from the source (the Map constants and functions, ``kPad``,
``kStageUnits``, ``pitch_units``, ``table_lane``, the id's ``prmt``, the
staging and read offsets, the compare's selectors), runs a warp over two
stages of ids, and shows that every position of a row is multiplied
exactly once a stage, by an A and a B of the same position, that the
emulated products equal ``vq_smallk_matmul_reference`` at v 4 / 8, k 200 /
256, fused and onehot-only, and that a half warp's x reads fall in 16
distinct 8-byte bank pairs. The kernel itself runs only on the card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vptq_tpu_torch.ops.vq_smallk_matmul import (
    vq_smallk_matmul_reference, vq_smallk_smem,
)

SRC = (Path(__file__).resolve().parent.parent / "vptq_tpu_torch" / "csrc"
       / "vq_smallk_matmul.cu").read_text()
STAGE_IDS = 128  # ids of a row a stage (Frame<4, 128, 4>)


def _c(expr: str) -> str:
    """A C integer expression of the source as Python."""
    expr = re.sub(r"\b(0[xX][0-9A-Fa-f]+|\d+)[uU]\b", r"\1", expr)
    expr = re.sub(r"\b(M|ring|Frame)::", "", expr)
    expr = re.sub(r"kStageUnits<M>", "kStageUnits", expr)
    return " ".join(expr.replace("/", "//").split())


def _find(pattern: str, text: str = SRC) -> re.Match:
    m = re.search(pattern, text, re.S)
    assert m, pattern
    return m


def mode_map(v: int, onehot: bool) -> dict:
    """The Map of a mode: its constants, and chunk / lane_unit as Python
    functions, with kPad and the stage and pitch formulas."""
    head = ("template <int V>\nstruct Map<V, true> {" if onehot
            else f"template <>\nstruct Map<{v}, false> {{")
    start = SRC.index(head)
    body = SRC[start: SRC.index("\n};", start)]
    env = {k: int(n) for k, n in re.findall(
        r"static constexpr int (\w+) = (\d+);", body)}
    env["kPad"] = int(_find(r"constexpr int kPad = (\d+);")[1])
    env["kStageUnits"] = eval(_c(_find(
        r"constexpr int kStageUnits = (.*?);")[1]), {}, env)
    pitch = _c(_find(r"int pitch_units\(int stages\) \{\s*return (.*?);")[1])
    for fn in ("chunk", "lane_unit"):
        args, ret = _find(rf"static __device__ int {fn}\(([^)]*)\) \{{\s*"
                          r"return (.*?);", body).groups()
        names = [a.split()[-1] for a in args.split(",")]
        env[fn] = eval(f"lambda {', '.join(names)}: {_c(ret)}")
    env["pitch_units"] = eval(f"lambda stages: {pitch}", dict(env))
    return env


# the kernel's loop, read from the source
ID_EXPR = _c(_find(r"const uint32_t id0 = (__byte_perm\(word_of\(w0, .*?\));")[1]
             .replace("w0", "w"))
TABLE_LANE = _c(_find(r"int table_lane\(int lane\) \{ return (.*?); \}")[1])
TABLE_ROW = int(_find(r"constexpr int kTableRow = (\d+);")[1])
ONES = int(_find(r"kOnes = (0x[0-9A-Fa-f]+)u;")[1], 16)
HIT_SEL = {k: int(_find(rf"uint32_t hit_{k}\(uint32_t m\) \{{\s*return "
                        rf"__byte_perm\(m, 0u, (0x[0-9A-Fa-f]+)u\)")[1], 16)
           for k in ("lo", "hi")}
XU_EXPR = _c(_find(r"const int xu = (.*?);")[1])
XREAD_EXPR = _c(_find(r"ring::lds64\(xrow\[j\] \+ \((.*?)\) \* 8\)")[1])
XROW_LANE = _c(_find(r"xrow\[j\] = xs \+ min\(8 \* j \+ gid, tt - 1\) \* "
                     r"pitch \+ (.*?) \* 8;")[1])
PLACE_EXPR = _c(_find(r"\(u / M::kChunkUnits \* \(M::kChunkUnits \+ kPad\) \+ "
                      r"u % M::kChunkUnits\)")[0])


def _byte_perm(x: int, y: int, sel: int) -> int:
    b = [(x >> (8 * k)) & 0xFF for k in range(4)] + \
        [(y >> (8 * k)) & 0xFF for k in range(4)]
    return sum(b[(sel >> (4 * n)) & 7] << (8 * n) for n in range(4))


def _word_of(w: np.ndarray, i: int) -> int:
    return int(w[4 * i]) | int(w[4 * i + 1]) << 8 | int(w[4 * i + 2]) << 16 \
        | int(w[4 * i + 3]) << 24


def emulate(v: int, onehot: bool, k: int, tokens: int, stages: int = 2,
            seed: int = 0):
    """One warp (16 rows) of the kernel over ``stages`` stages of ids:
    (its products (16, tokens), the reference's, the (row, position) each
    slot of each step multiplied, the x units a half warp read a step)."""
    m = mode_map(v, onehot)
    rng = np.random.default_rng(seed)
    n_ids = STAGE_IDS * stages
    in_f = n_ids * v
    ids = rng.integers(0, 256, (16, n_ids)).astype(np.uint8)
    cb = torch.from_numpy(rng.normal(0, 0.02, (k, v)).astype(np.float32)) \
        .to(torch.bfloat16).float().numpy()
    x = torch.from_numpy(rng.normal(0, 1, (tokens, in_f)).astype(np.float32)) \
        .to(torch.bfloat16).float().numpy()
    # the table: 256 rows of 128 bytes, the vector repeated, zeros past k
    padded = np.zeros((256, v), np.float32)
    padded[:k] = cb
    table = np.tile(padded, (1, TABLE_ROW // 2 // v))
    # x staged: unit u of a token at its place in a row of pitch units
    pitch = m["pitch_units"](stages)
    xs = np.zeros((tokens, pitch, 4), np.float32)
    for u in range(stages * 8 * m["kChunkUnits"]):
        place = eval(PLACE_EXPR, {}, dict(m, u=u))
        if onehot:
            xs[:, place] = x[:, [(4 * u + i) * v for i in range(4)]]
        else:
            xs[:, place] = x[:, 4 * u: 4 * u + 4]
    out = np.zeros((16, 8), np.float64)
    slots = []  # per step: {(row, position), ...} of every slot's product
    banks = []  # per step and half warp: the 8-byte bank pair of each read
    for i in range(stages):
        for h in range(m["kChunks"]):
            for s in range(m["kSteps"]):
                a = np.zeros((16, 16))
                b = np.zeros((16, 8))
                pos_a = {}
                pos_b = {}
                half = [[], []]
                for lane in range(32):
                    gid, tig = lane >> 2, lane & 3
                    c = m["chunk"](tig, h)
                    xu = eval(XU_EXPR, {}, dict(m, i=i, c=c))
                    unit = eval(XREAD_EXPR, {}, dict(m, xu=xu, s=s)) + \
                        eval(XROW_LANE, {}, dict(m, lane_unit=m["lane_unit"],
                                                 tig=tig))
                    ks = (2 * tig, 2 * tig + 1, 2 * tig + 8, 2 * tig + 9)
                    for r in (gid, gid + 8):
                        chunk = ids[r, i * STAGE_IDS + 16 * c:
                                    i * STAGE_IDS + 16 * c + 16]
                        if onehot:
                            w = _word_of(chunk, s)
                            hit = sum(0xFF << (8 * j) for j in range(4)
                                      if (w >> (8 * j)) & 0xFF < k)
                            vals = []
                            for sel in (HIT_SEL["lo"], HIT_SEL["hi"]):
                                word = _byte_perm(hit, 0, sel) & ONES
                                vals += [1.0 if word & 0xFFFF else 0.0,
                                         1.0 if word >> 16 else 0.0]
                            idx = [i * STAGE_IDS + 16 * c + 4 * s + j
                                   for j in range(4)]
                            pos = [q * v for q in idx]
                        else:
                            cid = eval(ID_EXPR, {"__byte_perm": _byte_perm,
                                                 "word_of": lambda w_, q:
                                                 _word_of(chunk, q)},
                                       dict(s=s, w=None))
                            off = eval(TABLE_LANE, {}, dict(lane=lane)) // 2
                            vals = list(table[cid, off: off + 4])
                            id_at = i * STAGE_IDS + 16 * c + s
                            pos = [id_at * v + (off + e) % v for e in range(4)]
                            assert ids[r, id_at] == cid
                        for kk, val, p in zip(ks, vals, pos):
                            a[r, kk] = val
                            pos_a[(r, kk)] = p
                    # B: token gid's unit (a column past the tokens reads 0)
                    if gid < tokens:
                        b[list(ks), gid] = xs[gid, unit]
                    stage_u = unit - i * m["kStageUnits"]
                    ch, within = divmod(stage_u, m["kChunkUnits"] + m["kPad"])
                    assert within < m["kChunkUnits"], "a spare unit read"
                    u = i * 8 * m["kChunkUnits"] + ch * m["kChunkUnits"] + within
                    for kk, e in zip(ks, range(4)):
                        pos_b[kk] = ((4 * u + e) * v if onehot else 4 * u + e)
                    half[lane >= 16].append(
                        (min(gid, tokens - 1) * pitch + unit) % 16)
                out += a @ b
                for (r, kk), p in pos_a.items():
                    assert pos_b[kk] == p, (r, kk)
                slots.append({(r, p) for (r, _), p in pos_a.items()})
                banks.append(half)
    want = vq_smallk_matmul_reference(
        torch.from_numpy(x), torch.from_numpy(ids), torch.from_numpy(cb), v,
        onehot_only=onehot).numpy().T
    return out[:, :tokens], want, slots, banks


@pytest.mark.parametrize("onehot", [False, True])
@pytest.mark.parametrize("k", [200, 256])
@pytest.mark.parametrize("v", [4, 8])
def test_a_warp_of_the_kernel_computes_the_reference(v, k, onehot):
    """Two stages of ids (k 200: a fifth of the ids past the codebook, read
    as zeros or missed by the compare) and 3 tokens (columns 3-7 of N read
    nothing): the emulated mma products equal the plain version's."""
    got, want, slots, _ = emulate(v, onehot, k, tokens=3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("onehot", [False, True])
@pytest.mark.parametrize("v", [4, 8])
def test_every_position_of_a_stage_is_multiplied_once(v, onehot):
    """Per step, 16 rows x 16 slots of distinct (row, position) pairs; over
    a stage, each row's positions (onehot: the first of each id's) exactly
    once each."""
    _, _, slots, _ = emulate(v, onehot, 256, tokens=1, stages=1)
    assert all(len(step) == 16 * 16 for step in slots)
    seen = [p for step in slots for p in step]
    assert len(seen) == len(set(seen))
    positions = (range(0, STAGE_IDS * v, v) if onehot
                 else range(STAGE_IDS * v))
    assert set(seen) == {(r, p) for r in range(16) for p in positions}


@pytest.mark.parametrize("onehot", [False, True])
@pytest.mark.parametrize("v", [4, 8])
def test_x_reads_of_a_half_warp_fall_in_sixteen_bank_pairs(v, onehot):
    """With 8 tokens (every column of N live), the 16 lanes of each half
    warp read 16 distinct 8-byte bank pairs at every step; the table reads
    do too (table_lane), whatever the ids."""
    _, _, _, banks = emulate(v, onehot, 256, tokens=8, stages=1)
    for half in banks:
        for lanes in half:
            assert len(set(lanes)) == 16, lanes
    offsets = {eval(TABLE_LANE, {}, dict(lane=lane)) // 8 % 16
               for lane in range(16)}
    assert len(offsets) == 16


@pytest.mark.parametrize("onehot", [False, True])
@pytest.mark.parametrize("v", [4, 8])
def test_host_shared_memory_matches_the_kernel_layout(v, onehot):
    """``vq_smallk_smem``'s x bytes are the kernel's pitch_units (its chunk
    units, spare units and skew) times 8 bytes a token."""
    m = mode_map(v, onehot)
    for tokens, stages in ((1, 1), (3, 4), (16, 2)):
        x_bytes = (vq_smallk_smem(v, onehot, tokens, stages)
                   - vq_smallk_smem(v, onehot, 0, stages) - 64 * tokens * 4)
        assert x_bytes == tokens * m["pitch_units"](stages) * 8
