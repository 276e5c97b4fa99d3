"""P1 / P2's ring GEMV (``csrc/w4_probe_matmul.cu``): each mode's unpack
gives the plain version's levels exactly, one warp's fragments multiply
every column of a stage once by its own x, and every scale group is
folded once with its own scale row.

Each mode is a policy of namespace ``unpack`` whose ``levels`` turns byte
j of a word into the levels of both parts (``lo``: the low nibble's
column k, ``hi``: the high one's, in_p/2 + k) in its own arithmetic:
``shl`` (a left shift, as a signed int), ``asr`` (an arithmetic right
shift), ``i2f`` (the integer-to-float convert), ``rintf`` and ``fmaf``;
``pair`` packs two levels into a bf16x2 word with ``cvt.rn.bf16x2.f32``.
These tests read those bodies, the mode table of the C entry and the
kernel's index expressions from the CUDA source, run them in numpy (f32
arithmetic, bf16 rounding to nearest even), and hold them to
``ops/w4_probe_matmul.py``'s plain version: ``unpack_int4``'s levels for
prod, t8 and g256, ``level·2²⁸`` (with 2⁻²⁸ on the scale) for shift28,
``b − 16·round(b/16)`` and ``round(b/16)`` for fma16 and fma16f32. The
kernel itself runs only on the card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vptq_tpu_torch.ops.packing import unpack_int4
from vptq_tpu_torch.ops.scaled_matmul import DECODE_SPLITS
from vptq_tpu_torch.ops.w4_probe_matmul import F32_X_MODES, W4_PROBE_MODES

CSRC = Path(__file__).resolve().parent.parent / "vptq_tpu_torch" / "csrc"
SRC = (CSRC / "w4_probe_matmul.cu").read_text()
RING = (CSRC / "ring_gemv.cuh").read_text()


def _c_expr(expr: str) -> str:
    """A C expression of the source as Python: no casts, no namespaces, no
    float suffixes, integer division."""
    expr = re.sub(r"\((?:size_t|int|uint32_t)\)", "", expr)
    expr = re.sub(r"\b\w+::", "", expr)
    expr = re.sub(r"\b(\d+\.\d*)f\b", r"\1", expr)
    return " ".join(expr.replace("/", "//").split())


def _line(pattern: str, text: str = SRC) -> str:
    """Group 1 of ``pattern`` in the source (whitespace-insensitive)."""
    m = re.search(pattern, text, re.S)
    assert m, pattern
    return m[1]


def _int_const(name: str, text: str = SRC) -> int:
    """An int constexpr of the source, a literal or an expression of
    others (ring_gemv.cuh's among them)."""
    m = re.search(rf"constexpr int {name} = (.*?);", text)
    if m is None:
        return _int_const(name, RING)
    expr = _c_expr(m[1].split("//")[0])
    names = {n: _int_const(n) for n in re.findall(r"\bk\w+", expr)}
    return int(eval(expr, {}, names))


# ---- the policies' arithmetic, in numpy -----------------------------------


def shl(w, n: int) -> np.ndarray:
    """(int)(w << n) on 32-bit words."""
    w = np.asarray(w).astype(np.int64) & 0xFFFFFFFF
    return ((w << n) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def asr(v, n: int) -> np.ndarray:
    return np.asarray(v, np.int32) >> np.int32(n)


def i2f(v) -> np.ndarray:
    return np.asarray(v, np.int32).astype(np.float32)


def rintf(v) -> np.ndarray:
    return np.rint(np.asarray(v, np.float32))


def fmaf(a, b, c) -> np.ndarray:
    """a·b + c exact, rounded once to f32 (exact in f64 for these
    operands: small integers)."""
    return (np.float64(a) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _policy(name: str) -> str:
    return _line(rf"struct {name} \{{(.*?)\n\}};")


def levels(policy: str, w: np.ndarray, j: int) -> tuple:
    """``policy::levels(w, j, lo, hi)`` of the source, on uint32 words."""
    body = _line(r"levels\(uint32_t w, int j, float& lo, float& hi\) "
                 r"\{(.*?)\n  \}", _policy(policy))
    env = dict(shl=shl, asr=asr, i2f=i2f, rintf=rintf, fmaf=fmaf,
               w=w.astype(np.uint32), j=j)
    for stmt in body.split(";"):
        stmt = stmt.strip()
        if not stmt:
            continue
        target, expr = (p.strip() for p in stmt.split("=", 1))
        env[target.split()[-1]] = eval(_c_expr(expr), {}, env)
    return env["lo"], env["hi"]


def low_scale(policy: str) -> float:
    lit = _line(r"static constexpr float kLowScale = (.*?);", _policy(policy))
    return float.fromhex(lit[:-1]) if lit.startswith("0x") else float(lit[:-1])


def _round_bf16(v) -> np.ndarray:
    """f32 values rounded to bf16, to nearest even, as f32 bits' upper
    halves (uint32)."""
    bits = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    bits = bits + 0x7FFF + ((bits >> 16) & 1)
    return ((bits >> 16) & 0xFFFF).astype(np.uint32)


def pair(a, b) -> np.ndarray:
    """``pair(a, b)`` of the source: cvt.rn.bf16x2.f32 with its operands
    as the source orders them (the first operand the upper half)."""
    asm = _line(r'asm\("cvt\.rn\.bf16x2\.f32 %0, %1, %2;" : "=r"\(d\) : '
                r'"f"\((\w)\), "f"\(\w\)\);')
    hi, lo = (a, b) if asm == "a" else (b, a)
    return _round_bf16(lo) | (_round_bf16(hi) << np.uint32(16))


def _bf16_halves(bits) -> tuple:
    bits = np.asarray(bits, np.uint32)
    lo = (bits << np.uint32(16)).view(np.float32)
    hi = (bits & np.uint32(0xFFFF0000)).view(np.float32)
    return lo, hi


def modes() -> dict:
    """{mode: (policy, x's type, scale group)} from the C entry's switch,
    each mode's code its enumerator's place in ``unpack::Mode``."""
    enum = [e.strip() for e in
            _line(r"enum Mode \{(.*?)\};").split(",")]
    cases = dict(re.findall(
        r"case (k\w+):\s*return launch<(\w+, \w+, \d+)>", SRC))
    by_code = {code: name for name, code in W4_PROBE_MODES.items()}
    out = {}
    for code, enumerator in enumerate(enum):
        policy, xt, group = (p.strip() for p in cases[enumerator].split(","))
        out[by_code[code]] = (policy, xt, int(group))
    return out


def test_mode_table_matches_the_host():
    """Every mode of the host has its case, in the host's code order:
    x in f32 exactly for F32_X_MODES, group 256 exactly for g256, and the
    policy of its arithmetic (t8 and g256 are prod's)."""
    table = modes()
    assert sorted(table) == sorted(W4_PROBE_MODES)
    for mode, (policy, xt, group) in table.items():
        assert (xt == "float") == (mode in F32_X_MODES), mode
        assert group == (256 if mode == "g256" else 128), mode
        assert policy == {"shift28": "Shift28", "fma16": "Fma16",
                          "fma16f32": "Fma16"}.get(mode, "Prod"), mode


def _plain_levels(mode: str, b: np.ndarray) -> tuple:
    """The plain version's levels (lo, hi) of int8 bytes b, and the low
    part's scale factor, from ops/w4_probe_matmul.py's own path."""
    t = torch.from_numpy(b.astype(np.int8)[:, None])
    if mode in ("fma16", "fma16f32"):
        f = t.to(torch.float32)[:, 0]
        hi = torch.round(f * 0.0625)
        return (f - 16.0 * hi).numpy(), hi.numpy(), 1.0
    lv = unpack_int4(t).to(torch.float32).numpy()
    if mode == "shift28":
        return lv[:, 0] * 2.0 ** 28, lv[:, 1], 2.0 ** -28
    return lv[:, 0], lv[:, 1], 1.0


@pytest.mark.parametrize("j", range(4))
@pytest.mark.parametrize("mode", sorted(W4_PROBE_MODES))
def test_every_byte_unpacks_to_the_plain_levels(mode, j):
    """All 256 byte values at byte j of a word whose other bytes are
    random: both parts' levels are exact and equal the plain version's
    (shift28: the low level times 2^28, its scale times 2^-28, so that
    level × scale is the plain one's), and so are their bf16 pairs with a
    neighbour's."""
    policy = modes()[mode][0]
    rng = np.random.default_rng(j)
    b = np.arange(256, dtype=np.uint32)
    other = rng.integers(0, 2 ** 32, 256, dtype=np.uint64).astype(np.uint32)
    w = (other & np.uint32(~(0xFF << (8 * j)) & 0xFFFFFFFF)) | (
        b << np.uint32(8 * j))
    lo, hi = levels(policy, w, j)
    want_lo, want_hi, factor = _plain_levels(mode, b)
    np.testing.assert_array_equal(lo, want_lo)
    np.testing.assert_array_equal(hi, want_hi)
    assert low_scale(policy) == factor
    # the pair of byte j with byte j ^ 1 of the same word, in bf16
    k = j ^ 1
    lo_k, hi_k = levels(policy, w, k)
    for a, c in ((lo, lo_k), (hi, hi_k)):
        got_a, got_c = _bf16_halves(pair(a, c))
        np.testing.assert_array_equal(got_a, a)
        np.testing.assert_array_equal(got_c, c)


def test_the_policies_keep_their_own_arithmetic():
    """The probe measures an unpack: no mode falls back to K2's
    magic-number idiom, prod sign-extends the byte and converts each
    nibble, shift28 converts b << 28 (prod's low nibble without its right
    shift), fma16 converts the byte once."""
    code = re.sub(r"//[^\n]*", "", SRC)
    assert not any(k in code for k in ("magic", "0x4B00", "bf16x2_fma",
                                       "w4::", "tile_code"))
    prod = _policy("Prod")
    assert prod.count("i2f(") == 2 and "asr(shl(b, 28), 28)" in prod
    shift28 = _policy("Shift28")
    assert "i2f(shl(b, 28))" in shift28 and "asr(shl(b, 28)" not in shift28
    fma = _policy("Fma16")
    assert fma.count("i2f(") == 1 and "rintf(" in fma and "fmaf(" in fma


# ---- one warp over one stage ---------------------------------------------


def _expr(pattern: str) -> str:
    return _c_expr(_line(pattern))


X_DST = _expr(r"dst = xs \+ \((.*?)\) \*\s*8;")  # a staged unit's place
X_BASE = _expr(r"xb\[j\] = xs \+ \((.*?)\) \* 8;")  # a thread's x row
X_STEP = _expr(r"ring::lds64\(xb\[j\] \+ (.*?)\);")  # a B read's offset
X_STAGE = _expr(r"const uint32_t xi = (.*?);")
PART_STEP = _expr(r"const uint32_t part_step = (.*?);")
PITCH = _c_expr(_line(r"inline int x_pitch\(int stages\) \{(.*?)\n\}"))
UNITS = {k: _int_const(k) for k in ("kBlockUnits", "kStageUnits", "kParts")}


def x_pitch(stages: int) -> int:
    """The source's ``x_pitch``: 8-byte units of a token's row of x."""
    env = dict(UNITS, stages=stages)
    for stmt in (p.strip() for p in PITCH.split(";")):
        if stmt.startswith("return"):
            return eval(stmt[len("return"):], {}, env)
        if stmt:
            target, expr = stmt.split("=", 1)
            env[target.split()[-1]] = eval(expr, {}, env)
    raise AssertionError("x_pitch has no return")


def _staged_x(tt: int, nl: int, max_st: int, pitch: int) -> dict:
    """{byte offset in x's area: (token, part, stage, unit)} as the
    consumers stage it: unit u of stage i of part p of token t."""
    placed = {}
    for t in range(tt):
        for p in range(UNITS["kParts"]):
            for i in range(nl):
                for u in range(UNITS["kStageUnits"]):
                    at = 8 * eval(X_DST, {}, dict(UNITS, t=t, p=p, i=i, u=u,
                                                  pitch=pitch, max_st=max_st))
                    assert at not in placed
                    placed[at] = (t, p, i, u)
    return placed


def _a_slots():
    """The A registers' (row r0 / r0 + 8, byte of the word) of each part,
    read from the af initialiser."""
    init = _line(r"const uint32_t af\[kParts\]\[4\] = \{(.*?)\};")
    parts = re.findall(r"\{(pair\(.*?\)), (pair\(.*?\)), (pair\(.*?\)), "
                       r"(pair\(.*?\))\}", " ".join(init.split()))
    out = []
    for regs in parts:
        out.append([[tuple(int(v) for v in re.findall(
            r"\w+\[(\d)\]\[(\d)\]", arg)[k]) for k in range(2)]
            for arg in regs])
    return out  # [part][register][low / high half] -> (row, byte)


@pytest.mark.parametrize("tt", [1, 3, 8, 16])
def test_fragments_cover_a_stage_with_its_own_x(tt):
    """One warp's A fragments over one 128-byte stage of its 16 rows, as
    the kernel makes them (chunks 2·tig + h read back from their swizzled
    slot places, word u of rows r0 and r0 + 8, the af initialiser's
    bytes), against the B fragments it reads from x as the consumers
    staged it (each token tile's x row, the stage's and part's offsets,
    the step's unit): every column of both parts of the stage is
    multiplied once for each token column of a tile, by x of that token
    and that column."""
    nt = 1 if tt <= 8 else 2
    nl, max_st, i = 3, 4, 2  # stage 2 of a range of 3, room for 4
    pitch = x_pitch(max_st)
    placed = _staged_x(tt, nl, max_st, pitch)
    slots = _a_slots()
    # the slot's chunk of chunk c of row r, both ways
    wswz = _c_expr(_line(r"int wswz\(int c, int r\) \{ return (.*?); \}",
                         RING))
    chunk_of = _c_expr(_line(r"const int c = ring::wswz\((.*?), r0\);"))
    # the words and bytes of a step: word u of rows r0 (w0) and r0 + 8 (w1)
    _line(r"(const uint32_t wa = word\(w0\[h\], u\), "
          r"wb = word\(w1\[h\], u\);)")
    _line(r"(P::levels\(wa, k, lo\[0\]\[k\], hi\[0\]\[k\]\);\s*"
          r"P::levels\(wb, k, lo\[1\]\[k\], hi\[1\]\[k\]\);)")
    _line(r"(const uint32_t bf\[2\] = \{bx\[j\]\.x, bx\[j\]\.y\};\s*"
          r"ring::mma_bf16\(acc\[p\]\[j\], af\[p\], bf\);)")
    hit = {}
    for j in range(nt):
        for h in range(2):
            for u in range(4):
                for p in range(UNITS["kParts"]):
                    # A[(row, k-slot)] = weight position, B[(k-slot,
                    # column)] = (token, x position), from every lane
                    a_frag, b_frag = {}, {}
                    for lane in range(32):
                        gid, tig = lane >> 2, lane & 3
                        c = eval(chunk_of, {}, dict(tig=tig, h=h))
                        for r in (gid, gid + 8):
                            place = eval(wswz, {}, dict(c=c, r=r))
                            # the producer put chunk c' of row r at
                            # wswz(c', r): the slot place holds chunk c
                            assert [cc for cc in range(8) if eval(
                                wswz, {}, dict(c=cc, r=r)) == place] == [c]
                        q = 16 * c + 4 * u  # word u of chunk c
                        # register k's halves: rows gid (k even) and gid + 8
                        # (k odd), k-slots 2·tig, +1 (k < 2) and 2·tig + 8,
                        # +9 (k >= 2): the mma's A layout
                        for k, halves in enumerate(slots[p]):
                            for half, (row, byte) in enumerate(halves):
                                assert row == (k & 1)
                                kslot = 2 * tig + 8 * (k >> 1) + half
                                a_frag[(gid + 8 * row, kslot)] = q + byte
                        tok = min(8 * j + gid, tt - 1)
                        if 8 * j + gid >= tt:
                            continue  # the column keeps zeros, never stored
                        base = 8 * eval(X_BASE, {}, dict(
                            UNITS, tok=tok, pitch=pitch, tig=tig))
                        at = eval("(" + X_STEP + ")", {}, dict(
                            UNITS, xi=eval(X_STAGE, {}, dict(UNITS, i=i)),
                            p=p, h=h, u=u, part_step=eval(
                                PART_STEP, {}, dict(UNITS, max_st=max_st))))
                        unit = placed[base + at]
                        assert unit[1:] == (p, i, q // 4), (lane, h, u, p)
                        # b0 (.x) holds x positions q, q + 1 at k-slots
                        # 2·tig, +1; b1 (.y) q + 2, q + 3 at 2·tig + 8, +9
                        for e in range(2):
                            for half in range(2):
                                b_frag[(2 * tig + 8 * e + half, gid)] = (
                                    unit[0], q + 2 * e + half)
                    for (m, kslot), pos in a_frag.items():
                        for n in range(8):
                            if (kslot, n) not in b_frag:
                                continue
                            key = (p, m, pos, 8 * j + n)
                            assert key not in hit
                            hit[key] = b_frag[(kslot, n)]
    want = {(p, r, pos, t): (t, pos) for p in range(2) for r in range(16)
            for pos in range(128) for t in range(tt)}
    assert hit == want


@pytest.mark.parametrize("tokens", [1, 8, 16])
def test_a_half_warps_x_reads_are_free_of_bank_conflicts(tokens):
    """Each B read (8 bytes) of a half warp (four token columns, the four
    threads of each) lies in its own pair of banks, or shares its place
    with another lane's read (a broadcast), at every step of a stage."""
    max_st = 5
    pitch = x_pitch(max_st)
    assert pitch % 16 == 2
    part_step = eval(PART_STEP, {}, dict(UNITS, max_st=max_st))
    for j in range(1 if tokens <= 8 else 2):
        for half in range(2):
            for h in range(2):
                for u in range(4):
                    for p in range(2):
                        places = {}
                        for lane in range(16 * half, 16 * half + 16):
                            gid, tig = lane >> 2, lane & 3
                            tok = min(8 * j + gid, tokens - 1)
                            at = 8 * eval(X_BASE, {}, dict(
                                UNITS, tok=tok, pitch=pitch, tig=tig)) + eval(
                                "(" + X_STEP + ")", {}, dict(
                                    UNITS, xi=eval(X_STAGE, {}, dict(UNITS, i=3)),
                                    p=p, h=h, u=u, part_step=part_step))
                            places.setdefault((at // 8) % 16, set()).add(at)
                        assert all(len(v) == 1 for v in places.values())


# ---- the scale groups -----------------------------------------------------


@pytest.mark.parametrize("group,in_p,split", [
    (g, i, s) for g in (128, 256) for i in (2048, 4096, 12288)
    for s in DECODE_SPLITS if s <= i // 2 // g])
def test_every_group_is_folded_once_with_its_scale_row(group, in_p, split):
    """Over a cluster's ranks (range_of over a part's groups, g256's two
    stages each), the stages each rank runs and its folds (after every
    kGS-th stage, with the scales staged from row p·L/128 + kGS·g): every
    group of each part is folded once, after the stages that hold its
    positions, with the plain version's scale row (g256: 2·(k // 256) for
    the low part, in_p/256 + 2·(k // 256) for the high one)."""
    k_stage = _int_const("kStage", RING)
    k_gs = group // k_stage
    L = in_p // 2
    n = L // group
    dg = (CSRC / "decode_gemv.cuh").read_text()
    span = _line(r"void range_of\(int r, int split, int n, int& a,\s*"
                 r"int& b\) \{(.*?)\n\}", dg)
    ring_a = _c_expr(_line(r"\ba = (.*?);", span))
    ring_b = _c_expr(_line(r"\bb = (.*?);", span))
    _line(r"(ring::range_of\(rank, split, n, ga, gb\);)")
    assert _expr(r"const int n = (.*?);") == "L // G"
    st0 = _expr(r"const int st0 = (.*?);")
    nl_e = _expr(r"const int nl = (.*?);")
    srow_e = _expr(r"const size_t srow = (.*?);")
    fold = _expr(r"if \((i % kGS == kGS - 1)\)")
    g_of = _expr(r"const int g = (ga \+ e / \(kRows \* kParts\));")
    p_of = _expr(r"const int p = (\(e / kRows\) % kParts);")
    sp_e = _expr(r"const __nv_bfloat16\* sp = ss \+ (.*?);")
    _line(r"(sp\[p \* kRows \+ r0\])")
    folded = {}
    for r in range(split):
        ga, gb = eval(ring_a, {}, dict(r=r, n=n, split=split)), eval(
            ring_b, {}, dict(r=r, n=n, split=split))
        env = dict(ga=ga, gb=gb, kGS=k_gs)
        s0, nl = eval(st0, {}, env), eval(nl_e, {}, env)
        pending = [[], []]
        for i in range(nl):
            for p in range(2):
                pending[p].extend(range(k_stage * (s0 + i),
                                        k_stage * (s0 + i + 1)))
            if eval(fold, {}, dict(i=i, kGS=k_gs)):
                for p in range(2):
                    # the staged entry the fold reads for row 0
                    kRows, kParts = 32, 2
                    e = eval(sp_e, {}, dict(i=i, kGS=k_gs, kParts=kParts,
                                            kRows=kRows)) + p * kRows
                    assert eval(p_of, {}, dict(e=e, kRows=kRows,
                                               kParts=kParts)) == p
                    g = eval(g_of, {}, dict(ga=ga, e=e, kRows=kRows,
                                            kParts=kParts))
                    srow = eval(srow_e, {}, dict(p=p, L=L, kStage=k_stage,
                                                 kGS=k_gs, g=g))
                    key = (p, tuple(pending[p]))
                    assert key not in folded
                    folded[key] = srow
                    pending[p] = []
        assert pending == [[], []]
    want = {}
    for p in range(2):
        for gi in range(n):
            pos = tuple(range(group * gi, group * (gi + 1)))
            # the plain version's scale row of column p·L + pos
            row = (2 * gi + (p * in_p // 256) if group == 256
                   else (p * L + group * gi) // 128)
            want[(p, pos)] = row
    assert folded == want
