"""The levels the Hopper prefill tile (``csrc/lowbit_tile.cuh``) unpacks
are exact: for every byte value of every format it serves, and every
pair of bytes that ``prmt`` spreads into one bf16 pair, the tile's
arithmetic gives the plain unpack's level to the bit.

The tile turns the bytes of two positions into a bf16 pair in three
steps: ``__byte_perm`` spreads them into the two halves of a word, the
format policy's ``tile_code`` puts its code under a bf16 exponent (base +
code), and one ``fma.rn.bf16x2`` with ``kTileBias`` takes base + offset
away. int8's ``tile_code`` (``W8``) makes the signed level itself with a
``bf16x2_fma`` of its own, and its bias is 0. This test reads those
pieces from the CUDA sources (the spread selector, ``kOne``, the sign
flip of the bias, and each policy's ``tile_code``, ``tile_plane``,
``kTileBias`` and ``kParts``), runs them in numpy uint32 arithmetic with
a bf16 fma that rounds to nearest even, and holds the results to
``ops/packing.py``'s ``unpack_int4``, ``unpack_int3`` and ``unpack_int2``
(+ 0.5), and to the int8 byte's value. So it checks what the card
compiles; the kernels themselves run only there.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vptq_tpu_torch.ops.packing import unpack_int2, unpack_int3, unpack_int4

CSRC = Path(__file__).resolve().parent.parent / "vptq_tpu_torch" / "csrc"
TILE = (CSRC / "lowbit_tile.cuh").read_text()
# format -> (source, policy struct)
POLICIES = {
    "int4": ("w4.cuh", "W4"),
    "int3": ("w3_matmul.cu", "W3"),
    "int2": ("w2_matmul.cu", "W2"),
    "int8": ("w8.cuh", "W8"),
}
L = 8  # positions a row: one 8-byte word a plane, the bytes prmt reads
ROWS = 1 << 16  # every pair of bytes


def _c_expr(expr: str) -> str:
    """A C integer expression of the sources as Python: literal suffixes
    and namespace qualifiers dropped, a conditional turned around (the
    operators the policies use, ~ << >> & ^ | * +, bind alike in both
    languages; a call of bf16x2_fma runs :func:`_fma_bits`)."""
    expr = re.sub(r"\b(0[xX][0-9A-Fa-f]+|\d+)[uU]\b", r"\1", expr.strip())
    expr = re.sub(r"\b\w+::", "", expr)
    m = re.fullmatch(r"(.+?)\s*\?\s*(.+?)\s*:\s*(.+)", expr, re.S)
    return f"(({m[2]}) if ({m[1]}) else ({m[3]}))" if m else expr


def _run_body(body: str, env: dict):
    """Run a device function's body (declarations, then a return)."""
    env = dict(env, bf16x2_fma=_fma_bits)
    for stmt in filter(None, (s.strip() for s in body.split(";"))):
        if stmt.startswith("return "):
            return eval(_c_expr(stmt[len("return "):]), {}, env)
        m = re.fullmatch(r"(?:const\s+)?uint32_t\s+(\w+)\s*=\s*(.+)", stmt,
                         re.S)
        assert m, f"not a declaration: {stmt}"
        env[m[1]] = eval(_c_expr(m[2]), {}, env)
    raise AssertionError(f"no return in {body}")


def _policy(fmt: str) -> dict:
    """kParts, kTileSlots, kTileBias, tile_plane and tile_code of a format
    policy, read from its struct."""
    source, name = POLICIES[fmt]
    src = (CSRC / source).read_text()
    start = src.index(f"struct {name} {{")
    struct = src[start: src.index("\n};", start)]

    def const(key):
        return int(re.search(rf"\b{key} = (0x[0-9A-Fa-f]+|\d+)u?;",
                             struct)[1], 0)

    def body(fn):
        return re.search(rf"\b{fn}\(.*?\)\s*\{{(.*?)\}}", struct, re.S)[1]

    return dict(parts=const("kParts"), slots=const("kTileSlots"),
                bias=const("kTileBias"), plane=body("tile_plane"),
                code=body("tile_code"))


def _u32(words: np.ndarray) -> np.ndarray:
    """(rows, 4) bytes as little-endian uint32."""
    return np.ascontiguousarray(words).view("<u4")[:, 0]


def _byte_perm(x, y, selector: int):
    """CUDA's __byte_perm: byte n of the result is byte (selector >> 4n) &
    7 of the 8 bytes (x, y)."""
    b = [(x >> (8 * k)) & 0xFF for k in range(4)]
    b += [(y >> (8 * k)) & 0xFF for k in range(4)]
    out = np.zeros_like(x)
    for n in range(4):
        out |= b[(selector >> (4 * n)) & 7] << np.uint32(8 * n)
    return out


def _bf16(bits) -> np.ndarray:
    return (np.asarray(bits, np.uint32) << np.uint32(16)).view(np.float32) \
        .astype(np.float64)


def _round_bf16(v: np.ndarray) -> np.ndarray:
    """v rounded to bf16's 8 significant bits, to nearest even."""
    m, e = np.frexp(v)
    return np.ldexp(np.rint(m * 256.0), e - 8)


def _fma_bf16x2(a, b, c):
    """fma.rn.bf16x2 per half: a·b + c exact, then one rounding; the
    (lo, hi) results as float64."""
    out = []
    for shift in (0, 16):
        def half(w):
            return _bf16((np.asarray(w, np.uint32) >> np.uint32(shift))
                         & np.uint32(0xFFFF))
        out.append(_round_bf16(half(a) * half(b) + half(c)))
    return out


def _fma_bits(a, b, c) -> np.ndarray:
    """The device function bf16x2_fma: :func:`_fma_bf16x2`'s halves packed
    back into uint32 words of two bf16 (exact: each half is rounded to
    bf16 already)."""
    lo, hi = (np.asarray(v, np.float32).view(np.uint32) >> np.uint32(16)
              for v in _fma_bf16x2(a, b, c))
    return (lo | (hi << np.uint32(16))).astype(np.uint32)


def _planes(fmt: str, tig: int):
    """The planes of ``ROWS`` rows of ``L`` positions, in which positions
    2·tig and 2·tig + 1 of the rows hold every pair of bytes of each plane
    (the sign plane of int3 the pair swapped, so that each position also
    meets every (quarter byte, sign byte) pair); the other positions hold
    other bytes. Returns (planes as the tile reads them, levels (ROWS,
    parts·L) of the plain unpack)."""
    rng = np.random.default_rng(tig)
    i = (np.arange(ROWS, dtype=np.uint32) + tig * 0x3A7D) & 0xFFFF
    pair = np.stack([i & 0xFF, i >> 8], axis=1).astype(np.uint8)

    def plane(pairs):
        p = rng.integers(0, 256, (ROWS, L), dtype=np.uint8)
        p[:, 2 * tig: 2 * tig + 2] = pairs
        return p

    def t(a):
        return torch.from_numpy(a.view(np.int8))

    if fmt == "int3":
        lo, hi, sign = plane(pair), plane(pair), plane(pair[:, ::-1])
        levels = unpack_int3(t(np.concatenate([lo, hi], axis=1)), t(sign))
        return (lo, hi, sign), levels.double().numpy()
    one = plane(pair)
    if fmt == "int8":
        return (one,), one.view(np.int8).astype(np.float64)
    if fmt == "int4":
        return (one,), unpack_int4(t(one)).double().numpy()
    return (one,), unpack_int2(t(one)).double().numpy() + 0.5


def _tile_levels(pol: dict, planes, tig: int, part: int):
    """The tile's (lo, hi) levels of part ``part`` at positions 2·tig and
    2·tig + 1, from the sources' pieces."""
    spread = eval(_c_expr(re.search(
        r"const uint32_t spread = (.+?);", TILE)[1]), {}, {"tig": tig})
    k_one = int(re.search(r"kOne = (0x[0-9A-Fa-f]+)u;", TILE)[1], 16)
    flip = int(re.search(
        r"bf16x2_fma\(P::tile_code\(t\[j\], p\), kOne,\s*"
        r"P::kTileBias \^ (0x[0-9A-Fa-f]+)u\)", TILE)[1], 16)
    t = []
    for slot in range(pol["slots"]):
        src = planes[_run_body(pol["plane"], {"p": part, "i": slot})]
        t.append(_byte_perm(_u32(src[:, :4]), _u32(src[:, 4:]), spread))
    code = _run_body(pol["code"], {"t": t, "p": part})
    assert code.dtype == np.uint32
    return _fma_bf16x2(code, np.uint32(k_one), np.uint32(pol["bias"] ^ flip))


def test_tile_arithmetic_is_the_one_the_tests_emulate():
    """The pieces this file reads are where it reads them, and every
    policy that has tile hooks is one of the formats tested here."""
    assert "fma.rn.bf16x2" in TILE
    assert "__byte_perm(q0.x, q0.y, spread)" in TILE
    hooked = set()
    for f in CSRC.glob("*.cu*"):
        src = f.read_text()
        for m in re.finditer(r"\bstruct (\w+) \{", src):
            if "kTileBias" in src[m.end(): src.index("\n};", m.end())]:
                hooked.add(m[1])
    assert hooked == {name for _, name in POLICIES.values()}


CASES = [(fmt, p) for fmt, n in (("int4", 2), ("int3", 8), ("int2", 4),
                                 ("int8", 1))
         for p in range(n)]


@pytest.mark.parametrize("fmt,part", CASES)
def test_tile_levels_equal_the_plain_unpack(fmt, part):
    pol = _policy(fmt)
    assert pol["parts"] == sum(f == fmt for f, _ in CASES)
    for tig in range(4):
        planes, want = _planes(fmt, tig)
        lo, hi = _tile_levels(pol, planes, tig, part)
        col = part * L + 2 * tig
        np.testing.assert_array_equal(lo, want[:, col])
        np.testing.assert_array_equal(hi, want[:, col + 1])
