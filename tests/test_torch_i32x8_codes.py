"""P1c's unpack (``csrc/w4_i32x8_matmul.cu``) gives every level exactly,
and its A fragments hold the levels of the columns its x fragments hold.

The kernel turns two int32 words a, b of a row into a bf16 pair of one
nibble plane in three steps: ``spread_lo`` / ``spread_hi`` (a ``prmt``)
put the low (planes 0-3) or high (planes 4-7) 16 bits of a and b into the
two halves of a word; ``level_pair`` shifts plane p's nibbles to bits 0-3
and 16-19, puts them under a bf16 exponent (``kNibbles``, ``kBase``: 128 +
level) and one ``fma.rn.bf16x2`` with ``kOne`` and ``kBias`` takes the 128
away. This test reads those pieces from the CUDA source, runs them in
numpy uint32 arithmetic with a bf16 fma that rounds to nearest even, over
all 16 levels of each of the 8 planes of each word of every word pair it
combines, and holds the result to ``ops/w4_i32x8_matmul.py``'s
``i32x8_levels``. Then it rebuilds a superblock's levels from the
kernel's A fragments (its chunk, word-pair and plane steps, read from the
source) and its B fragments' x units, and holds them to the same levels
column by column. The kernel itself runs only on the card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vptq_tpu_torch.ops.w4_i32x8_matmul import SUPERBLOCK, i32x8_levels

SRC = (Path(__file__).resolve().parent.parent / "vptq_tpu_torch" / "csrc"
       / "w4_i32x8_matmul.cu").read_text()


def _const(name: str) -> int:
    """A constexpr of the source: a literal, or an expression of others."""
    expr = re.search(rf"constexpr (?:uint32_t|int) {name} = (.*?);", SRC)[1]
    expr = re.sub(r"\b(0[xX][0-9A-Fa-f]+|\d+)[uU]\b", r"\1", expr)
    names = {n: _const(n) for n in re.findall(r"\bk\w+", expr)}
    return int(eval(expr.replace("/", "//"), {}, names))


def _body(fn: str) -> str:
    """The returned expression of a one-line device function."""
    m = re.search(rf"\b{fn}\([^)]*\)\s*\{{\s*return (.*?);\s*\}}", SRC, re.S)
    return re.sub(r"\b\w+::", "", " ".join(m[1].split()))


def _byte_perm(x, y, selector: int):
    """CUDA's __byte_perm: byte n of the result is byte (selector >> 4n) &
    7 of the 8 bytes (x, y)."""
    b = [(x >> np.uint32(8 * k)) & np.uint32(0xFF) for k in range(4)]
    b += [(y >> np.uint32(8 * k)) & np.uint32(0xFF) for k in range(4)]
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


def _fma_bits(a, b, c) -> np.ndarray:
    """fma.rn.bf16x2: per half a·b + c exact, then one rounding to bf16;
    the halves packed back into uint32 words."""
    halves = []
    for shift in (0, 16):
        def half(w):
            return _bf16((np.asarray(w, np.uint32) >> np.uint32(shift))
                         & np.uint32(0xFFFF))
        r = _round_bf16(half(a) * half(b) + half(c)).astype(np.float32)
        halves.append(r.view(np.uint32) >> np.uint32(16))
    return (halves[0] | (halves[1] << np.uint32(16))).astype(np.uint32)


ENV = {k: np.uint32(_const(k)) for k in
       ("kSelLo", "kSelHi", "kNibbles", "kBase", "kOne", "kBias")}


def spread(a, b, hi: bool):
    """spread_lo / spread_hi of the source, on uint32 arrays."""
    body = _body("spread_hi" if hi else "spread_lo")
    return eval(body, {"__byte_perm": _byte_perm},
                dict(ENV, a=a, b=b))


def level_pair(t, p: int):
    """level_pair of the source: plane p's levels of a spread word as
    (low, high) float64 halves."""
    bits = eval(_body("level_pair"), {"bf16x2_fma": _fma_bits},
                dict(ENV, t=t, p=p))
    return _bf16(bits & np.uint32(0xFFFF)), _bf16(bits >> np.uint32(16))


def test_unpack_constants_are_the_magic_number_idiom():
    """128.0 in both halves is the base, 1.0 the multiplier, -128.0 the
    bias, the nibble mask takes bits 0-3 of each half; the selectors take
    bytes 0-1 and 2-3 of each word."""
    assert _bf16(ENV["kBase"] & np.uint32(0xFFFF)) == 128.0
    assert _bf16(ENV["kOne"] >> np.uint32(16)) == 1.0
    assert _bf16(ENV["kBias"] >> np.uint32(16)) == -128.0
    assert ENV["kNibbles"] == np.uint32(0x000F000F)
    assert (int(ENV["kSelLo"]), int(ENV["kSelHi"])) == (0x5410, 0x7632)


@pytest.mark.parametrize("plane", range(8))
def test_every_level_of_every_plane_of_a_word_pair(plane):
    """Words a and b holding every (level, level) pair in plane ``plane``
    and random nibbles in the other planes: the pair is exactly (a's
    level, b's level), and so for every other plane."""
    rng = np.random.default_rng(plane)
    la, lb = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    la, lb = la.ravel().astype(np.uint32), lb.ravel().astype(np.uint32)
    shift = np.uint32(4 * plane)
    keep = np.uint32(~(0xF << (4 * plane)) & 0xFFFFFFFF)
    a = (rng.integers(0, 2 ** 32, la.size, dtype=np.uint64).astype(np.uint32)
         & keep) | (la << shift)
    b = (rng.integers(0, 2 ** 32, lb.size, dtype=np.uint64).astype(np.uint32)
         & keep) | (lb << shift)
    words = torch.from_numpy(np.stack([a, b], 1).view(np.int32))
    # i32x8_levels of a one-superblock row whose words 0 and 1 are (a, b):
    # plane p of word m is natural column 128·p + m
    row = torch.zeros((la.size, SUPERBLOCK // 8), dtype=torch.int32)
    row[:, :2] = words
    want = i32x8_levels(row).numpy()
    for p in range(8):
        lo, hi = level_pair(spread(a, b, p >= 4), p)
        np.testing.assert_array_equal(lo, want[:, 128 * p])
        np.testing.assert_array_equal(hi, want[:, 128 * p + 1])
    lo, hi = level_pair(spread(a, b, plane >= 4), plane)
    np.testing.assert_array_equal(lo, la)
    np.testing.assert_array_equal(hi, lb)


def _kernel_line(pattern: str) -> re.Match:
    m = re.search(pattern, SRC, re.S)
    assert m, pattern
    return m


def test_fragments_cover_a_superblock_with_its_own_x():
    """One warp's A fragments over the four 128-byte stages of a
    superblock, as the kernel makes them (chunks 2·tig + h, words 0, 1 and
    2, 3 of a chunk as the pairs of slots 2·tig, +1 and 2·tig + 8, +9,
    plane p from spread_lo below 4 and spread_hi above), each level placed
    at the column of its step's x unit (the source's u0 and plane stride):
    every column of the superblock is covered once, with i32x8_levels'
    level. Random words over all of int32."""
    # the pieces of the source this emulation follows
    _kernel_line(r"ring::wswz\(2 \* tig \+ h, r0\)")
    _kernel_line(r"spread_lo\(w0\[h\]\.x, w0\[h\]\.y\), "
                 r"spread_lo\(w0\[h\]\.z, w0\[h\]\.w\)")
    _kernel_line(r"const uint32_t\(&t\)\[2\]\[2\] = p < 4 \? lo : hi;")
    u0_expr = _kernel_line(r"const int u0 = (.*?);")[1]
    plane_step = int(_kernel_line(r"bx\[j\] = ring::lds64\(xb\[j\] \+ "
                                  r"(\d+) \* 8 \* p\)")[1])
    k_unit_x = _const("kUnitX")
    k_unit_stages = _const("kUnitStages")
    rng = np.random.default_rng(7)
    words = rng.integers(0, 2 ** 32, (16, SUPERBLOCK // 8),
                         dtype=np.uint64).astype(np.uint32)
    want = i32x8_levels(torch.from_numpy(words.view(np.int32))).numpy()
    got = np.full(want.shape, -1.0)
    for i in range(k_unit_stages):  # the 128-byte stages of the superblock
        su = i % k_unit_stages
        for tig in range(4):
            for h in range(2):
                q = 2 * tig + h  # the chunk: words 4q .. 4q + 3 of the stage
                w = words[:, 32 * su + 4 * q: 32 * su + 4 * q + 4]
                u0 = eval(u0_expr.replace("/", "//"), {},
                          dict(i=i, kUnitStages=k_unit_stages, kUnitX=k_unit_x,
                               su=su, tig=tig, h=h))
                for p in range(8):
                    col = 4 * (u0 + plane_step * p)  # the B unit's columns
                    for pair, (a, b) in enumerate(((0, 1), (2, 3))):
                        lo, hi = level_pair(
                            spread(w[:, a], w[:, b], p >= 4), p)
                        for off, lev in ((0, lo), (1, hi)):
                            c = col + 2 * pair + off
                            assert (got[:, c] == -1).all(), c
                            got[:, c] = lev
    np.testing.assert_array_equal(got, want)
