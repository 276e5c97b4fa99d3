"""Bit-packing of VPTQ index streams and the sub-byte runtime formats.

Port of ``vptq_tpu/ops/packing.py``. The on-disk layout is the
reference packer's (reference: vptq/utils/pack.py:26-139): per scalar
the main and residual ids are merged as ``(res << index_bits) | main``,
the merged values are written LSB-first into one bitstream per
(codebook, out-vector) row, and the stream is cut into int32 words
(bit ``i`` of a word is stream position ``i``), zero-padded at the end
of each row.

The JAX package expands every bit into its own uint64 element, which at
Llama-3.1-8B width is ~0.9 GB per intermediate array for one
``gate_proj``. These versions work word by word instead: a merged id of
at most 32 bits starts at bit ``s`` of word ``w`` and spills into word
``w + 1`` when ``s + bits > 32``, so every id is the low and the high
half of one 64-bit window. They run on whatever device the input lies
on (the loader unpacks on the card).

The int4 / int3 / int2 quantizers and packers at the end give the
same bytes as the JAX package's numpy path (see :func:`_group_sq_err`).

torch's ``uint16`` has almost no operators, so uint16 payloads are kept
either as their int16 bit pattern (compact storage) or widened to int32
/ int64 for arithmetic and gathers (see :func:`widen_index`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = [
    "INT2_SCALE_CANDIDATES",
    "INT4_GROUP",
    "INT4_SCALE_CANDIDATES",
    "W2_BLOCK",
    "W2_GROUP",
    "W3_BLOCK",
    "pack_int2",
    "pack_int3",
    "pack_int4",
    "quantize_int2",
    "quantize_int3",
    "quantize_int4",
    "unpack_int2",
    "unpack_int3",
    "unpack_int4",
    "pack_index",
    "unpack_index",
    "view_as_uint16",
    "index_plane_dtype",
    "to_index_plane",
    "widen_index",
]

_U32 = 0xFFFFFFFF


def view_as_uint16(a: torch.Tensor) -> torch.Tensor:
    """Undo the checkpoint dtype trick; returns int32 holding uint16.

    Index/perm tensors are stored as uint16 bit patterns *viewed* as
    float16 or int16 "to avoid nccl and safetensor check" (reference
    vqlinear.py:110-113). Wider integer tensors are cut to 16 bits, as
    ``astype(np.uint16)`` does in the JAX package.
    """
    if a.dtype in (torch.float16, torch.int16, torch.uint16):
        return a.view(torch.int16).to(torch.int32) & 0xFFFF
    if a.dtype in (torch.int64, torch.int32, torch.uint32, torch.uint64):
        return (a.to(torch.int64) & 0xFFFF).to(torch.int32)
    raise ValueError(f"unexpected index dtype {a.dtype}")


def index_plane_dtype(num_centroids: int) -> torch.dtype:
    """Storage dtype of an index plane.

    uint8 for <= 256 centroids; otherwise the uint16 bit pattern held
    as int16 (the JAX package's uint16 plane, which torch cannot
    index with). :func:`widen_index` turns either into int64 ids.
    """
    return torch.uint8 if num_centroids <= 256 else torch.int16


def widen_index(ids: torch.Tensor) -> torch.Tensor:
    """Index plane (uint8, int16 uint16-pattern or wider) → int64 ids."""
    if ids.dtype == torch.int16:
        return ids.to(torch.int64) & 0xFFFF
    return ids.to(torch.int64)


def to_index_plane(ids: torch.Tensor, num_centroids: int) -> torch.Tensor:
    """int64 ids → compact plane of :func:`index_plane_dtype`."""
    dtype = index_plane_dtype(num_centroids)
    if dtype == torch.int16:
        # values < 65536: subtracting 2^16 from the upper half gives
        # the int16 with the same bit pattern
        ids = torch.where(ids >= 0x8000, ids - 0x10000, ids)
    return ids.to(dtype)


def _bit_positions(group: int, total_bits: int, device):
    pos = torch.arange(group, dtype=torch.int64, device=device) * total_bits
    return pos // 32, pos % 32


def pack_index(
    indices: torch.Tensor,
    index_bits: int,
    res_indices: Optional[torch.Tensor] = None,
    res_bits: int = 0,
) -> torch.Tensor:
    """Bit-pack main (+ residual) ids into int32 words.

    Args:
        indices: integer tensor (..., group_size) of main centroid ids.
        index_bits: bits per main id.
        res_indices: optional residual ids, same shape.
        res_bits: bits per residual id.

    Returns:
        int32 tensor (..., ceil(group_size * (index_bits+res_bits) / 32)).
    """
    total_bits = index_bits + res_bits
    if total_bits > 32:
        raise ValueError(f"total index bits {total_bits} must be <= 32")
    merged = indices.to(torch.int64)
    if res_indices is not None:
        merged = merged | (res_indices.to(torch.int64) << index_bits)

    group = merged.shape[-1]
    n_words = -(-group * total_bits // 32)
    word, shift = _bit_positions(group, total_bits, merged.device)
    # merged < 2^32 and shift < 32: the 64-bit window cannot overflow
    window = merged << shift
    words = torch.zeros(
        *merged.shape[:-1], n_words + 1, dtype=torch.int64,
        device=merged.device,
    )
    # ids never share a bit, so adding the pieces is OR-ing them
    words.index_add_(-1, word, window & _U32)
    words.index_add_(-1, word + 1, window >> 32)
    words = words[..., :n_words]
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32)


def unpack_index(
    packed: torch.Tensor,
    index_bits: int,
    group_size: int,
    res_bits: int = 0,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Inverse of :func:`pack_index`.

    Args:
        packed: int32 tensor (..., packed_group_size).
        index_bits: bits per main id.
        group_size: ids per row (reference calls this num_elements).
        res_bits: bits per residual id (0 disables residual).

    Returns:
        (main_ids, res_ids) as int64 tensors (..., group_size); res_ids
        is None when ``res_bits == 0``.
    """
    total_bits = index_bits + res_bits
    words = packed.to(torch.int64) & _U32
    words = torch.nn.functional.pad(words, (0, 1))
    word, shift = _bit_positions(group_size, total_bits, packed.device)
    lo = words.index_select(-1, word) >> shift
    # the spill word only matters when the id crosses a word boundary;
    # zeroing it at shift 0 keeps the 32-bit left shift from overflowing
    hi = torch.where(shift > 0, words.index_select(-1, word + 1), 0)
    merged = (lo | (hi << (32 - shift))) & ((1 << total_bits) - 1)

    main = merged & ((1 << index_bits) - 1)
    res = None
    if res_bits > 0:
        res = (merged >> index_bits) & ((1 << res_bits) - 1)
    return main, res


# --------------------------------------------------------------------
# int4 / int3 / int2 runtime formats (``vptq_tpu/ops/packing.py:150-413``)

INT4_GROUP = 128  # scale-group width along in_features
# absmax-shrink factors of the MSE scale search, largest first, so a
# tie keeps the larger scale
INT4_SCALE_CANDIDATES = tuple(1.0 - 0.05 * i for i in range(8))
INT2_SCALE_CANDIDATES = tuple(1.0 - 0.05 * i for i in range(13))
W3_BLOCK = 1024  # int3 padded width granule
W2_BLOCK = 1024  # int2 padded width granule
W2_GROUP = 64  # default int2 scale group


def _bf16_rne(x: torch.Tensor) -> torch.Tensor:
    """Round f32 → nearest-even bf16 → f32 (the scale storage dtype)."""
    return x.to(torch.bfloat16).to(torch.float32)


def _group_sq_err(
    g: torch.Tensor, levels: torch.Tensor, s: torch.Tensor
) -> torch.Tensor:
    """Per-group sum of f32 squared round-trip errors, in numpy's order.

    The scale search keeps a candidate only when its error is strictly
    lower, so near-ties follow the last bit of this sum. numpy sums a
    contiguous float32 axis of n <= 128 elements (n % 8 == 0) in eight
    lanes, lane j taking elements j, j+8, ... in turn, and then adds the
    lanes as ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)). Each step here is its
    own elementwise torch op, so nothing is contracted into an FMA and
    the result is that sum bit for bit, on any device.
    """
    n = g.shape[-1]
    if n % 8 or n > 128:
        raise ValueError(f"group {n} must be a multiple of 8 and <= 128")
    d = g - levels * s[..., None]
    e = (d * d).reshape(*d.shape[:-1], n // 8, 8)
    r = e[..., 0, :]
    for i in range(1, n // 8):
        r = r + e[..., i, :]
    return ((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])) + (
        (r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7])
    )


def _grid_quantize(w, group, divisor, candidates, encode, offset):
    """Per-(row, group) scale search shared by the three quantizers.

    ``encode(g, s)`` gives the codes for scales ``s``; a code's level is
    ``code + offset``. Candidates are tried one at a time, keeping only
    the best so far, so memory stays at a few copies of ``w``.
    """
    out_f, in_f = w.shape
    if in_f % group:
        raise ValueError(f"in_features {in_f} % group {group} != 0")
    g = w.reshape(out_f, in_f // group, group).to(torch.float32)
    absmax = g.abs().amax(dim=-1)
    base = torch.where(absmax > 0, absmax / divisor, 1.0)
    scale = _bf16_rne(base)
    q = encode(g, scale)
    best_err = _group_sq_err(g, q + offset, scale)
    for f in candidates:
        s = _bf16_rne(
            base * torch.tensor(f, dtype=torch.float32, device=g.device)
        )
        qc = encode(g, s)
        err = _group_sq_err(g, qc + offset, s)
        better = err < best_err
        best_err = torch.where(better, err, best_err)
        scale = torch.where(better, s, scale)
        q = torch.where(better[..., None], qc, q)
    return q.to(torch.int8).reshape(out_f, in_f), scale


def quantize_int4(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(row, 128-column group) int4: (q int8 in [-7, 7],
    scales f32 (out, in // 128), each bf16-exact), by an MSE grid search
    over shrinks of absmax / 7."""

    def encode(g, s):
        return torch.clamp(torch.round(g / s[..., None]), -7, 7)

    return _grid_quantize(
        w, INT4_GROUP, 7.0, INT4_SCALE_CANDIDATES[1:], encode, 0.0
    )


def quantize_int3(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(row, 128-column group) int3 in [-4, 3] from absmax / 3.5, with the int4
    shrink ladder plus the growths 1.15 and 1.3."""

    def encode(g, s):
        return torch.clamp(torch.round(g / s[..., None]), -4, 3)

    return _grid_quantize(
        w, INT4_GROUP, 3.5, INT4_SCALE_CANDIDATES[1:] + (1.15, 1.3), encode,
        0.0,
    )


def quantize_int2(
    w: torch.Tensor, group: int = W2_GROUP
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(row, group) int2 codes in [-2, 1] on the half-offset grid:
    the level is ``(q + 0.5) * scale``; base scale absmax / 1.5."""

    def encode(g, s):
        return torch.clamp(torch.round(g / s[..., None] - 0.5), -2, 1)

    return _grid_quantize(
        w, group, 1.5, INT2_SCALE_CANDIDATES[1:], encode, 0.5
    )


def _byte_values(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.uint8).to(torch.int16)


def _to_int8_bits(x: torch.Tensor) -> torch.Tensor:
    """int16 holding 0..255 → int8 with the same bit pattern."""
    return x.to(torch.uint8).view(torch.int8)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int4 values → (out, in/2) bytes: byte ``k`` holds column ``k`` in
    its low nibble and column ``in/2 + k`` in its high nibble."""
    out_f, in_f = q.shape
    if in_f % 2:
        raise ValueError("in_features must be even")
    half = in_f // 2
    lo = q[:, :half].to(torch.int16) & 0xF
    hi = q[:, half:].to(torch.int16) & 0xF
    return _to_int8_bits((hi << 4) | lo)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4` (nibbles sign-extended)."""
    b = _byte_values(packed)
    lo, hi = b & 0xF, b >> 4
    q = torch.cat([lo, hi], dim=1)
    return torch.where(q >= 8, q - 16, q).to(torch.int8)


def _pack_fields(u: torch.Tensor, n: int, bits: int) -> torch.Tensor:
    """Split the columns into ``n`` equal parts; byte ``k`` holds column
    ``m * in/n + k`` at bits ``bits*m ...``."""
    part = u.shape[1] // n
    plane = torch.zeros(
        (u.shape[0], part), dtype=torch.int16, device=u.device
    )
    for m in range(n):
        plane |= u[:, m * part: (m + 1) * part] << (bits * m)
    return _to_int8_bits(plane)


def _unpack_fields(plane: torch.Tensor, n: int, bits: int) -> torch.Tensor:
    p = _byte_values(plane)
    mask = (1 << bits) - 1
    return torch.cat([(p >> (bits * m)) & mask for m in range(n)], dim=1)


def pack_int3(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int3 values ([-4, 3]) → ``(plane2, plane1)``: plane2 (out, in/4)
    holds the low two bits of column ``k + q*in/4`` at bits 2q..2q+1 of
    byte ``k``; plane1 (out, in/8) holds the sign bit of column
    ``k + m*in/8`` at bit m of byte ``k``."""
    in_f = q.shape[1]
    if in_f % W3_BLOCK:
        raise ValueError(f"in_features must be a multiple of {W3_BLOCK}")
    u = q.to(torch.int16) & 0x7
    return _pack_fields(u & 0x3, 4, 2), _pack_fields(u >> 2, 8, 1)


def unpack_int3(plane2: torch.Tensor, plane1: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int3`."""
    two = _unpack_fields(plane2, 4, 2)
    sign = _unpack_fields(plane1, 8, 1)
    return (two - 4 * sign).to(torch.int8)


def pack_int2(q: torch.Tensor) -> torch.Tensor:
    """int2 codes ([-2, 1]) → (out, in/4) bytes: byte ``k`` holds the
    two's complement of column ``k + q*in/4`` at bits 2q..2q+1."""
    in_f = q.shape[1]
    if in_f % W2_BLOCK:
        raise ValueError(f"in_features must be a multiple of {W2_BLOCK}")
    return _pack_fields(q.to(torch.int16) & 0x3, 4, 2)


def unpack_int2(plane: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int2`."""
    u = _unpack_fields(plane, 4, 2)
    return torch.where(u >= 2, u - 4, u).to(torch.int8)
