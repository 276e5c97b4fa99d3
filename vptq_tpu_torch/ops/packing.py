"""Bit-packing of VPTQ index streams, in torch.

Port of ``vptq_tpu/ops/packing.py:40-149``. The on-disk layout is the
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

torch's ``uint16`` has almost no operators, so uint16 payloads are kept
either as their int16 bit pattern (compact storage) or widened to int32
/ int64 for arithmetic and gathers (see :func:`widen_index`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = [
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
