"""Host side shared by the group-scaled dequant-matmul kernels.

K1 ``w8_matmul`` (``csrc/w8_matmul.cu``) and K2 ``w4_matmul``, K3
``w2_matmul`` and K4 ``w3_matmul`` (``csrc/w{4,2,3}_matmul.cu``, on the
skeleton ``csrc/lowbit.cuh``) compute one function: ``y = x @ (s ⊙ L)^T``
where ``L`` holds each weight's exact level and ``s`` one scale per
(row, column group). x is rounded to bf16, the products of each group
are summed in f32, the group's scale multiplies that f32 partial, and
the partials are summed in f32. The MoE kernels K6 ``w{8,4}_matmul_expert``
and K5 ``w{8,4}_matmul_pairs`` compute it on one expert of a stacked
weight, picked by int32 ids that stay on the device.
:func:`grouped_reference` is that arithmetic in plain torch;
:func:`launch` checks the tensors and calls a kernel through ctypes on
PyTorch's current stream.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from vptq_tpu_torch.ops import _build

__all__ = [
    "DECODE_FORMATS", "DECODE_SPLITS", "DECODE_STAGE", "check_pairs",
    "decode_blocks", "decode_route", "decode_rows", "decode_smem",
    "decode_split", "grouped_reference", "launch", "pairs_plan",
    "pairs_smem", "pick_expert", "ring_plan", "ring_split", "ring_tile",
    "sm_count",
]

# The Hopper decode GEMV of K1–K4 (csrc/decode_gemv.cuh) at T <= 16, and
# of K5b on its pairs of one token each: a block owns 32 rows (up to 8
# tokens) or 64 (up to 16) and a range of DECODE_STAGE-position stages; a
# cluster of DECODE_SPLITS[i] blocks splits the positions of a row.
DECODE_STAGE = 128
DECODE_SPLITS = (1, 2, 4, 8)
_BLOCK_SMEM = 232448  # one block's limit on an H100
_SM_SMEM = 233472  # an SM's, of which each block holds _BLOCK_RESERVED more
_BLOCK_RESERVED = 1024
# (parts, byte planes, scale bytes a row and stage) of each format's decode
# GEMV: int8 one f32 scale a stage, int4 a bf16 one for each of two parts,
# int3 for each of eight, int2 for each of four parts and 64 or 128
# positions
DECODE_FORMATS = {
    "w8": (1, 1, 4), "w4": (2, 1, 4), "w3": (8, 3, 16),
    "w2g64": (4, 1, 16), "w2g128": (4, 1, 8),
}


def decode_rows(tokens: int) -> int:
    """Rows of one decode-GEMV block at ``tokens`` (its token tile)."""
    return 32 if tokens <= 8 else 64


def decode_blocks(out_f: int, tokens: int) -> int:
    """Row blocks of the decode GEMV over ``out_f`` rows."""
    return -(-out_f // decode_rows(tokens))


def decode_smem(parts: int, tokens: int, stages: int, planes: int = 1,
                scale_bytes: int = 4) -> int:
    """Shared memory of one decode-GEMV block whose range is ``stages``
    stages (bytes): the ring (four slots of a stage of one plane, or two of
    ``planes`` planes), x for ``tokens`` rows of ``parts`` parts of those
    stages, the scales of each stage (``scale_bytes`` a row) and the
    partials the cluster's ranks push (3 f32 a row and token)."""
    rows = decode_rows(tokens)
    ring = 4 if planes == 1 else 2  # decode_gemv.cuh kRingOf
    return (256 + ring * planes * rows * DECODE_STAGE
            + tokens * parts * stages * DECODE_STAGE * 2
            + stages * rows * scale_bytes + 3 * rows * tokens * 4)


@functools.lru_cache(maxsize=None)
def decode_split(out_f: int, positions: int, parts: int, tokens: int,
                 n_sm: int, planes: int = 1, scale_bytes: int = 4,
                 pairs: int = 1) -> int:
    """The cluster size of the decode GEMV: how many blocks split the
    ``positions`` (whole stages; int8 in_p, int4 in_p / 2, int2 in_p / 4,
    int3 in_p / 8) of each row block at ``tokens`` <= 16, for a card of
    ``n_sm`` SMs; ``planes`` and ``scale_bytes`` as for
    :func:`decode_smem` (:data:`DECODE_FORMATS`). ``pairs``: the row
    blocks are launched that many times (K5b: one token a pair, each pair
    its expert's row blocks).

    The smallest of 1, 2, 4, 8 that makes two blocks or more for each SM,
    counting every pair's, and whose x fits a block, and up to 8 tokens
    two blocks an SM's shared memory; failing that, the largest that fits
    (most blocks, least x each). 0, so that the older GEMV runs, where the
    positions are no whole stages or no split fits x into a block."""
    stages = positions // DECODE_STAGE
    if positions % DECODE_STAGE or not 1 <= tokens <= 16:
        return 0
    smem = {s: decode_smem(parts, tokens, -(-stages // s), planes,
                           scale_bytes)
            for s in DECODE_SPLITS if s <= stages}
    fits = [s for s, b in smem.items() if b <= _BLOCK_SMEM]
    for s in fits:
        pair = 2 * (smem[s] + _BLOCK_RESERVED) <= _SM_SMEM
        if (decode_blocks(out_f, tokens) * pairs * s >= 2 * n_sm
                and (tokens > 8 or pair)):
            return s
    return fits[-1] if fits else 0


# K5a's grouped pairs GEMV (csrc/decode_gemv.cuh decode_gemv_grouped,
# sel::Grouped in csrc/expert_select.cuh): a grid of (split, row blocks,
# min(P, E) expert slots); the blocks of a slot stream one distinct
# expert's rows once for all of its pairs, at most `cols` of them a pass
# (the product's N: one 8-column tile up to 8, two past it), through a
# ring whose slots hold a stage of the block's rows, of the pass's x rows
# and of the rows' scales (8 slots of 32-row blocks, 4 of 64-row ones).
# The bitmap's bits bound E.
PAIRS_MAX_EXPERTS = 256
PAIRS_MAX_COLS = 16
PAIRS_RING = {32: 8, 64: 4}
# up to this many pairs every expert has one (a token's top-k are
# distinct) and w8.cuh's GEMV, one pair a grid row, is the faster: the
# plan's split 0 routes there, by P alone
PAIRS_GEMV_MAX = 2


def pairs_smem(rows: int, cols: int) -> int:
    """Shared memory of one grouped pairs block (bytes) of ``rows`` rows
    and ``cols`` columns a pass: alignment and barriers, the ring (each
    slot a stage of the rows, 128 positions of each column's x, the rows'
    f32 scales), the partials the cluster's ranks push (3 f32 a row and
    column) and the grouping (bitmap, expert, count, the pass's pairs)."""
    slot = rows * DECODE_STAGE + cols * DECODE_STAGE * 2 + rows * 4
    return 256 + PAIRS_RING[rows] * slot + 3 * rows * cols * 4 + 128


@functools.lru_cache(maxsize=None)
def pairs_plan(out_f: int, in_p: int, pairs: int, n_experts: int,
               n_sm: int) -> tuple:
    """(columns a pass, rows a block, cluster size) of K5a's grouped pairs
    GEMV on ``pairs`` rows of x over a stack of ``n_experts`` (out_f,
    in_p) int8 slabs, for a card of ``n_sm`` SMs: a function of P, E and
    the shapes alone, never of the ids' values. Split 0 (P at most
    :data:`PAIRS_GEMV_MAX`: by P alone) sends the launch to w8.cuh's
    GEMV.

    Columns: up to 8 while the pairs are at most four a slot on average
    (every token's top-k picks distinct experts, so up to 8 tokens an
    expert has at most 8 pairs), else up to 16; never more than P. Rows:
    64 where min(P, E) slots' 64-row blocks are two or more an SM, else
    32. Split: the smallest of 1, 2, 4, 8 (at most the row's stages) whose
    blocks, times the split, are two or more an SM."""
    slots = min(pairs, n_experts)
    cols = min(pairs, 8 if pairs <= 4 * slots else PAIRS_MAX_COLS)
    if pairs <= PAIRS_GEMV_MAX:
        return cols, 32, 0
    stages = max(in_p // DECODE_STAGE, 1)
    rows = 64 if -(-out_f // 64) * slots >= 2 * n_sm else 32
    blocks = -(-out_f // rows) * slots
    split = next((s for s in DECODE_SPLITS
                  if s <= stages and blocks * s >= 2 * n_sm),
                 max(s for s in DECODE_SPLITS if s <= stages))
    return cols, rows, split


def ring_tile(tokens: int) -> int:
    """Tokens of one token tile of the probes' ring GEMV
    (``csrc/ring_gemv.cuh``) by default: 8 up to 8 tokens, else 16."""
    return 8 if tokens <= 8 else 16


def ring_split(row_blocks: int, units: int, tokens: int, tile: int,
               n_sm: int, smem_of) -> tuple:
    """(split, whether it makes two blocks an SM that two at a time fit an
    SM's shared memory) of :func:`ring_plan` at one token tile."""
    t = min(tokens, tile)
    blocks = row_blocks * -(-tokens // tile)
    smem = {s: smem_of(t, -(-units // s))
            for s in DECODE_SPLITS if s <= units}
    fits = [s for s, b in smem.items() if b <= _BLOCK_SMEM]
    for s in fits:
        if (blocks * s >= 2 * n_sm
                and 2 * (smem[s] + _BLOCK_RESERVED) <= _SM_SMEM):
            return s, True
    return (fits[-1] if fits else 0), False


def ring_plan(out_f: int, units: int, tokens: int, n_sm: int, smem_of,
              rows_of) -> tuple:
    """(token tile, cluster size) of a probe's ring GEMV: how many tokens a
    block takes (8 or 16) and how many blocks split the ``units`` of a row
    (P1c: superblocks, P3: stages of 128 ids), where ``smem_of(tokens,
    units)`` is one block's shared memory and ``rows_of(tile)`` its rows,
    on a card of ``n_sm`` SMs.

    Per tile (:func:`ring_tile`'s first, then 8), the smallest split of 1,
    2, 4, 8 whose blocks (the row blocks of every token tile, times the
    split) are two or more for each SM and two of which fit an SM's shared
    memory; failing that at every tile, the default tile's largest split
    whose block fits (most blocks, least x each). The split is 0 where no
    block fits."""
    first = None
    for tile in dict.fromkeys((ring_tile(tokens), 8)):
        split, ok = ring_split(-(-out_f // rows_of(tile)), units, tokens,
                               tile, n_sm, smem_of)
        if ok:
            return tile, split
        first = first or (tile, split)
    return first


def decode_route(out_f: int, positions: int, fmt: str, x: torch.Tensor,
                 pairs: bool = False) -> int:
    """The split a K1–K4 launch passes its kernel: decode_split's for x of
    1 to 16 tokens in format ``fmt`` (a key of :data:`DECODE_FORMATS`),
    else 0. ``pairs``: x's rows are a pairs launch's (K5b), one token
    each, all of them counted."""
    parts, planes, scale_bytes = DECODE_FORMATS[fmt]
    rows = x.numel() // positions // parts if positions else 0
    tokens, n_pairs = (1, rows) if pairs else (rows, 1)
    if not 1 <= tokens <= 16 or n_pairs < 1:
        return 0
    return decode_split(out_f, positions, parts, tokens, sm_count(x.device),
                        planes, scale_bytes, n_pairs)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device (cached)."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


# the output dtypes the kernels write, by their out_dtype code; fp16 is
# written as f32 and rounded once, to nearest even, on the way out (the
# TPU wrappers round their f32 sums to x.dtype the same way)
_OUT_CODES = {torch.bfloat16: 0, torch.float32: 1}


def grouped_reference(
    x: torch.Tensor,
    levels: torch.Tensor,
    scales: torch.Tensor,
    group: int,
    out_dtype: torch.dtype | None,
) -> torch.Tensor:
    """Plain version of K1–K4: levels (out, in_p) f32, scales (out, S) f32.

    Each group's f32 partial product of bf16-rounded x with the exact
    levels is multiplied by its scale; the partials are summed in f32,
    group by group, and the result cast to ``out_dtype`` (default
    ``x.dtype``).
    """
    out_f, in_p = levels.shape
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    xb = x.reshape(-1, in_p).to(torch.bfloat16).to(torch.float32)
    acc = None
    for g in range(in_p // group):
        cols = slice(g * group, (g + 1) * group)
        part = torch.matmul(xb[:, cols], levels[:, cols].t())
        part = part * scales[:, g][None, :]
        acc = part if acc is None else acc + part
    return acc.to(out_dtype).reshape(*lead, out_f)


def pick_expert(stacked: torch.Tensor, expert: torch.Tensor) -> torch.Tensor:
    """Slab ``expert`` (a one-element integer tensor) of a stacked array,
    gathered on its device: the plain versions' way to an expert. (An
    index with the tensor itself would read it on the host.)"""
    return stacked.index_select(0, expert.reshape(1).to(torch.int64))[0]


def check_pairs(x: torch.Tensor, experts: torch.Tensor) -> None:
    """A pairs launch takes x (P, in_p) and one expert id per row."""
    if x.dim() != 2 or experts.shape != x.shape[:1]:
        raise ValueError(
            f"x must be (P, in_p) with one expert id per row, got x "
            f"{tuple(x.shape)} and experts {tuple(experts.shape)}"
        )
    # the pairs lie along a grid axis of the launch (K5b)
    if x.shape[0] > 65535:
        raise ValueError(f"at most 65535 pairs in a launch, got {x.shape[0]}")


def launch(
    lib_name: str,
    fn_name: str,
    x: torch.Tensor,
    tensors: Sequence[torch.Tensor],
    ints: Sequence[int],
    out_f: int,
    in_p: int,
    out_dtype: torch.dtype | None,
    ids: Optional[torch.Tensor] = None,
    x_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Launch ``fn_name`` of ``lib<lib_name>.so`` on CUDA tensors; raises
    on anything the kernel does not take, and on a failed launch.

    ``ids``: the int32 expert ids of a launch on stacked weights, passed
    to the kernel as a device pointer and never read on the host.
    ``x_dtype``: the type the kernel reads x in.
    """
    if x.device.type != "cuda":
        raise ValueError(f"{lib_name} runs on cuda or cpu, not {x.device}")
    if ids is not None:
        if ids.dtype != torch.int32 or not ids.is_contiguous():
            raise ValueError(f"{lib_name}: ids must be contiguous int32")
        tensors = (*tensors, ids)
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{lib_name}: all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{lib_name}: weights and scales must be contiguous")
    out_dtype = out_dtype or x.dtype
    kernel_dtype = torch.float32 if out_dtype == torch.float16 else out_dtype
    if kernel_dtype not in _OUT_CODES:
        raise ValueError(f"unsupported output dtype {out_dtype}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, in_p).to(x_dtype).contiguous()
    tokens = x2.shape[0]
    y = torch.empty(tokens, out_f, dtype=kernel_dtype, device=x.device)
    if tokens == 0:
        return y.to(out_dtype).reshape(*lead, out_f)
    # the kernels read x and every packed plane (all tensors but the
    # scales and the ids) with 16-byte loads
    planes = tensors[: -1 if ids is None else -2]
    if any(t.data_ptr() % 16 for t in (x2, *planes)):
        raise ValueError(f"{lib_name}: x and the weights must be 16-byte aligned")
    # int f(x, *tensors[, ids], y, T, out, in_p, *ints, out_dtype, stream)
    argtypes = (
        [ctypes.c_void_p] * (len(tensors) + 2)
        + [ctypes.c_int] * (4 + len(ints))
        + [ctypes.c_void_p],
        ctypes.c_int,
    )
    lib = _build.load(lib_name, {fn_name: argtypes})
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, fn_name)(
            x2.data_ptr(), *(t.data_ptr() for t in tensors), y.data_ptr(),
            tokens, out_f, in_p, *ints, _OUT_CODES[kernel_dtype], stream,
        )
    if err:
        raise RuntimeError(f"{lib_name} kernel launch failed: CUDA error {err}")
    return y.to(out_dtype).reshape(*lead, out_f)
