"""P1a, P1b, P2: K2's int4 GEMV with the nibbles unpacked in other ways.

Port of the measurement kernels ``examples/w4_wall_candidates.py:53``
(``_prod_kernel``), ``:91`` (``_fma16_kernel``) and
``examples/w4_unpack_ablation.py:39`` (``_kernel``). The kernel is
hand-written CUDA for Hopper in ``vptq_tpu_torch/csrc/w4_probe_matmul.cu``
on the asynchronous ring of ``csrc/ring_gemv.cuh``: the bytes stream
through a ``cp.async`` ring, each mode's policy unpacks them in its own
arithmetic into bf16 pairs, and the products run on tensor cores
(``mma.sync``). :func:`w4_probe_matmul` launches it for CUDA tensors, with
the token tile and cluster size that :func:`probe_plan` plans, and runs
the plain version :func:`w4_probe_matmul_reference` only for tensors that
lie on the CPU. No layer calls it; the examples and ``chip_smoke.py`` do.

Modes (x rounded to bf16 in all of them; scales (in/128, out) bf16):

* ``prod``: K2's function, the TPU kernel's unpack (sign-extended low
  nibble, ``w >> 4`` high nibble);
* ``shift28``: low level ``w << 28`` and 2⁻²⁸ folded into the low half's
  scales (the wall-candidates script's ``prod``);
* ``fma16``: each byte is ``16·hi + lo``; ``hi = round(b / 16)`` (half to
  even), ``lo = b − 16·hi``;
* ``fma16f32`` / ``t8``: ``fma16`` / ``prod`` with x read in f32;
* ``g256``: ``prod`` with one scale row per 256 columns, rows
  ``2·(k // 256)`` for the low nibble of byte k and
  ``in/256 + 2·(k // 256)`` for its high nibble.
"""

from __future__ import annotations

import torch

from vptq_tpu_torch.ops.packing import INT4_GROUP, unpack_int4
from vptq_tpu_torch.ops.scaled_matmul import (
    DECODE_STAGE, grouped_reference, launch, ring_plan, ring_split, sm_count,
)

__all__ = ["F32_X_MODES", "W4_PROBE_MODES", "probe_plan", "probe_rows",
           "probe_smem", "w4_probe_matmul", "w4_probe_matmul_reference"]

# mode -> its code in csrc/w4_probe_matmul.cu (unpack::Mode)
W4_PROBE_MODES = {
    "prod": 0, "shift28": 1, "fma16": 2, "fma16f32": 3, "t8": 4, "g256": 5,
}
# the modes whose kernel reads x in f32
F32_X_MODES = ("fma16f32", "t8")
# the kernel's block (csrc/w4_probe_matmul.cu): 32 rows in the 8-token
# tile, 64 in the 16-token one, a ring of four stages of 128 bytes
# (positions) a row; x staged as 8-byte units of four positions, each
# stage's 32 of a part at 34 places, a token's row rounded up to 2 mod 16
# units; a cluster splits a row's scale groups (g256: two stages each)
_X_PLACES = DECODE_STAGE // 4 + 2


def probe_rows(tokens: int) -> int:
    """Rows of one block of the kernel whose token tile ``tokens`` fill
    (8 or fewer: the 8-token tile)."""
    return 32 if tokens <= 8 else 64


def _x_pitch(stages: int) -> int:
    """8-byte units of one token's row of x over ``stages`` stages of both
    parts (csrc/w4_probe_matmul.cu ``x_pitch``)."""
    used = 2 * _X_PLACES * stages
    return used + (2 - used) % 16


def probe_smem(tokens: int, groups: int, group_stages: int = 1,
               tile: int = 0) -> int:
    """Shared memory of one block of the kernel whose range is ``groups``
    scale groups of ``group_stages`` stages (bytes): its ring, x for
    ``tokens`` rows, the scales of its rows (a bf16 a group and part) and
    the partials the cluster's ranks push (one f32 a row and token). The
    block's rows are its token tile's (``tile``; by default the tile
    ``tokens`` fill)."""
    rows = probe_rows(tile or tokens)
    return (256 + 4 * rows * DECODE_STAGE
            + tokens * _x_pitch(groups * group_stages) * 8
            + groups * 2 * rows * 2 + rows * tokens * 4)


def probe_plan(out_f: int, in_p: int, tokens: int, n_sm: int,
               mode: str = "prod") -> tuple:
    """(token tile, cluster size) a launch of ``mode`` passes the kernel
    over a part's scale groups (128 positions, g256 256); the size is 0
    where no split fits x into a block.

    A 64-row block (the 16-token tile's) stages x once for twice the rows
    of a 32-row one (through 32-row blocks x's bytes are T/8 of the
    weight's, f32 x's T/4). So the plan takes the 16-token tile first, at
    the smallest split whose blocks are two or more an SM and fit two to
    an SM (``ring_split``): at every token count past one, and at one
    token where that split is 1 or 2 (gate_up, qkv). A longer cluster of
    64-row blocks costs more in its reduction and shorter blocks than the
    x it saves (one token at down on an H100: 0.032 ms at split 8 against
    0.030 on 32-row blocks; ``examples/probe_timeline.py --plans``).
    Elsewhere ``ring_plan``'s."""
    stages = 2 if mode == "g256" else 1
    groups = in_p // 2 // (stages * DECODE_STAGE)
    split, ok = ring_split(
        -(-out_f // probe_rows(16)), groups, tokens, 16, n_sm,
        lambda t, g: probe_smem(t, g, stages, 16))
    if ok and (tokens > 1 or split <= 2):
        return 16, split
    return ring_plan(out_f, groups, tokens, n_sm,
                     lambda t, g: probe_smem(t, g, stages), probe_rows)


def _check(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor,
           mode: str) -> int:
    """Validate mode, shapes and dtypes; returns in_features."""
    if mode not in W4_PROBE_MODES:
        raise ValueError(f"mode {mode!r} is not one of {tuple(W4_PROBE_MODES)}")
    if wq.dtype != torch.int8 or wq.dim() != 2:
        raise ValueError(f"wq must be 2-D int8, got {wq.dtype} {tuple(wq.shape)}")
    out_f, in_p = wq.shape[0], wq.shape[1] * 2
    step = 4 * INT4_GROUP if mode == "g256" else 2 * INT4_GROUP
    if in_p % step:
        raise ValueError(f"in_features {in_p} must be a multiple of {step}")
    if scales.dtype != torch.bfloat16 or tuple(scales.shape) != (
        in_p // INT4_GROUP, out_f
    ):
        raise ValueError(
            f"scales must be bf16 {(in_p // INT4_GROUP, out_f)}, got "
            f"{scales.dtype} {tuple(scales.shape)}"
        )
    if not x.is_floating_point() or x.shape[-1] != in_p:
        raise ValueError(f"x must be floating point (..., {in_p})")
    return in_p


def w4_probe_matmul_reference(
    x: torch.Tensor,
    wq: torch.Tensor,
    scales: torch.Tensor,
    mode: str,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain torch version: the mode's exact levels, each group's f32
    partial times its scale (times 2⁻²⁸ on the low half in ``shift28``)."""
    in_p = _check(x, wq, scales, mode)
    half = in_p // 2
    s = scales.to(torch.float32).t()  # (out, in_p / 128)
    if mode in ("fma16", "fma16f32"):
        b = wq.to(torch.float32)
        hi = torch.round(b * 0.0625)
        levels = torch.cat([b - 16.0 * hi, hi], dim=1)
    else:
        levels = unpack_int4(wq).to(torch.float32)
    if mode == "shift28":
        levels[:, :half] *= 2.0 ** 28
        s = s.clone()
        s[:, : s.shape[1] // 2] *= 2.0 ** -28
    group = INT4_GROUP
    if mode == "g256":
        group = 2 * INT4_GROUP
        n = half // group
        rows = torch.arange(n, device=s.device) * 2
        s = s[:, torch.cat([rows, in_p // group + rows])]
    return grouped_reference(x, levels, s, group, out_dtype)


def w4_probe_matmul(
    x: torch.Tensor,
    wq: torch.Tensor,
    scales: torch.Tensor,
    mode: str,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``x @ (s ⊙ L)ᵀ`` with levels L unpacked as ``mode`` says, through
    the probe kernel.

    x (..., in_p) float; wq (out, in_p / 2) int8; scales (in_p / 128, out)
    bf16. Returns (..., out) in ``out_dtype`` (default ``x.dtype``).
    """
    in_p = _check(x, wq, scales, mode)
    if x.device.type == "cpu":
        return w4_probe_matmul_reference(x, wq, scales, mode, out_dtype)
    tokens = x.numel() // in_p
    tile, split = probe_plan(wq.shape[0], in_p, max(tokens, 1),
                             sm_count(x.device), mode)
    if not split:
        raise ValueError(
            f"w4_probe_matmul: in_features {in_p} is too wide for the "
            "kernel's shared memory")
    y = launch(
        "w4_probe_matmul", "vptq_w4_probe_matmul", x, (wq, scales),
        (W4_PROBE_MODES[mode], split, tile), wq.shape[0], in_p, out_dtype,
        x_dtype=torch.float32 if mode in F32_X_MODES else torch.bfloat16,
    )
    w4_probe_matmul.launches += 1
    return y


w4_probe_matmul.launches = 0
# the TPU kernels this one replaces, and which mode ports which
w4_probe_matmul.bodies = {
    "prod": "examples/w4_unpack_ablation.py:39",
    "shift28": "examples/w4_wall_candidates.py:53",
    "fma16": "examples/w4_wall_candidates.py:91",
    "fma16f32": "examples/w4_wall_candidates.py:91",
    "t8": "examples/w4_unpack_ablation.py:39",
    "g256": "examples/w4_unpack_ablation.py:39",
}
w4_probe_matmul.replaces = ", ".join(dict.fromkeys(
    w4_probe_matmul.bodies.values()))
# words of the demangled names of its CUDA kernels (unpack::ring_gemv, one
# instance a policy) that pick them out of a trace
w4_probe_matmul.trace_tags = ("unpack", "ring_gemv")
