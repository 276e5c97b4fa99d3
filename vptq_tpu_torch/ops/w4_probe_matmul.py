"""P1a, P1b, P2: K2's int4 GEMV with the nibbles unpacked in other ways.

Port of the measurement kernels ``examples/w4_wall_candidates.py:53``
(``_prod_kernel``), ``:91`` (``_fma16_kernel``) and
``examples/w4_unpack_ablation.py:39`` (``_kernel``). The kernel is
hand-written CUDA for Hopper in ``vptq_tpu_torch/csrc/w4_probe_matmul.cu``:
one format policy of the low-bit skeleton per mode, beside K2's own.
:func:`w4_probe_matmul` launches it for CUDA tensors and runs the plain
version :func:`w4_probe_matmul_reference` only for tensors that lie on the
CPU. No layer calls it; the examples and ``chip_smoke.py`` do.

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
from vptq_tpu_torch.ops.scaled_matmul import grouped_reference, launch

__all__ = ["F32_X_MODES", "W4_PROBE_MODES", "w4_probe_matmul",
           "w4_probe_matmul_reference"]

# mode -> its code in csrc/w4_probe_matmul.cu (unpack::Mode)
W4_PROBE_MODES = {
    "prod": 0, "shift28": 1, "fma16": 2, "fma16f32": 3, "t8": 4, "g256": 5,
}
# the modes whose kernel reads x in f32
F32_X_MODES = ("fma16f32", "t8")


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
    y = launch(
        "w4_probe_matmul", "vptq_w4_probe_matmul", x, (wq, scales),
        (W4_PROBE_MODES[mode],), wq.shape[0], in_p, out_dtype,
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
# words of the demangled names of its CUDA kernels (lowbit.cuh's, with the
# policies of namespace unpack) that pick them out of a trace
w4_probe_matmul.trace_tags = ("lowbit", "unpack")
