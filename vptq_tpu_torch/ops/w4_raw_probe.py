"""P1d, P1e: GEMVs over K2's packed bytes used as they lie (wrong on
purpose): what the weight stream costs with no unpack at all.

Port of the measurement kernels ``examples/w4_wall_candidates.py:161``
(``_s8dot_kernel``) and ``:172`` (``_cvtonly_kernel``), entry
``run_variant``, modes ``"s8dot"`` and ``"cvtonly"``. The kernel is
hand-written CUDA for Hopper in ``vptq_tpu_torch/csrc/w4_raw_probe.cu``.
:func:`w4_raw_probe` launches it for CUDA tensors and runs the plain
version :func:`w4_raw_probe_reference` only for tensors that lie on the
CPU. No layer calls it; the examples and ``chip_smoke.py`` do.

Both take the (out, in/2) bytes against x of in/2 columns (the callers
pass columns ``[0, in/2)`` of the activations, as the script does outside
its kernel) and read only scale row 0:

* ``s8dot``: x int8; ``f32(Σ x · byte)`` (exact in int32) times
  ``scales[0, o]``;
* ``cvtonly``: x float, rounded to bf16; ``Σ x · f32(byte)`` in f32, times
  ``scales[0, o]``.
"""

from __future__ import annotations

import torch

from vptq_tpu_torch.ops.packing import INT4_GROUP
from vptq_tpu_torch.ops.scaled_matmul import launch

__all__ = ["RAW_PROBE_MODES", "w4_raw_probe", "w4_raw_probe_reference"]

# mode -> its code in csrc/w4_raw_probe.cu
RAW_PROBE_MODES = {"s8dot": 0, "cvtonly": 1}


def _check(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor,
           mode: str) -> int:
    """Validate mode, shapes and dtypes; returns in_features."""
    if mode not in RAW_PROBE_MODES:
        raise ValueError(f"mode {mode!r} is not one of {tuple(RAW_PROBE_MODES)}")
    if wq.dtype != torch.int8 or wq.dim() != 2:
        raise ValueError(f"wq must be 2-D int8, got {wq.dtype} {tuple(wq.shape)}")
    out_f, in_p = wq.shape[0], wq.shape[1] * 2
    if in_p % (2 * INT4_GROUP):
        raise ValueError(f"in_features {in_p} must be a multiple of 256")
    if scales.dtype != torch.bfloat16 or tuple(scales.shape) != (
        in_p // INT4_GROUP, out_f
    ):
        raise ValueError(
            f"scales must be bf16 {(in_p // INT4_GROUP, out_f)}, got "
            f"{scales.dtype} {tuple(scales.shape)}"
        )
    x_ok = x.dtype == torch.int8 if mode == "s8dot" else x.is_floating_point()
    if not x_ok or x.shape[-1] != in_p // 2:
        kind = "int8" if mode == "s8dot" else "floating point"
        raise ValueError(f"x must be {kind} (..., {in_p // 2})")
    return in_p


def _out_dtype(x: torch.Tensor, out_dtype: torch.dtype | None) -> torch.dtype:
    return out_dtype or (x.dtype if x.is_floating_point() else torch.bfloat16)


def w4_raw_probe_reference(
    x: torch.Tensor,
    wq: torch.Tensor,
    scales: torch.Tensor,
    mode: str,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain torch version. ``s8dot`` sums in f64, which holds every
    integer sum of these products exactly (and runs on the card, where
    torch has no int32 matmul)."""
    _check(x, wq, scales, mode)
    xh = x.reshape(-1, x.shape[-1])
    if mode == "s8dot":
        dot = torch.matmul(
            xh.to(torch.float64), wq.to(torch.float64).t()
        ).to(torch.float32)
    else:
        dot = torch.matmul(xh.to(torch.bfloat16).to(torch.float32),
                           wq.to(torch.float32).t())
    y = dot * scales[0].to(torch.float32)[None, :]
    return y.to(_out_dtype(x, out_dtype)).reshape(*x.shape[:-1], wq.shape[0])


def w4_raw_probe(
    x: torch.Tensor,
    wq: torch.Tensor,
    scales: torch.Tensor,
    mode: str,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """The ``mode`` probe through its kernel.

    x (..., in_p / 2): int8 for ``s8dot``, float for ``cvtonly``; wq (out,
    in_p / 2) int8; scales (in_p / 128, out) bf16. Returns (..., out) in
    ``out_dtype`` (default x's dtype, bf16 for int8 x).
    """
    in_p = _check(x, wq, scales, mode)
    if x.device.type == "cpu":
        return w4_raw_probe_reference(x, wq, scales, mode, out_dtype)
    y = launch(
        "w4_raw_probe", "vptq_w4_raw_probe", x, (wq, scales),
        (RAW_PROBE_MODES[mode],), wq.shape[0], in_p // 2,
        _out_dtype(x, out_dtype),
        x_dtype=torch.int8 if mode == "s8dot" else torch.bfloat16,
    )
    w4_raw_probe.launches += 1
    return y


w4_raw_probe.launches = 0
# the TPU kernels this one replaces, and which mode ports which
w4_raw_probe.bodies = {
    "s8dot": "examples/w4_wall_candidates.py:161",
    "cvtonly": "examples/w4_wall_candidates.py:172",
}
w4_raw_probe.replaces = ", ".join(w4_raw_probe.bodies.values())
# the word of the demangled names of its CUDA kernels that picks them out
# of a trace
w4_raw_probe.trace_tags = ("raw_gemv",)
