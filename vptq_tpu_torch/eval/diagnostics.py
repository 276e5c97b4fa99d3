"""Reconstruction diagnostics for quantized layers.

Port of ``vptq_tpu/eval/diagnostics.py``: the proxy reconstruction
error of the reference's ``VQuantLinear.get_error`` (reference
vqlinear.py:486-518), the mean Hessian-weighted error of the
reconstructed weight against the original, and
``model_reconstruction_report``, the fidelity of the runtime re-encode:
for every linear the runtime weight (int8 / int4 / int3 group dequant,
bf16, or VQ exact) against the exact VPTQ reconstruction of the same
layer in a codebook-format model, as relative RMS and worst-case error.
Every weight is materialized in f32 on its layer's device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from vptq_tpu_torch.layers.dense import DenseLinear
from vptq_tpu_torch.layers.runtime import (
    Int3Linear,
    Int4Linear,
    Int8Linear,
    _exact_weight,
    int3_weight,
    int4_weight,
    int8_weight,
)
from vptq_tpu_torch.layers.vqlinear import VQLinear

__all__ = [
    "reconstruction_error",
    "runtime_weight",
    "model_reconstruction_report",
    "summarize_report",
]


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                           dtype=torch.float32, device=device)


def reconstruction_error(
    layer: VQLinear,
    w_original,  # (out, in), numpy or tensor
    hessian=None,  # (in, in)
) -> Dict[str, float]:
    """(error_mean, w_mean, norm_error): the reference's get_error math.

    With ``hessian=None`` an identity proxy is used (plain MSE ratio).
    """
    w_hat = _exact_weight(layer)
    w = _f32(w_original, w_hat.device)
    delta = w_hat - w
    gram, err = w.t() @ w, delta.t() @ delta
    if hessian is not None:
        h = _f32(hessian, w_hat.device)
        gram, err = gram * h, err * h
    w_mean = float(torch.mean(gram))
    error_mean = float(torch.mean(err))
    return {
        "error_mean": error_mean,
        "w_mean": w_mean,
        "norm_error": error_mean / w_mean if w_mean else float("inf"),
    }


# the layer types the report reads, as in vptq_tpu, and their format
_FORMATS = {
    VQLinear: ("codebook", _exact_weight),
    Int8Linear: ("int8", int8_weight),
    Int4Linear: ("int4", int4_weight),
    Int3Linear: ("int3", int3_weight),
    DenseLinear: ("bf16", lambda lin: lin.weight.to(torch.float32)),
}


def runtime_weight(lin) -> Optional[torch.Tensor]:
    """A linear's effective weight matrix as f32 on its device.

    Covers Int8Linear / Int4Linear / Int3Linear group-dequant (the
    in_features zero-padding kept: callers trim against the reference
    width), DenseLinear pass-through and VQLinear exact reconstruction.
    """
    if lin is None:
        return None
    entry = _FORMATS.get(type(lin))
    if entry is None:
        raise TypeError(f"unknown linear type {type(lin).__name__}")
    return entry[1](lin)


def _fmt_name(lin) -> str:
    entry = _FORMATS.get(type(lin))
    return type(lin).__name__ if entry is None else entry[0]


def _compare(name, runtime_lin, ref_weights, report):
    """Relative RMS / max-abs between a runtime linear and the exact
    reconstruction (``ref_weights``: list of (out, in) f32 blocks,
    row-concatenated for fused projections)."""
    if runtime_lin is None:
        return
    w_ref = (
        ref_weights[0]
        if len(ref_weights) == 1
        else torch.cat(ref_weights, dim=0)
    )
    w_rt = runtime_weight(runtime_lin)
    w_ref = w_ref.to(w_rt.device)
    # runtime formats zero-pad in_features; trim to the reference width
    w_rt = w_rt[:, : w_ref.shape[1]]
    if w_rt.shape != w_ref.shape:
        report[name] = {
            "format": _fmt_name(runtime_lin),
            "error": float("nan"),
            "note": f"shape {tuple(w_rt.shape)} vs {tuple(w_ref.shape)}",
        }
        return
    delta = w_rt - w_ref
    ref_rms = float(torch.sqrt(torch.mean(w_ref**2)))
    report[name] = {
        "format": _fmt_name(runtime_lin),
        "rel_rms": float(torch.sqrt(torch.mean(delta**2)))
        / (ref_rms + 1e-30),
        "max_abs_err": float(torch.max(torch.abs(delta))),
        "ref_rms": ref_rms,
    }


def _ref_w(lin):
    w = runtime_weight(lin)
    if w is None:
        raise ValueError(
            "reference model has a missing linear where the runtime "
            "model has one; load both models from the same checkpoint"
        )
    return w


@torch.inference_mode()
def model_reconstruction_report(
    model, reference
) -> Dict[str, Dict[str, float]]:
    """Per-layer runtime re-encoding fidelity vs exact reconstruction.

    ``model`` is the serving model (any runtime format, fused or not);
    ``reference`` is the same checkpoint loaded with
    ``runtime_format="codebook"`` (exact) and ``fuse=False``. For every
    linear the runtime weight is materialized on the model's device and
    compared against the exact VPTQ reconstruction; fused q|k|v and
    gate|up projections are compared against the row-concatenation of
    their reference parts. Covers int8 / int4 / int3 / bf16 / codebook,
    MLA and MoE layers (the per-expert copies where the model keeps
    them).
    """
    from vptq_tpu_torch.models.llama import (
        DeepseekMoe,
        MlaAttention,
        MoeMlp,
    )

    report: Dict[str, Dict[str, float]] = {}

    def attn_pairs(p, a, ra):
        if isinstance(a, MlaAttention):
            # kv_b_proj is absorbed into uk / uv at load: no linear
            for name in ("kv_a_proj", "kv_b_proj", "o_proj", "q_proj",
                         "q_a_proj", "q_b_proj"):
                lin = getattr(a, name, None)
                if lin is not None:
                    _compare(
                        f"{p}.{name}", lin,
                        [_ref_w(getattr(ra, name))], report,
                    )
            return
        if a.qkv_proj is not None:
            if getattr(ra, "qkv_proj", None) is not None:
                refs = [_ref_w(ra.qkv_proj)]
            else:
                refs = [
                    _ref_w(ra.q_proj),
                    _ref_w(ra.k_proj),
                    _ref_w(ra.v_proj),
                ]
            _compare(f"{p}.qkv_proj", a.qkv_proj, refs, report)
        else:
            for name in ("q_proj", "k_proj", "v_proj"):
                _compare(
                    f"{p}.{name}", getattr(a, name),
                    [_ref_w(getattr(ra, name))], report,
                )
        _compare(f"{p}.o_proj", a.o_proj, [_ref_w(ra.o_proj)], report)

    def mlp_pairs(p, m, rm):
        if m.gate_up_proj is not None:
            if getattr(rm, "gate_up_proj", None) is not None:
                refs = [_ref_w(rm.gate_up_proj)]
            else:
                refs = [_ref_w(rm.gate_proj), _ref_w(rm.up_proj)]
            _compare(f"{p}.gate_up_proj", m.gate_up_proj, refs, report)
        else:
            for name in ("gate_proj", "up_proj"):
                lin = getattr(m, name)
                if lin is not None:
                    _compare(
                        f"{p}.{name}", lin,
                        [_ref_w(getattr(rm, name))], report,
                    )
        _compare(
            f"{p}.down_proj", m.down_proj, [_ref_w(rm.down_proj)],
            report,
        )

    for i, (block, rblock) in enumerate(
        zip(model.blocks, reference.blocks)
    ):
        p = f"layers.{i}"
        attn_pairs(f"{p}.attn", block.attn, rblock.attn)
        m, rm = block.mlp, rblock.mlp
        if isinstance(m, (MoeMlp, DeepseekMoe)):
            for e, (ex, rex) in enumerate(zip(m.experts, rm.experts)):
                mlp_pairs(f"{p}.mlp.experts.{e}", ex, rex)
            if isinstance(m, DeepseekMoe):
                mlp_pairs(
                    f"{p}.mlp.shared_experts",
                    m.shared_experts, rm.shared_experts,
                )
        else:
            mlp_pairs(f"{p}.mlp", m, rm)
    if model.lm_head is not None and reference.lm_head is not None:
        _compare(
            "lm_head", model.lm_head, [_ref_w(reference.lm_head)],
            report,
        )
    return report


def summarize_report(
    report: Dict[str, Dict[str, float]],
) -> Dict[str, float]:
    """Aggregate per-layer fidelity: worst / mean relative RMS."""
    vals = [
        r["rel_rms"] for r in report.values() if "rel_rms" in r
    ]
    if not vals:
        return {"n_layers": 0}
    return {
        "n_layers": len(vals),
        "mean_rel_rms": float(np.mean(vals)),
        "worst_rel_rms": float(np.max(vals)),
    }
