"""Runtime weight formats: the int8 and bf16 re-encodings of VPTQ layers.

Port of the int8/bf16 part of ``vptq_tpu/layers/runtime.py``. The
loader reconstructs each layer's exact weight once (a torch gather on
the load device) and re-encodes it:

  * ``int8``  per-(row, in-group) scaled int8, run by the K1 kernel
    (``ops/w8_matmul.py``). ``wq`` and ``scales`` are byte-equal to the
    JAX package's encoding.
  * ``bf16``  the exact weight rounded to bf16, run by ``torch.matmul``.
  * ``codebook`` keep the compressed :class:`VQLinear`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vptq_tpu_torch.layers.dense import DenseLinear
from vptq_tpu_torch.layers.vqlinear import VQLinear
from vptq_tpu_torch.ops.quant_matmul import layer_weight
from vptq_tpu_torch.ops.w8_matmul import w8_matmul

__all__ = [
    "Int8Linear",
    "RUNTIME_FORMATS",
    "dense_to_int8",
    "fuse_block",
    "fuse_linears",
    "fuse_model",
    "pick_group",
    "to_bf16",
    "to_int8",
    "to_runtime",
]

RUNTIME_FORMATS = ("int8", "bf16", "codebook")

# Scale-group width along in_features, chosen per layer: the largest
# whose zero-padding waste stays small.
GROUP_CANDIDATES = (2048, 1024, 512)


def pick_group(in_features: int, max_waste: float = 0.03) -> int:
    for g in GROUP_CANDIDATES:
        pad = (-in_features) % g
        if pad / (in_features + pad) <= max_waste:
            return g
    return GROUP_CANDIDATES[-1]


class Int8Linear(nn.Module):
    """Dense int8 weights + per-(in-group, out-row) f32 scales.

    ``wq`` is zero-padded along in_features to a multiple of the scale
    group; activations are zero-padded to match.
    """

    def __init__(
        self,
        wq: torch.Tensor,  # (out, in_padded) int8
        scales: torch.Tensor,  # (in_padded // group, out) f32
        bias: Optional[torch.Tensor] = None,
    ):
        super().__init__()
        self.register_buffer("wq", wq)
        self.register_buffer("scales", scales)
        self.register_buffer("bias", bias)

    @property
    def group(self) -> int:
        return self.wq.shape[1] // self.scales.shape[0]

    @property
    def out_features(self) -> int:
        return self.wq.shape[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_padded = self.wq.shape[1]
        if x.shape[-1] != in_padded:
            x = nn.functional.pad(x, (0, in_padded - x.shape[-1]))
        out = w8_matmul(x, self.wq, self.scales)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out


def _exact_weight(layer: VQLinear) -> torch.Tensor:
    """Exact f32 weight (out, in) on the layer's device.

    The loader cast the planes to the load dtype first, as the JAX
    package does, so this equals ``vptq_tpu``'s ``_exact_weight``.
    """
    return layer_weight(layer, torch.float32)


def _encode_int8(
    w: torch.Tensor, bias: Optional[torch.Tensor], group: Optional[int] = None
) -> Int8Linear:
    """f32 (out, in) weight → :class:`Int8Linear` on the same device.

    Symmetric per-(row, group) scale ``absmax / 127`` (1 for an all-zero
    group); ``q = round(w / scale)`` rounds half to even after an f32
    divide, as ``np.round`` does in the JAX package's encoder.
    """
    group = group or pick_group(w.shape[1])
    pad = (-w.shape[1]) % group
    if pad:
        w = nn.functional.pad(w, (0, pad))
    out_f, in_p = w.shape
    g = w.reshape(out_f, in_p // group, group)
    absmax = g.abs().amax(dim=-1)  # (out, n_groups)
    scale = torch.where(
        absmax > 0, absmax / 127.0, torch.ones_like(absmax)
    ).to(torch.float32)
    q = torch.clamp(torch.round(g / scale[:, :, None]), -127, 127).to(
        torch.int8
    )
    return Int8Linear(
        wq=q.reshape(out_f, in_p).contiguous(),
        scales=scale.t().contiguous(),
        bias=bias,
    )


def to_int8(layer: VQLinear, group: Optional[int] = None) -> Int8Linear:
    """Exact dequant → symmetric per-(row, group) int8 re-encode."""
    return _encode_int8(_exact_weight(layer), layer.bias, group)


def dense_to_int8(
    layer: DenseLinear, group: Optional[int] = None
) -> Int8Linear:
    """Re-encode an unquantized linear (e.g. lm_head) to int8."""
    return _encode_int8(layer.weight.to(torch.float32), layer.bias, group)


def to_bf16(layer: VQLinear) -> DenseLinear:
    return DenseLinear(
        weight=_exact_weight(layer).to(torch.bfloat16), bias=layer.bias
    )


def to_runtime(layer, fmt: str):
    """Convert any linear to the requested runtime format."""
    if fmt not in RUNTIME_FORMATS:
        raise ValueError(f"unknown runtime format {fmt!r}")
    if not isinstance(layer, VQLinear) or fmt == "codebook":
        return layer  # dense stays dense
    if fmt == "int8":
        return to_int8(layer)
    return to_bf16(layer)


def _fused_bias(linears):
    biases = [m.bias for m in linears]
    ref = next((b for b in biases if b is not None), None)
    if ref is None:
        return None
    return torch.cat([
        b if b is not None else ref.new_zeros(m.out_features)
        for b, m in zip(biases, linears)
    ])


def fuse_linears(linears):
    """Concatenate same-input linears into one (row-wise), or None.

    q|k|v and gate|up become single matmuls. All inputs must share
    in_features, type and (for int8) scale group.
    """
    first = linears[0]
    if any(type(m) is not type(first) for m in linears):
        return None
    if isinstance(first, Int8Linear):
        if any(
            m.wq.shape[1] != first.wq.shape[1] or m.group != first.group
            for m in linears
        ):
            return None
        return Int8Linear(
            wq=torch.cat([m.wq for m in linears], dim=0),
            scales=torch.cat([m.scales for m in linears], dim=1),
            bias=_fused_bias(linears),
        )
    if isinstance(first, DenseLinear):
        if any(m.weight.shape[1] != first.weight.shape[1] for m in linears):
            return None
        return DenseLinear(
            weight=torch.cat([m.weight for m in linears], dim=0),
            bias=_fused_bias(linears),
        )
    return None  # codebook layers are not fused


def fuse_block(block):
    """Fuse one block's q|k|v and gate|up projections (in place)."""
    attn, mlp = block.attn, block.mlp
    if attn.qkv_proj is None and attn.q_proj is not None:
        fused = fuse_linears([attn.q_proj, attn.k_proj, attn.v_proj])
        if fused is not None:
            attn.qkv_proj = fused
            attn.q_proj = attn.k_proj = attn.v_proj = None
    if mlp.gate_up_proj is None and mlp.gate_proj is not None:
        fused = fuse_linears([mlp.gate_proj, mlp.up_proj])
        if fused is not None:
            mlp.gate_up_proj = fused
            mlp.gate_proj = mlp.up_proj = None
    return block


def fuse_model(model):
    """Fuse q|k|v and gate|up projections across all blocks (in place)."""
    for block in model.blocks:
        fuse_block(block)
    return model
