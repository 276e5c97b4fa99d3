"""Runtime weight formats: the dense re-encodings of VPTQ layers.

Port of ``vptq_tpu/layers/runtime.py`` without the calibrated mixed
layers. The loader reconstructs each layer's exact weight once (a torch
gather on the load device) and re-encodes it:

  * ``int8``  per-(row, in-group) scaled int8, run by K1
    (``ops/w8_matmul.py``).
  * ``int4``  split-half packed int4, per-(row, 128-column) bf16 scales
    from an MSE grid search, run by K2 (``ops/w4_matmul.py``).
  * ``int3``  2-bit plane + sign plane, per-(row, 128-column) bf16
    scales, run by K4 (``ops/w3_matmul.py``).
  * ``int2``  quarter-split 2-bit codes on the half-offset grid
    ``(c + 0.5)·s``, per-(row, 64-column) bf16 scales, run by K3
    (``ops/w2_matmul.py``).
  * ``bf16``  the exact weight rounded to bf16, run by ``torch.matmul``.
  * ``codebook`` keep the compressed :class:`VQLinear`.

Every encoding is byte-equal to the JAX package's numpy encoder.
:func:`fuse_block` also stacks the int8 or int4 experts of a Mixtral MoE
block (:func:`stack_experts`) for the expert and pairs kernels K6 and K5.
Blocked (``shards > 1``) encodings for tensor parallelism are not
ported: on one device they would compute wrong outputs, so they raise.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vptq_tpu_torch.layers.dense import DenseLinear
from vptq_tpu_torch.layers.vqlinear import VQLinear
from vptq_tpu_torch.models.llama import Mlp, MoeMlp, StackedExperts
from vptq_tpu_torch.ops.packing import (
    INT4_GROUP,
    W2_BLOCK,
    W2_GROUP,
    pack_int2,
    pack_int3,
    pack_int4,
    quantize_int2,
    quantize_int3,
    quantize_int4,
    unpack_int2,
    unpack_int3,
    unpack_int4,
)
from vptq_tpu_torch.ops.quant_matmul import layer_weight
from vptq_tpu_torch.ops.w2_matmul import w2_matmul
from vptq_tpu_torch.ops.w3_matmul import w3_matmul
from vptq_tpu_torch.ops.w4_matmul import w4_matmul
from vptq_tpu_torch.ops.w8_matmul import w8_matmul

__all__ = [
    "Int2Linear",
    "Int3Linear",
    "Int4Linear",
    "Int8Linear",
    "RUNTIME_FORMATS",
    "dense_to_int4",
    "dense_to_int8",
    "fuse_block",
    "fuse_linears",
    "fuse_model",
    "int2_weight",
    "int3_weight",
    "int4_weight",
    "int8_weight",
    "linear_exact_weight",
    "pick_group",
    "stack_experts",
    "to_bf16",
    "to_int2",
    "to_int3",
    "to_int4",
    "to_int8",
    "to_runtime",
]

RUNTIME_FORMATS = ("int8", "int4", "int3", "int2", "bf16", "codebook")

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
        return _add_bias(
            w8_matmul(_pad_to(x, self.wq.shape[1]), self.wq, self.scales),
            self.bias,
        )


def _pad_to(x: torch.Tensor, in_padded: int) -> torch.Tensor:
    """Zero-pad activations to the encoder's padded in_features (zeros
    contribute nothing to the products)."""
    if x.shape[-1] != in_padded:
        x = nn.functional.pad(x, (0, in_padded - x.shape[-1]))
    return x


def _add_bias(out: torch.Tensor, bias: Optional[torch.Tensor]):
    return out if bias is None else out + bias.to(out.dtype)


class Int4Linear(nn.Module):
    """Packed int4 weights + per-(128-column group, row) bf16 scales.

    Nibble layout: :func:`~vptq_tpu_torch.ops.packing.pack_int4`;
    ``scales`` is (in_padded // 128, out), transposed like int8's.
    """

    def __init__(
        self,
        wq: torch.Tensor,  # (out, in_padded // 2) int8
        scales: torch.Tensor,  # (in_padded // 128, out) bf16
        bias: Optional[torch.Tensor] = None,
    ):
        super().__init__()
        self.register_buffer("wq", wq)
        self.register_buffer("scales", scales)
        self.register_buffer("bias", bias)

    @property
    def in_padded(self) -> int:
        return self.wq.shape[1] * 2

    @property
    def out_features(self) -> int:
        return self.wq.shape[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _add_bias(
            w4_matmul(_pad_to(x, self.in_padded), self.wq, self.scales),
            self.bias,
        )


class Int3Linear(nn.Module):
    """Plane-packed int3 weights + per-(row, 128-column) bf16 scales.

    Plane layout: :func:`~vptq_tpu_torch.ops.packing.pack_int3`;
    ``scales`` is out-major, (out, in_padded // 128), unlike int4's.
    """

    def __init__(
        self,
        wq2: torch.Tensor,  # (out, in_padded // 4) int8, low two bits
        wq1: torch.Tensor,  # (out, in_padded // 8) int8, sign bits
        scales: torch.Tensor,  # (out, in_padded // 128) bf16
        bias: Optional[torch.Tensor] = None,
    ):
        super().__init__()
        self.register_buffer("wq2", wq2)
        self.register_buffer("wq1", wq1)
        self.register_buffer("scales", scales)
        self.register_buffer("bias", bias)

    @property
    def in_padded(self) -> int:
        return self.wq2.shape[1] * 4

    @property
    def out_features(self) -> int:
        return self.wq2.shape[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _add_bias(
            w3_matmul(
                _pad_to(x, self.in_padded), self.wq2, self.wq1, self.scales
            ),
            self.bias,
        )


class Int2Linear(nn.Module):
    """Plane-packed int2 codes + per-(row, group) bf16 scales.

    The level is ``(c + 0.5)·s`` with c ∈ [−2, 1]. Plane layout:
    :func:`~vptq_tpu_torch.ops.packing.pack_int2`; ``scales`` is
    out-major, (out, in_padded // group), group 64 or 128.
    """

    def __init__(
        self,
        wq: torch.Tensor,  # (out, in_padded // 4) int8
        scales: torch.Tensor,  # (out, in_padded // group) bf16
        bias: Optional[torch.Tensor] = None,
    ):
        super().__init__()
        self.register_buffer("wq", wq)
        self.register_buffer("scales", scales)
        self.register_buffer("bias", bias)

    @property
    def in_padded(self) -> int:
        return self.wq.shape[1] * 4

    @property
    def group(self) -> int:
        return self.in_padded // self.scales.shape[1]

    @property
    def out_features(self) -> int:
        return self.wq.shape[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _add_bias(
            w2_matmul(_pad_to(x, self.in_padded), self.wq, self.scales),
            self.bias,
        )


def _exact_weight(layer: VQLinear) -> torch.Tensor:
    """Exact f32 weight (out, in) on the layer's device.

    The loader cast the planes to the load dtype first, as the JAX
    package does, so this equals ``vptq_tpu``'s ``_exact_weight``.
    """
    return layer_weight(layer, torch.float32)


def _pad_columns(w: torch.Tensor, pad_to: int) -> torch.Tensor:
    pad = (-w.shape[1]) % pad_to
    return nn.functional.pad(w, (0, pad)) if pad else w


def _encode_int8(
    w: torch.Tensor, bias: Optional[torch.Tensor], group: Optional[int] = None
) -> Int8Linear:
    """f32 (out, in) weight → :class:`Int8Linear` on the same device.

    Symmetric per-(row, group) scale ``absmax / 127`` (1 for an all-zero
    group); ``q = round(w / scale)`` rounds half to even after an f32
    divide, as ``np.round`` does in the JAX package's encoder.
    """
    group = group or pick_group(w.shape[1])
    w = _pad_columns(w, group)
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


def _no_blocks(shards: int) -> None:
    if shards > 1:
        raise NotImplementedError(
            "blocked (shards > 1) encodings only mean something after "
            "tensor-parallel placement, which is not ported"
        )


def _encode_int4(
    w: torch.Tensor, bias: Optional[torch.Tensor], shards: int = 1
) -> Int4Linear:
    """f32 (out, in) weight → :class:`Int4Linear` on the same device,
    in_features zero-padded to a multiple of 2048."""
    _no_blocks(shards)
    q, scale = quantize_int4(_pad_columns(w, 2048))
    return Int4Linear(
        wq=pack_int4(q),
        scales=scale.t().contiguous().to(torch.bfloat16),
        bias=bias,
    )


def _encode_int3(
    w: torch.Tensor, bias: Optional[torch.Tensor], shards: int = 1
) -> Int3Linear:
    """f32 (out, in) weight → :class:`Int3Linear` on the same device,
    in_features zero-padded to a multiple of 2048."""
    _no_blocks(shards)
    q, scale = quantize_int3(_pad_columns(w, 2048))
    wq2, wq1 = pack_int3(q)
    return Int3Linear(
        wq2=wq2, wq1=wq1, scales=scale.to(torch.bfloat16), bias=bias
    )


def _encode_int2(
    w: torch.Tensor, bias: Optional[torch.Tensor], shards: int = 1,
    group: int = W2_GROUP,
) -> Int2Linear:
    """f32 (out, in) weight → :class:`Int2Linear` on the same device,
    in_features zero-padded to a multiple of 1024."""
    _no_blocks(shards)
    q, scale = quantize_int2(_pad_columns(w, W2_BLOCK), group=group)
    return Int2Linear(
        wq=pack_int2(q), scales=scale.to(torch.bfloat16), bias=bias
    )


def to_int4(layer: VQLinear) -> Int4Linear:
    """Exact dequant → per-(row, 128-column) int4 re-encode."""
    return _encode_int4(_exact_weight(layer), layer.bias)


def to_int3(layer: VQLinear) -> Int3Linear:
    """Exact dequant → per-(row, 128-column) int3 plane re-encode."""
    return _encode_int3(_exact_weight(layer), layer.bias)


def to_int2(layer: VQLinear) -> Int2Linear:
    """Exact dequant → per-(row, 64-column) half-offset int2 re-encode."""
    return _encode_int2(_exact_weight(layer), layer.bias)


def dense_to_int4(layer: DenseLinear) -> Int4Linear:
    """Re-encode an unquantized linear to int4."""
    return _encode_int4(layer.weight.to(torch.float32), layer.bias)


def _scaled(levels: torch.Tensor, scales: torch.Tensor, group: int):
    """levels (out, in_p) f32 times out-major scales (out, in_p / group)."""
    out_f, in_p = levels.shape
    return (
        levels.reshape(out_f, -1, group) * scales.to(torch.float32)[:, :, None]
    ).reshape(out_f, in_p)


def int8_weight(layer: Int8Linear) -> torch.Tensor:
    """Exact f32 dequant of the int8 layout."""
    return _scaled(
        layer.wq.to(torch.float32), layer.scales.t(), layer.group
    )


def int4_weight(layer: Int4Linear) -> torch.Tensor:
    """Exact f32 dequant of the packed int4 layout."""
    return _scaled(
        unpack_int4(layer.wq).to(torch.float32), layer.scales.t(), INT4_GROUP
    )


def int3_weight(layer: Int3Linear) -> torch.Tensor:
    """Exact f32 dequant of the plane-packed int3 layout."""
    return _scaled(
        unpack_int3(layer.wq2, layer.wq1).to(torch.float32), layer.scales,
        INT4_GROUP,
    )


def int2_weight(layer: Int2Linear) -> torch.Tensor:
    """Exact f32 dequant of the plane-packed int2 layout."""
    return _scaled(
        unpack_int2(layer.wq).to(torch.float32) + 0.5, layer.scales,
        layer.group,
    )


_EXACT_WEIGHT = {
    VQLinear: _exact_weight,
    Int8Linear: int8_weight,
    Int4Linear: int4_weight,
    Int3Linear: int3_weight,
    Int2Linear: int2_weight,
    DenseLinear: lambda layer: layer.weight.to(torch.float32),
}


def linear_exact_weight(
    layer, logical_in: Optional[int] = None
) -> torch.Tensor:
    """Exact f32 dequant of any linear, cut to the logical in_features
    (drops the encoder's zero-padding)."""
    w = _EXACT_WEIGHT[type(layer)](layer)
    return w if logical_in is None else w[:, :logical_in]


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
    return _TO_FORMAT[fmt](layer)


_TO_FORMAT = {
    "int8": to_int8, "int4": to_int4, "int3": to_int3, "int2": to_int2,
    "bf16": to_bf16,
}


def _fused_bias(linears):
    biases = [m.bias for m in linears]
    ref = next((b for b in biases if b is not None), None)
    if ref is None:
        return None
    return torch.cat([
        b if b is not None else ref.new_zeros(m.out_features)
        for b, m in zip(biases, linears)
    ])


# the arrays of each fusable layer type, and the dim of each that runs
# along out_features: the int8 / int4 scales are stored transposed
_OUT_DIM = {
    Int8Linear: {"wq": 0, "scales": 1},
    Int4Linear: {"wq": 0, "scales": 1},
    Int3Linear: {"wq2": 0, "wq1": 0, "scales": 0},
    Int2Linear: {"wq": 0, "scales": 0},
    DenseLinear: {"weight": 0},
}


def fuse_linears(linears):
    """Concatenate same-input linears into one (row-wise), or None.

    q|k|v and gate|up become single matmuls. All inputs must share a
    type and every array's other dim (in_features, scale groups);
    codebook layers are not fused.
    """
    kind = type(linears[0])
    if kind not in _OUT_DIM or any(type(m) is not kind for m in linears):
        return None
    arrays = {}
    for name, dim in _OUT_DIM[kind].items():
        parts = [getattr(m, name) for m in linears]
        if any(p.shape[1 - dim] != parts[0].shape[1 - dim] for p in parts):
            return None
        arrays[name] = torch.cat(parts, dim=dim)
    return kind(**arrays, bias=_fused_bias(linears))


def _fuse_gate_up(mlp: Mlp) -> None:
    """Fuse one Mlp's gate|up (in place), where its layers fuse."""
    if mlp.gate_up_proj is None and mlp.gate_proj is not None:
        fused = fuse_linears([mlp.gate_proj, mlp.up_proj])
        if fused is not None:
            mlp.gate_up_proj = fused
            mlp.gate_proj = mlp.up_proj = None


def stack_experts(experts) -> Optional[StackedExperts]:
    """The stacked weights of gate|up-fused experts, or None unless they
    are one family (all :class:`Int8Linear` or all :class:`Int4Linear`)
    without biases and of equal shapes."""
    gus = [e.gate_up_proj for e in experts]
    downs = [e.down_proj for e in experts]
    if all(isinstance(m, Int4Linear) for m in gus + downs):
        fmt = "int4"
    elif all(isinstance(m, Int8Linear) for m in gus + downs):
        fmt = "int8"
    else:
        return None
    if any(m.bias is not None for m in gus + downs):
        return None
    for family in (gus, downs):
        if any(
            m.wq.shape != family[0].wq.shape
            or m.scales.shape != family[0].scales.shape
            for m in family
        ):
            return None
    return StackedExperts(
        gate_up_wq=torch.stack([m.wq for m in gus]),
        gate_up_scales=torch.stack([m.scales for m in gus]),
        down_wq=torch.stack([m.wq for m in downs]),
        down_scales=torch.stack([m.scales for m in downs]),
        fmt=fmt,
    )


def fuse_block(block):
    """Fuse one block's q|k|v and gate|up projections (in place), and
    stack a MoE block's experts for the expert and pairs kernels."""
    attn, mlp = block.attn, block.mlp
    if attn.qkv_proj is None and attn.q_proj is not None:
        fused = fuse_linears([attn.q_proj, attn.k_proj, attn.v_proj])
        if fused is not None:
            attn.qkv_proj = fused
            attn.q_proj = attn.k_proj = attn.v_proj = None
    if isinstance(mlp, MoeMlp):
        for expert in mlp.experts:
            _fuse_gate_up(expert)
        if mlp.stacked is None and len(mlp.experts):
            mlp.stacked = stack_experts(mlp.experts)
            if mlp.stacked is not None:
                # the per-expert copies go, so the expert weights exist
                # once on the device: both MoE paths read the stack
                mlp.experts = nn.ModuleList()
    else:
        _fuse_gate_up(mlp)
    return block


def fuse_model(model):
    """Fuse q|k|v and gate|up projections and stack MoE experts across
    all blocks (in place)."""
    for block in model.blocks:
        fuse_block(block)
    return model
