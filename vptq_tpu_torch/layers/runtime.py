"""Runtime weight formats: the dense re-encodings of VPTQ layers.

Port of ``vptq_tpu/layers/runtime.py``. The loader reconstructs each
layer's exact weight once (a torch gather on the load device) and
re-encodes it:

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

The calibrated mixed layers :class:`Int2MixedLinear` and
:class:`Int3MixedLinear` add an int8 side matrix on a few input columns
to an int2 or int3 base (``y = base(x) + int8(x[..., col_idx])``: K3 or
K4, then K1). Calibration (``quant/calibrate.py``) chooses their codes
and builds them with the ``*_from_q`` constructors; a runtime checkpoint
(``tools/export_runtime.py``) reads them back.

Every encoding is byte-equal to the JAX package's numpy encoder.
:func:`fuse_block` also stacks the int8 or int4 experts of a Mixtral or
DeepSeek MoE block (:func:`stack_experts`) for the expert and pairs
kernels K6 and K5; :func:`absorb_mla` turns an MLA layer's kv_b_proj
into the latent-space products uk / uv.
The blocked (``shards > 1``) encodings of tensor parallelism split the
in axis into ``shards`` contiguous column blocks and encode each alone,
so that each block is a standard layer for one rank's kernel
(``parallel/tp.py`` places them; ``to_runtime(row_shards=)``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vptq_tpu_torch.layers.dense import DenseLinear
from vptq_tpu_torch.layers.vqlinear import VQLinear
from vptq_tpu_torch.models.llama import (
    Attention,
    DeepseekMoe,
    Mlp,
    MoeMlp,
    StackedExperts,
)
from vptq_tpu_torch.ops.packing import (
    INT4_GROUP,
    W2_BLOCK,
    W2_GROUP,
    W3_BLOCK,
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
    "INT2_MIXED_COL_FRACTION",
    "INT3_MIXED_COL_FRACTION",
    "Int2Linear",
    "Int2MixedLinear",
    "Int3Linear",
    "Int3MixedLinear",
    "Int4Linear",
    "Int8Linear",
    "RUNTIME_FORMATS",
    "absorb_mla",
    "dense_to_int4",
    "dense_to_int8",
    "fuse_block",
    "fuse_linears",
    "fuse_model",
    "int2_from_q",
    "int2_weight",
    "int3_from_q",
    "int3_weight",
    "int4_from_q",
    "int4_weight",
    "int8_from_q",
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
    def in_padded(self) -> int:
        return self.wq.shape[1]

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


# the int8 share of a mixed format's input columns, before calibration's
# count rule (at least 128, a multiple of 128, at most in_features):
# ~2.5 bits a weight for int2-mixed, ~3.4 for int3-mixed
INT2_MIXED_COL_FRACTION = 1 / 48
INT3_MIXED_COL_FRACTION = 1 / 32


class _MixedLinear(nn.Module):
    """A low-bit base plus an int8 side matrix on chosen input columns:
    ``y = base(x) + int8(x[..., col_idx])``, then the bias.

    The gather stays on the device (one ``index_select``), the base runs
    its format's kernel and the side K1, both in ``x.dtype``. A blocked
    (``shards > 1``) instance, whose ``col_idx`` holds shard-local ids, is
    made only by the JAX package's calibration; the runtime reader
    refuses it.
    """

    _BASE = ""

    def __init__(
        self,
        base: nn.Module,
        int8: Int8Linear,
        col_idx: torch.Tensor,  # (k,) int32, the original input columns
        bias: Optional[torch.Tensor] = None,
    ):
        super().__init__()
        setattr(self, self._BASE, base)
        self.int8 = int8
        self.register_buffer("col_idx", col_idx)
        self.register_buffer("bias", bias)

    @property
    def base(self) -> nn.Module:
        return getattr(self, self._BASE)

    @property
    def out_features(self) -> int:
        return self.base.out_features

    @property
    def in_padded(self) -> int:
        return self.base.in_padded

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = x.index_select(-1, self.col_idx)
        out = self.base(x) + self.int8(xs).to(x.dtype)
        return _add_bias(out, self.bias)


class Int2MixedLinear(_MixedLinear):
    """int2 plane (K3) + int8 side matrix (K1): the calibrated ~2.5-bit
    format. Its side holds the residual of the selected columns, which
    the half-offset grid cannot zero."""

    _BASE = "int2"

    def __init__(self, int2: Int2Linear, int8: Int8Linear, col_idx,
                 bias=None):
        super().__init__(int2, int8, col_idx, bias)


class Int3MixedLinear(_MixedLinear):
    """int3 planes (K4) + int8 side matrix (K1): the calibrated ~3.4-bit
    format; the selected columns hold zeros in the planes."""

    _BASE = "int3"

    def __init__(self, int3: Int3Linear, int8: Int8Linear, col_idx,
                 bias=None):
        super().__init__(int3, int8, col_idx, bias)


def _exact_weight(layer: VQLinear) -> torch.Tensor:
    """Exact f32 weight (out, in) on the layer's device.

    The loader cast the planes to the load dtype first, as the JAX
    package does, so this equals ``vptq_tpu``'s ``_exact_weight``.
    """
    return layer_weight(layer, torch.float32)


def _pad_columns(w: torch.Tensor, pad_to: int) -> torch.Tensor:
    pad = (-w.shape[1]) % pad_to
    return nn.functional.pad(w, (0, pad)) if pad else w


def _blocks(w: torch.Tensor, shards: int):
    """The in axis zero-padded to a multiple of ``shards``, cut into that
    many contiguous column blocks."""
    w = _pad_columns(w, shards)
    blk = w.shape[1] // shards
    return [w[:, s * blk: (s + 1) * blk] for s in range(shards)]


def _blocked(layer: nn.Module, shards: int) -> nn.Module:
    """``layer`` tagged with the shard count of its blocked layout (a
    placement artifact: ``tools/export_runtime.py`` refuses to write it,
    ``parallel/tp.py`` ``shards_summed`` runs it on one device)."""
    layer.shards = shards
    return layer


def blocked_pad(bits: int, blk: int):
    """(scale group, padded width multiple) of one shard of ``blk``
    columns in the blocked layout of ``bits``-bit codes: int4 pads to 512
    (256 below 512), int3 to ``W3_BLOCK``, int2 to ``W2_BLOCK``, int8 to
    its own group (``pick_group`` of the shard's width)."""
    if bits == 4:
        return INT4_GROUP, 512 if blk >= 512 else 256
    if bits == 3:
        return INT4_GROUP, W3_BLOCK
    if bits == 2:
        return W2_GROUP, W2_BLOCK
    group = pick_group(blk)
    return group, group


# each array's in axis (int8 / int4 scales are stored (groups, out))
BLOCKED_IN_AXES = {
    Int8Linear: {"wq": 1, "scales": 0},
    Int4Linear: {"wq": 1, "scales": 0},
    Int3Linear: {"wq2": 1, "wq1": 1, "scales": 1},
    Int2Linear: {"wq": 1, "scales": 1},
}


def concat_blocked(parts, shards: int, bias=None) -> nn.Module:
    """The blocked layer of ``shards`` one-shard layers of one kind,
    side by side on the in axis, tagged (:func:`_blocked`)."""
    kind = type(parts[0])
    return _blocked(kind(
        **{name: torch.cat([getattr(p, name) for p in parts], dim=dim)
           for name, dim in BLOCKED_IN_AXES[kind].items()},
        bias=bias,
    ), shards)


def _encode_int8(
    w: torch.Tensor, bias: Optional[torch.Tensor], group: Optional[int] = None,
    shards: int = 1,
) -> Int8Linear:
    """f32 (out, in) weight → :class:`Int8Linear` on the same device.

    Symmetric per-(row, group) scale ``absmax / 127`` (1 for an all-zero
    group); ``q = round(w / scale)`` rounds half to even after an f32
    divide, as ``np.round`` does in the JAX package's encoder.
    ``shards > 1``: the blocked layout, each block with its own group
    (``pick_group`` of its width) and padding.
    """
    if shards > 1:
        return concat_blocked([_encode_int8(b, None, group)
                               for b in _blocks(w, shards)], shards, bias)
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


def _encode_int4(
    w: torch.Tensor, bias: Optional[torch.Tensor], shards: int = 1,
    pad_to: int = 2048,
) -> Int4Linear:
    """f32 (out, in) weight → :class:`Int4Linear` on the same device,
    in_features zero-padded to a multiple of ``pad_to``. ``shards > 1``:
    the blocked layout, each block padded as :func:`blocked_pad` says."""
    if shards > 1:
        return concat_blocked([
            _encode_int4(b, None, pad_to=blocked_pad(4, b.shape[1])[1])
            for b in _blocks(w, shards)
        ], shards, bias)
    q, scale = quantize_int4(_pad_columns(w, pad_to))
    return Int4Linear(
        wq=pack_int4(q),
        scales=scale.t().contiguous().to(torch.bfloat16),
        bias=bias,
    )


def _encode_int3(
    w: torch.Tensor, bias: Optional[torch.Tensor], shards: int = 1,
    pad_to: int = 2048,
) -> Int3Linear:
    """f32 (out, in) weight → :class:`Int3Linear` on the same device,
    in_features zero-padded to a multiple of ``pad_to``. ``shards > 1``:
    the blocked layout, each block padded as :func:`blocked_pad` says."""
    if shards > 1:
        return concat_blocked([
            _encode_int3(b, None, pad_to=blocked_pad(3, b.shape[1])[1])
            for b in _blocks(w, shards)
        ], shards, bias)
    q, scale = quantize_int3(_pad_columns(w, pad_to))
    wq2, wq1 = pack_int3(q)
    return Int3Linear(
        wq2=wq2, wq1=wq1, scales=scale.to(torch.bfloat16), bias=bias
    )


def _encode_int2(
    w: torch.Tensor, bias: Optional[torch.Tensor], shards: int = 1,
    group: int = W2_GROUP,
) -> Int2Linear:
    """f32 (out, in) weight → :class:`Int2Linear` on the same device,
    in_features zero-padded to a multiple of 1024 (``shards > 1``: the
    blocked layout, each block padded to 1024)."""
    if shards > 1:
        return concat_blocked([_encode_int2(b, None, group=group)
                               for b in _blocks(w, shards)], shards, bias)
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


def _pad_codes(q, scales, pad_to: int, group: int, code: int = 0):
    """Codes (out, in) and out-major scales (out, in / group) padded along
    in_features to a multiple of ``pad_to``: codes with ``code``, scales
    with 1.0 (finite and exact in bf16)."""
    pad = (-q.shape[1]) % pad_to
    if pad:
        q = nn.functional.pad(q, (0, pad), value=code)
        scales = nn.functional.pad(scales, (0, pad // group), value=1.0)
    return q.contiguous(), scales


def int8_from_q(q: torch.Tensor, scales: torch.Tensor, bias=None):
    """:class:`Int8Linear` from given codes: ``q`` (out, in) int8 with
    ``in`` a multiple of the scale group, ``scales`` (out, in / group)."""
    return Int8Linear(
        wq=q.contiguous(),
        scales=scales.t().to(torch.float32).contiguous(),
        bias=bias,
    )


def int4_from_q(q: torch.Tensor, scales: torch.Tensor, bias=None,
                pad_to: int = 2048) -> Int4Linear:
    """:class:`Int4Linear` from given codes: ``q`` (out, in) int8 in
    [-7, 7], ``in % 128 == 0``; ``scales`` (out, in / 128) f32, already
    bf16-representable."""
    q, scales = _pad_codes(q, scales, pad_to, INT4_GROUP)
    return Int4Linear(
        wq=pack_int4(q),
        scales=scales.t().contiguous().to(torch.bfloat16),
        bias=bias,
    )


def int3_from_q(q: torch.Tensor, scales: torch.Tensor, bias=None,
                pad_to: int = 2048) -> Int3Linear:
    """:class:`Int3Linear` from given codes: ``q`` (out, in) int8 in
    [-4, 3], ``in % 128 == 0``; ``scales`` (out, in / 128) f32."""
    q, scales = _pad_codes(q, scales, pad_to, INT4_GROUP)
    wq2, wq1 = pack_int3(q)
    return Int3Linear(
        wq2=wq2, wq1=wq1, scales=scales.contiguous().to(torch.bfloat16),
        bias=bias,
    )


def int2_from_q(q: torch.Tensor, scales: torch.Tensor, bias=None,
                pad_to: int = W2_BLOCK, group: int = W2_GROUP) -> Int2Linear:
    """:class:`Int2Linear` from given codes: ``q`` (out, in) int8 in
    [-2, 1] (levels ``(q + 0.5)·s``), ``in % group == 0``; ``scales``
    (out, in / group) f32. Padded columns take code -1 (x is zero-padded
    there, so they add nothing)."""
    q, scales = _pad_codes(q, scales, pad_to, group, code=-1)
    return Int2Linear(
        wq=pack_int2(q), scales=scales.contiguous().to(torch.bfloat16),
        bias=bias,
    )


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


def absorb_mla(kv_b_proj, cfg, dtype=torch.bfloat16):
    """An MLA layer's kv_b up-projections as (uk (kv_lora, heads,
    qk_nope), uv (kv_lora, heads, v_head)) in ``dtype``: the exact f32
    weight of the raw layer (never re-encoded first), split per head and
    transposed, so that attention runs in the compressed latent space
    (``models/llama.py`` ``_mla_attention``). Exact up to the rounding to
    ``dtype``."""
    nh, dn = cfg.num_attention_heads, cfg.qk_nope_head_dim
    w = linear_exact_weight(kv_b_proj, cfg.kv_lora_rank).reshape(
        nh, dn + cfg.v_head_dim, cfg.kv_lora_rank)
    uk = w[:, :dn, :].permute(2, 0, 1).contiguous().to(dtype)
    uv = w[:, dn:, :].permute(2, 0, 1).contiguous().to(dtype)
    return uk, uv


def to_bf16(layer: VQLinear) -> DenseLinear:
    return DenseLinear(
        weight=_exact_weight(layer).to(torch.bfloat16), bias=layer.bias
    )


def to_runtime(layer, fmt: str, row_shards: int = 1):
    """Convert any linear to the requested runtime format.

    ``row_shards > 1``: the in axis in the blocked layout of tensor
    parallelism, each block encoded once straight from the exact weight
    (the loader's row-parallel layers: o_proj, down_proj). bf16 has no
    blocks: its placement slices the columns.
    """
    if fmt not in RUNTIME_FORMATS:
        raise ValueError(f"unknown runtime format {fmt!r}")
    if not isinstance(layer, VQLinear):
        return layer  # dense stays dense
    if fmt == "codebook":
        if row_shards > 1:
            raise NotImplementedError(
                "codebook format under tensor parallelism: use a runtime "
                "format (int8/int4/int3/int2/bf16)"
            )
        return layer
    if row_shards > 1 and fmt in _ENCODE:
        return _ENCODE[fmt](_exact_weight(layer), layer.bias,
                            shards=row_shards)
    return _TO_FORMAT[fmt](layer)


_TO_FORMAT = {
    "int8": to_int8, "int4": to_int4, "int3": to_int3, "int2": to_int2,
    "bf16": to_bf16,
}
_ENCODE = {
    "int8": _encode_int8, "int4": _encode_int4, "int3": _encode_int3,
    "int2": _encode_int2,
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
    type and every array's other dim (in_features, scale groups); mixed
    layers also one ``col_idx``, and fuse their base and side apart;
    codebook layers are not fused.
    """
    kind = type(linears[0])
    if any(type(m) is not kind for m in linears):
        return None
    if issubclass(kind, _MixedLinear):
        return _fuse_mixed(linears)
    if kind not in _OUT_DIM:
        return None
    arrays = {}
    for name, dim in _OUT_DIM[kind].items():
        parts = [getattr(m, name) for m in linears]
        if any(p.shape[1 - dim] != parts[0].shape[1 - dim] for p in parts):
            return None
        arrays[name] = torch.cat(parts, dim=dim)
    return kind(**arrays, bias=_fused_bias(linears))


def _fuse_mixed(linears):
    """Mixed layers sharing one column selection (calibration picks one
    per site, so q|k|v and gate|up do) as one, or None."""
    cols = linears[0].col_idx
    if any(m.col_idx.shape != cols.shape or not torch.equal(m.col_idx, cols)
           for m in linears[1:]):
        return None
    base = fuse_linears([m.base for m in linears])
    side = fuse_linears([m.int8 for m in linears])
    if base is None or side is None:
        return None
    return type(linears[0])(base, side, cols, bias=_fused_bias(linears))


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
    stack a MoE block's experts for the expert and pairs kernels (a
    DeepSeek block's shared experts fuse their gate|up; its MLA
    projections stay apart, as in the JAX package)."""
    attn, mlp = block.attn, block.mlp
    if (isinstance(attn, Attention) and attn.qkv_proj is None
            and attn.q_proj is not None):
        fused = fuse_linears([attn.q_proj, attn.k_proj, attn.v_proj])
        if fused is not None:
            attn.qkv_proj = fused
            attn.q_proj = attn.k_proj = attn.v_proj = None
    if isinstance(mlp, (MoeMlp, DeepseekMoe)):
        for expert in mlp.experts:
            _fuse_gate_up(expert)
        if mlp.stacked is None and len(mlp.experts):
            mlp.stacked = stack_experts(mlp.experts)
            if mlp.stacked is not None:
                # the per-expert copies go, so the expert weights exist
                # once on the device: both MoE paths read the stack
                mlp.experts = nn.ModuleList()
        if isinstance(mlp, DeepseekMoe):
            _fuse_gate_up(mlp.shared_experts)
    else:
        _fuse_gate_up(mlp)
    return block


def fuse_model(model):
    """Fuse q|k|v and gate|up projections and stack MoE experts across
    all blocks (in place)."""
    for block in model.blocks:
        fuse_block(block)
    return model
