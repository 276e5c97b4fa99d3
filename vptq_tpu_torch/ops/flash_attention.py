"""K8 ``flash_attention``: causal attention over one fresh chunk.

Port of the Pallas TPU flash-attention op that the JAX package calls for
a fresh prefill of 1024 tokens or more (``vptq_tpu/models/llama.py:577``;
body ``_flash_attention_kernel_single_batch`` of
``jax.experimental.pallas.ops.tpu.flash_attention``). The kernel is
hand-written CUDA for Hopper in ``vptq_tpu_torch/csrc/flash_attention.cu``,
built by ``ops/_build.py`` and called through ``ctypes`` on PyTorch's
current stream.

The JAX call repeats K/V to H heads and moves heads before positions;
here q, k and v keep the model's own (B, S, heads, D) layout, the KV
head of query head ``h`` is ``h // group``, and v may be a view into a
fused q|k|v row (its strides go to the kernel).

:func:`flash_attention` launches the kernel for CUDA tensors, and runs
the plain version :func:`flash_attention_reference` only for tensors
that lie on the CPU. ``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from vptq_tpu_torch.ops import _build

__all__ = ["HEAD_DIMS", "flash_attention", "flash_attention_reference"]

# head sizes the kernel is instantiated for
HEAD_DIMS = (64, 128)
# DEFAULT_MASK_VALUE of the TPU op: masked scores are large and finite
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """Validate shapes and dtypes; returns the GQA group size."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, S, heads, D)")
    batch, seq, heads, dim = q.shape
    kv_heads = k.shape[2]
    if k.shape != (batch, seq, kv_heads, dim) or v.shape != k.shape:
        raise ValueError(
            f"q {tuple(q.shape)}, k {tuple(k.shape)} and v {tuple(v.shape)} "
            "must share batch, length and head size, k and v their heads"
        )
    if seq < 1 or kv_heads < 1 or heads % kv_heads:
        raise ValueError(
            f"{heads} query heads over {kv_heads} KV heads, length {seq}"
        )
    if not q.is_floating_point() or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"q, k and v must share one float dtype, got {q.dtype}, "
            f"{k.dtype}, {v.dtype}"
        )
    return heads // kv_heads


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """Plain torch version of K8, the arithmetic of the TPU kernel body.

    f32 scores of the inputs as they are (exact products of bf16 values),
    scaled in f32; masked scores take a large finite negative, not
    ``-inf``; max, exp and the sum ``l`` in f32; ``p`` rounded to v's
    dtype before the f32 p·v product; one division, one rounding to q's
    dtype. Materialises the (B, H, S, S) scores: for tests and checks.
    """
    group = _check(q, k, v)
    batch, seq, heads, dim = q.shape
    kv_heads = k.shape[2]
    qg = q.reshape(batch, seq, kv_heads, group, dim).to(torch.float32)
    scores = torch.einsum(
        "bskgd,btkd->bkgst", qg, k.to(torch.float32)
    ) * scale
    pos = torch.arange(seq, device=q.device)
    scores = scores.masked_fill(pos[None, :] > pos[:, None], MASK_VALUE)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1)  # (B, KV, G, S)
    out = torch.einsum(
        "bkgst,btkd->bkgsd", p.to(v.dtype).to(torch.float32),
        v.to(torch.float32),
    ) / denom[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(batch, seq, heads * dim)
    return out.to(q.dtype)


def _strides(name: str, t: torch.Tensor) -> tuple[int, int]:
    """(batch, position) strides of a (B, S, heads, D) tensor whose heads
    lie D apart with contiguous values; raises on any other layout."""
    dim = t.shape[3]
    if t.stride(3) != 1 or (t.shape[2] > 1 and t.stride(2) != dim):
        raise ValueError(
            f"flash_attention: {name} must hold each position's heads "
            f"contiguously, got strides {t.stride()}"
        )
    # the stride of a dimension of one element is never used
    sb = t.stride(0) if t.shape[0] > 1 else 0
    ss = t.stride(1) if t.shape[1] > 1 else 0
    if t.data_ptr() % 16 or sb % 8 or ss % 8:
        raise ValueError(
            f"flash_attention: {name} must be 16-byte aligned with row "
            f"strides that are multiples of 8, got strides {t.stride()}"
        )
    return sb, ss


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """Causal ``softmax(scale · q kᵀ) v`` through the K8 kernel.

    q (B, S, H, D), k and v (B, S, KV, D) with ``H % KV == 0``; query
    head ``h`` attends KV head ``h // (H // KV)`` at positions ``t <= s``.
    Returns (B, S, H·D) in q's dtype. On CUDA the tensors are bf16 and D
    is one of :data:`HEAD_DIMS`; row strides may be those of a view into
    a wider row.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(
            f"flash_attention runs on cuda or cpu, not {q.device}"
        )
    batch, seq, heads, dim = q.shape
    kv_heads = k.shape[2]
    if dim not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention: head size {dim} is not built; supported "
            f"sizes are {HEAD_DIMS}"
        )
    if q.dtype != torch.bfloat16:
        raise ValueError(
            f"flash_attention: the kernel takes bfloat16, got {q.dtype}"
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: all tensors must be on one device")
    # heads and batch are the launch grid's y and z
    if heads > 65535 or batch > 65535:
        raise ValueError(
            f"flash_attention: at most 65535 heads and sequences, got "
            f"{heads} and {batch}"
        )
    strides = [s for name, t in (("q", q), ("k", k), ("v", v))
               for s in _strides(name, t)]
    out = torch.empty(
        (batch, seq, heads * dim), dtype=q.dtype, device=q.device
    )
    # int f(q, k, v, o, B, S, H, KV, D, 6 strides, scale, stream)
    argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.c_longlong] * 6 + [ctypes.c_float, ctypes.c_void_p],
        ctypes.c_int,
    )
    lib = _build.load(
        "flash_attention", {"vptq_flash_attention": argtypes}
    )
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.vptq_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            batch, seq, heads, kv_heads, dim, *strides, float(scale), stream,
        )
    if err:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err}"
        )
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
# the TPU kernel this one replaces: the call of the Pallas flash op
flash_attention.replaces = "vptq_tpu/models/llama.py:585"
# a word of the demangled name of its CUDA kernel (fa::flash_fwd<D>)
flash_attention.trace_tags = ("flash_fwd",)
