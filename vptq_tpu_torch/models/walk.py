"""Model traversal helpers.

Port of ``vptq_tpu/models/walk.py``, the counterpart of the reference's
``find_layers`` (reference: vptq/layers/utils.py:9-18): yields every
linear of a loaded :class:`~vptq_tpu_torch.models.llama.Model` with its
dotted path, in the JAX package's order. Stacked experts
(``StackedExperts``) are no linears: a block whose experts were stacked
has an empty ``experts`` list and yields only its router (Mixtral) or
its shared experts (DeepSeek).
"""

from __future__ import annotations

from typing import Iterator, Tuple

from torch import nn

from vptq_tpu_torch.models.llama import (
    DeepseekMoe,
    MlaAttention,
    Model,
    MoeMlp,
)

__all__ = ["named_linears"]

_ATTN_FIELDS = ("q_proj", "k_proj", "v_proj", "o_proj", "qkv_proj")
_MLA_FIELDS = (
    "q_proj", "q_a_proj", "q_b_proj", "kv_a_proj", "kv_b_proj", "o_proj",
)
_MLP_FIELDS = ("gate_proj", "up_proj", "down_proj", "gate_up_proj")


def _iter_mlp(prefix: str, mlp) -> Iterator[Tuple[str, nn.Module]]:
    if isinstance(mlp, (MoeMlp, DeepseekMoe)):
        if isinstance(mlp, MoeMlp) and mlp.router is not None:
            yield f"{prefix}.router", mlp.router
        for e, expert in enumerate(mlp.experts):
            yield from _iter_mlp(f"{prefix}.experts.{e}", expert)
        if isinstance(mlp, DeepseekMoe):
            yield from _iter_mlp(
                f"{prefix}.shared_experts", mlp.shared_experts
            )
        return
    for name in _MLP_FIELDS:
        lin = getattr(mlp, name, None)
        if lin is not None:
            yield f"{prefix}.{name}", lin


def named_linears(model: Model) -> Iterator[Tuple[str, nn.Module]]:
    """Yield (path, linear) for every projection in the model."""
    for i, block in enumerate(model.blocks):
        p = f"model.layers.{i}"
        attn = block.attn
        fields = (
            _MLA_FIELDS if isinstance(attn, MlaAttention) else _ATTN_FIELDS
        )
        for name in fields:
            lin = getattr(attn, name, None)
            if lin is not None:
                yield f"{p}.self_attn.{name}", lin
        yield from _iter_mlp(f"{p}.mlp", block.mlp)
    if model.lm_head is not None:
        yield "lm_head", model.lm_head
