"""Dense (unquantized) linear layer; port of ``vptq_tpu/layers/dense.py``.

VPTQ checkpoints leave some modules in plain bf16, typically
``lm_head``. A plain matrix product goes to ``torch.matmul`` (cuBLAS),
as the JAX package leaves it to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["DenseLinear"]


class DenseLinear(nn.Module):
    def __init__(
        self, weight: torch.Tensor, bias: Optional[torch.Tensor] = None
    ):
        super().__init__()
        self.register_buffer("weight", weight)  # (out_features, in_features)
        self.register_buffer("bias", bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.matmul(x, self.weight.to(x.dtype).t())
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out

    @property
    def in_features(self) -> int:
        return self.weight.shape[1]

    @property
    def out_features(self) -> int:
        return self.weight.shape[0]
