"""Entry point mirroring the reference's ``from_pretrained``.

Port of ``vptq_tpu/api.py``: a loaded model plus its :class:`Generator`,
on one device (CUDA unless ``device="cpu"`` is passed).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from vptq_tpu_torch.models.llama import Model
from vptq_tpu_torch.models.loader import load_model
from vptq_tpu_torch.serving.generate import Generator

__all__ = ["AutoModelForCausalLM", "Engine"]


class Engine:
    """A loaded model and its :class:`Generator`."""

    def __init__(
        self, model: Model, max_seq: int = 2048, dtype=torch.bfloat16
    ):
        self.model = model
        self.config = model.cfg
        self.generator = Generator(model, max_seq=max_seq, dtype=dtype)

    def generate(
        self,
        input_ids: Sequence[int],
        max_new_tokens: int = 256,
        eos_token_id: Optional[int] = None,
        temperature: float = 0.0,
        seed: int = 0,
        stream_callback=None,
    ) -> List[int]:
        return self.generator.generate(
            input_ids,
            max_new_tokens=max_new_tokens,
            eos_token_id=eos_token_id,
            temperature=temperature,
            seed=seed,
            stream_callback=stream_callback,
        )


class AutoModelForCausalLM:
    """``from_pretrained`` parity shim for reference users."""

    @classmethod
    def from_pretrained(
        cls,
        pretrained_model_name_or_path: str,
        runtime_format: str = "int8",
        dtype=torch.bfloat16,
        max_seq: int = 2048,
        device=None,
        **_ignored,
    ) -> Engine:
        """Load a local checkpoint directory; ``device`` defaults to CUDA
        and raises when no CUDA device is present.

        ``runtime_format``: "int8" (K1), "int4" (K2), "int3" (K4) or
        "int2" (K3) re-encode every quantized linear for its hand-written
        kernel; "bf16" dequantizes to bf16; "codebook" keeps the VQ
        layers. The calibrated "int*-mixed" formats raise (not ported).
        """
        model = load_model(
            pretrained_model_name_or_path,
            dtype=dtype,
            runtime_format=runtime_format,
            device=device,
        )
        return Engine(model, max_seq=max_seq, dtype=dtype)
