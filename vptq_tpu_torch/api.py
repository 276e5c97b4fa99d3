"""Entry point mirroring the reference's ``from_pretrained``.

Port of ``vptq_tpu/api.py``: a loaded model plus its :class:`Generator`,
on one device (CUDA unless ``device="cpu"`` is passed), or with ``tp=n``
one rank's shard of it inside an initialized process group of ``n``
ranks (``parallel/distributed.py``), every rank making the same calls.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from vptq_tpu_torch.models.llama import Model
from vptq_tpu_torch.models.loader import load_model
from vptq_tpu_torch.serving.generate import Generator

__all__ = ["AutoModelForCausalLM", "Engine"]


class Engine:
    """A loaded model (under ``mesh``, this rank's shard) and its
    :class:`Generator`."""

    def __init__(
        self, model: Model, max_seq: int = 2048, dtype=torch.bfloat16,
        mesh=None,
    ):
        self.model = model
        self.config = model.cfg
        self.mesh = mesh
        self.generator = Generator(model, max_seq=max_seq, dtype=dtype,
                                   mesh=mesh)

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
        tp: int = 1,
        hbm_gb=None,
        hbm_utilization: float = 0.9,
        **_ignored,
    ) -> Engine:
        """Load a local checkpoint directory (dense Llama, Mistral, Qwen2,
        Phi-3, Mixtral or DeepSeek-V3); ``device`` defaults to CUDA and
        raises when no CUDA device is present.

        ``runtime_format``: "int8" (K1), "int4" (K2), "int3" (K4) or
        "int2" (K3) re-encode every quantized linear for its hand-written
        kernel; "bf16" dequantizes to bf16; "codebook" keeps the VQ
        layers; "int4-mixed", "int3-mixed" and "int2-mixed" calibrate
        the checkpoint on 4096 synthetic tokens (GPTQ on ``device``,
        ``quant/calibrate.py``) and serve through the base format's
        kernel and K1 on the int8 side. ``tp`` > 1: tensor (and expert)
        parallelism over the ``tp`` ranks of the initialized process
        group (every rank calls this alike; ``device`` None: the rank's
        own, ``parallel.distributed.local_device``): a ``Mesh(data=1,
        model=tp)``, each rank loading and serving its shard (a calibrated
        format is calibrated once, on rank 0's device, with the
        row-parallel sites blocked, ``load_model``); the codebook format
        is refused then.
        ``hbm_gb`` / ``hbm_utilization``: the loader's memory budget
        (``load_model``), checked before any weight is read.
        """
        mesh = None
        if tp and tp > 1:
            from vptq_tpu_torch.parallel.mesh import make_mesh

            if runtime_format == "codebook":
                raise ValueError(
                    "tp>1 requires runtime_format int8/int4/bf16 "
                    "(codebook does not run the shard_map path)"
                )
            mesh = make_mesh(data=1, model=tp, device=device)
            device = None
        model = load_model(
            pretrained_model_name_or_path,
            dtype=dtype,
            runtime_format=runtime_format,
            device=device,
            hbm_gb=hbm_gb,
            hbm_utilization=hbm_utilization,
            mesh=mesh,
        )
        return Engine(model, max_seq=max_seq, dtype=dtype, mesh=mesh)
