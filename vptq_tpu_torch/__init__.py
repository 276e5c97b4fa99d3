"""vptq_tpu_torch: the PyTorch/CUDA port of vptq_tpu for NVIDIA Hopper.

The JAX package ``vptq_tpu`` is the reference; this package imports
nothing of it and no JAX. Every Pallas kernel on a ported path is a
hand-written CUDA kernel under ``csrc/``, built at first use.
"""

from vptq_tpu_torch.api import AutoModelForCausalLM, Engine

__all__ = ["AutoModelForCausalLM", "Engine"]
