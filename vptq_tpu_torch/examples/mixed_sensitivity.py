"""How well a synthetic mixed model can judge its kernels, by weight spread.

A synthetic int2-mixed or int3-mixed model (``utils/synth.py``
``mixed_model``: random codes, Llama-3.1-8B width, all 32 layers) is
prefilled with 128 random tokens three times: through the kernels,
through their plain versions, and through the plain versions again on an
embedding whose entries each move by at most one bf16 ulp (times
1 ± 2^-8). Printed, after the card's name and power limit, for each
format and spread: max |kernels − plain| and max |moved − plain| over
the first 16 rows' logits, each over max |plain|. The second is the
model's own conditioning: where it is as large as the bound the smoke
holds the first to (``chip_smoke.LOGIT_TOL``), that bound cannot tell a
right kernel from a wrong one.

    python -m vptq_tpu_torch.examples.mixed_sensitivity [--std 0.02,0.01]

Without a CUDA device it exits non-zero, unless given ``--device cpu``
(the plain versions on both sides; ``--tiny`` for a small model).
"""

from __future__ import annotations

import argparse
import contextlib
from unittest import mock

import torch

from vptq_tpu_torch.examples.kernel_bench import card_line, pick_device
from vptq_tpu_torch.examples.profile_decode import LLAMA31_8B, TINY

__all__ = ["main", "nudged", "sensitivity"]

# each mixed format's base kernel and K1, by the names the layers call
_KERNELS = {"int2-mixed": ("w2_matmul", "w8_matmul"),
            "int3-mixed": ("w3_matmul", "w8_matmul")}


@contextlib.contextmanager
def _plain(fmt: str):
    """The mixed layers' kernels swapped for their plain versions."""
    import importlib

    from vptq_tpu_torch.layers import runtime

    with contextlib.ExitStack() as stack:
        for name in _KERNELS[fmt]:
            mod = importlib.import_module(f"vptq_tpu_torch.ops.{name}")
            stack.enter_context(mock.patch.object(
                runtime, name, getattr(mod, f"{name}_reference")))
        yield


def nudged(embed: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """``embed`` with each entry times 1 ± 2^-8 (a random sign) and
    rounded back: moved by at most one bf16 ulp."""
    sign = torch.randn(embed.shape, device=embed.device,
                       generator=torch.Generator(device=embed.device)
                       .manual_seed(seed)).sign()
    return (embed.float() * (1 + 2.0 ** -8 * sign)).to(embed.dtype)


def sensitivity(cfg: dict, fmt: str, std: float, device, seed=0, rows=16):
    """(kernels vs plain, one-ulp embedding vs plain): max |diff| over the
    first ``rows`` rows' logits, each over max |plain logits|."""
    from vptq_tpu_torch.models.llama import ModelConfig, forward, init_cache
    from vptq_tpu_torch.utils.synth import mixed_model

    mc = ModelConfig(**cfg)
    model = mixed_model(mc, fmt, device, seed=seed, std=std)
    seq = min(128, mc.max_position_embeddings)
    tokens = torch.randint(0, mc.vocab_size, (1, seq),
                           generator=torch.Generator().manual_seed(seed))

    def logits(plain: bool):
        with torch.inference_mode(), (
                _plain(fmt) if plain else contextlib.nullcontext()):
            out, _ = forward(
                model, tokens.to(device),
                init_cache(mc, 1, seq, torch.bfloat16, device),
                dtype=torch.bfloat16, fresh_prefill=True,
            )
        return out[0, :rows].float()

    kernels, plain = logits(False), logits(True)
    model.embed_tokens = nudged(model.embed_tokens, seed)
    moved = logits(True)
    top = plain.abs().max()
    return (((kernels - plain).abs().max() / top).item(),
            ((moved - plain).abs().max() / top).item())


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--std", default="0.02,0.015,0.01",
                        help="the spreads to try, comma-separated")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--tiny", action="store_true")
    args = parser.parse_args(argv)
    device = pick_device(args.device)
    print(f"# {card_line(device)}", flush=True)
    cfg = TINY if args.tiny else LLAMA31_8B
    for fmt in _KERNELS:
        for std in (float(s) for s in args.std.split(",")):
            kernel, moved = sensitivity(cfg, fmt, std, device, args.seed)
            print(f"{fmt} std {std}: kernels vs plain {kernel:.5f}, "
                  f"one-ulp embedding {moved:.5f} (of max |logit|)",
                  flush=True)
            if device.type == "cuda":
                torch.cuda.empty_cache()
    print(f"# {card_line(device)}", flush=True)


if __name__ == "__main__":
    main()
