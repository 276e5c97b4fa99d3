"""Quickstart: load a VPTQ checkpoint and generate on the card.

The port of ``examples/quickstart.py``. With no checkpoint given it
first writes a small synthetic one in the community on-disk format
(random weights, the JAX script's geometry) and a byte-level tokenizer
beside it, then runs the whole pipeline: ingestion, the int8 re-encode
(K1 carries every decoder linear) and decode through ``Generator``::

    python -m vptq_tpu_torch.examples.quickstart [CHECKPOINT]
        [--device cpu] [--temperature 0.8] [--seed 0]

The synthetic checkpoint's prompt is tokenized by
:class:`~vptq_tpu_torch.utils.synth_tokenizer.ByteTokenizer` (the ids of
``write_byte_tokenizer``'s directory without ``transformers``, which the
card's machine lacks); a given checkpoint's by its own tokenizer through
``AutoTokenizer`` (``--tokenizer byte`` for a synthetic one). Sampling
draws from a ``torch.Generator`` seeded with ``--seed``;
``--temperature 0`` is greedy. Without a CUDA device it exits non-zero
unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import torch

from vptq_tpu_torch.models.loader import entry_device, load_model
from vptq_tpu_torch.serving.generate import Generator
from vptq_tpu_torch.utils.synth_checkpoint import (
    tiny_model_config,
    write_synthetic_checkpoint,
)
from vptq_tpu_torch.utils.synth_tokenizer import ByteTokenizer

__all__ = ["PROMPT", "main", "write_quickstart_checkpoint"]

PROMPT = "The GPU is"
NEW_TOKENS = 32
# the JAX script's checkpoint: 4 layers at width 256, v8 k4096 with a
# 256-centroid residual, norm and packed indices
MODEL = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
             num_hidden_layers=4, num_attention_heads=8,
             num_key_value_heads=4, head_dim=32)
VQ = dict(vector_len=8, num_centroids=4096, num_res_centroids=256,
          enable_norm=True, is_indice_packed=True)


def write_quickstart_checkpoint(path) -> Path:
    """The quickstart's synthetic checkpoint (seed 0) at ``path``, with a
    byte-level tokenizer's files beside it when ``transformers`` is there
    to write them."""
    root = write_synthetic_checkpoint(path, tiny_model_config(**MODEL),
                                      vq_kwargs=VQ)
    try:
        from vptq_tpu_torch.utils.synth_tokenizer import write_byte_tokenizer

        write_byte_tokenizer(root)
    except ImportError:
        pass  # ByteTokenizer reads the same ids without the files
    return root


def _tokenizer(path, kind: str):
    """``kind`` "byte": :class:`ByteTokenizer`; "auto": the checkpoint
    directory's own, through ``AutoTokenizer``."""
    if kind == "byte":
        return ByteTokenizer()
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(path)


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("checkpoint", nargs="?", default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--temperature", type=float, default=0.8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dtype", default="bfloat16",
                        choices=("bfloat16", "float32"))
    parser.add_argument(
        "--tokenizer", choices=("auto", "byte"), default=None,
        help="byte: the byte-level ids without transformers (the default "
        "for the synthetic checkpoint); auto: the checkpoint's own "
        "(the default for a given one)")
    args = parser.parse_args(argv)
    device = entry_device(args.device)
    dtype = getattr(torch, args.dtype)
    ckpt = args.checkpoint
    if ckpt is None:
        ckpt = tempfile.mkdtemp(prefix="vptq_demo_")
        write_quickstart_checkpoint(ckpt)
        print(f"wrote synthetic checkpoint to {ckpt}")
    model = load_model(ckpt, dtype=dtype, runtime_format="int8",
                       device=device)
    gen = Generator(model, max_seq=512, dtype=dtype)
    tok = _tokenizer(ckpt, args.tokenizer or (
        "auto" if args.checkpoint else "byte"))
    ids = tok(PROMPT, return_tensors=None)["input_ids"]
    out = gen.generate(ids, max_new_tokens=NEW_TOKENS,
                       temperature=args.temperature, seed=args.seed)
    print("generated:", tok.decode(out))
    return out


if __name__ == "__main__":
    main()
