"""Perplexity evaluation (the reference's accuracy metric).

Port of ``vptq_tpu/eval/ppl.py``. The reference reports WikiText-2 / C4
perplexity at context 4096 (BASELINE.md; tech report §5). This computes
PPL over a token stream in non-overlapping windows, each one fresh-cache
forward on the model's device: a window of 1024 tokens or more in bf16
attends through K8 (``llama.takes_flash``).

Usage (library):
    ppl = perplexity(model, token_ids, seq_len=4096)

CLI (a local text file, or the reference's published datasets, which
need the ``datasets`` package and network access):
    python -m vptq_tpu_torch.eval.ppl --model DIR --text FILE \\
        [--tokenizer DIR] [--seq-len 4096] [--runtime-format int8] \\
        [--device cuda|cpu]
    python -m vptq_tpu_torch.eval.ppl --model DIR --dataset wikitext2|c4
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from vptq_tpu_torch.models.llama import Model, forward, init_cache

__all__ = ["perplexity", "window_nll"]


@torch.inference_mode()
def window_nll(
    model: Model, tokens: torch.Tensor, dtype=torch.bfloat16
) -> Tuple[float, int]:
    """Sum of next-token NLL and its count over one (1, S) window."""
    cache = init_cache(model.cfg, 1, tokens.shape[1], dtype, tokens.device)
    logits, _ = forward(model, tokens, cache, dtype=dtype, fresh_prefill=True)
    logp = torch.log_softmax(logits[0, :-1].to(torch.float32), dim=-1)
    targets = tokens[0, 1:]
    nll = -torch.gather(logp, -1, targets[:, None])[:, 0]
    return float(torch.sum(nll)), nll.shape[0]


def perplexity(
    model: Model,
    token_ids: Sequence[int] | np.ndarray,
    seq_len: int = 4096,
    dtype=torch.bfloat16,
    progress: bool = False,
) -> float:
    """PPL over non-overlapping ``seq_len`` windows (drops the tail
    shorter than 2 tokens)."""
    ids = np.asarray(token_ids, dtype=np.int64)
    if ids.ndim != 1:
        raise ValueError("token_ids must be 1-D")
    device = model.embed_tokens.device
    n_windows = len(ids) // seq_len
    total_nll, total_cnt = 0.0, 0
    windows = [
        ids[i * seq_len: (i + 1) * seq_len] for i in range(n_windows)
    ]
    tail = ids[n_windows * seq_len:]
    if len(tail) >= 2 and n_windows == 0:
        windows.append(tail)
    for i, w in enumerate(windows):
        nll, cnt = window_nll(
            model, torch.from_numpy(w)[None, :].to(device), dtype
        )
        total_nll += nll
        total_cnt += cnt
        if progress:
            print(
                f"window {i + 1}/{len(windows)}: "
                f"ppl so far {np.exp(total_nll / total_cnt):.4f}",
                flush=True,
            )
    if total_cnt == 0:
        raise ValueError("not enough tokens for one window")
    return float(np.exp(total_nll / total_cnt))


def main(argv=None) -> int:
    import argparse

    from vptq_tpu_torch.models.loader import entry_device, load_model

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", required=True)
    p.add_argument("--tokenizer", default="")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--text", help="plain-text file to evaluate")
    src.add_argument(
        "--dataset", choices=("wikitext2", "c4"),
        help="reference eval corpus (needs `datasets` + network; "
        "expected numbers in eval/datasets.py / BASELINE.md)",
    )
    p.add_argument("--seq-len", type=int, default=4096)
    p.add_argument(
        "--runtime-format", default="int8",
        choices=(
            "int8", "int4", "int4-mixed", "int3", "int3-mixed",
            "int2", "int2-mixed",
            "bf16", "codebook",
        ),
    )
    p.add_argument("--device", default="cuda",
                   help="where the model runs (cuda or cpu)")
    args = p.parse_args(argv)
    device = entry_device(args.device)

    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(args.tokenizer or args.model)
    if args.dataset:
        from vptq_tpu_torch.eval.datasets import load_eval_tokens

        ids = load_eval_tokens(args.dataset, tok)
    else:
        with open(args.text) as f:
            text = f.read()
        ids = tok(text, return_tensors=None)["input_ids"]

    model = load_model(
        args.model, dtype=torch.bfloat16,
        runtime_format=args.runtime_format, device=device,
    )
    ppl = perplexity(model, ids, seq_len=args.seq_len, progress=True)
    print(f"perplexity: {ppl:.4f} ({len(ids)} tokens, "
          f"ctx {args.seq_len})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
