"""Zero-shot QA evaluation by loglikelihood comparison.

Port of ``vptq_tpu/eval/qa.py``: the lm-evaluation-harness protocol
behind the reference's AvgQA column (reference README.md:272-279). For
each question the summed log-probability of every answer choice,
conditioned on the context, is scored and the argmax picked. Requests
are grouped into length buckets (powers of two from 32 up to
``max_seq``) and scored by one fresh-cache batched forward per group of
``batch`` rows, on the model's device. Loaders read the reference task
set (ARC-Easy/Challenge, HellaSwag, PIQA, WinoGrande) from local JSON /
JSONL files, so the harness runs offline.

Metrics per task:
  * ``acc``       — argmax of the raw summed logprob,
  * ``acc_norm``  — argmax of logprob / continuation byte-length.
:data:`TASK_METRIC` names the headline metric of each task (``acc_norm``
for arc / hellaswag / piqa, ``acc`` for winogrande).

CLI:
    python -m vptq_tpu_torch.eval.qa --model DIR --task arc_easy \
        --data FILE.jsonl [--tokenizer DIR|byte] \
        [--runtime-format int8] [--limit N] [--device cuda|cpu]

``--tokenizer byte`` maps text to raw UTF-8 bytes (ids 0-255) for
fixture and smoke runs without a real tokenizer; any other value is read
by ``transformers``' ``AutoTokenizer``, imported only then.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from vptq_tpu_torch.models.llama import Model, forward, init_cache

__all__ = [
    "QAItem",
    "TASKS",
    "TASK_METRIC",
    "load_task",
    "loglikelihoods",
    "evaluate_qa",
]


@dataclass
class QAItem:
    """One multiple-choice request: pick argmax_i ll(choices[i] | context).

    ``contexts``: optional per-choice contexts (WinoGrande's partial
    evaluation — the option fills the blank inside the context and the
    scored continuation is the shared suffix); overrides ``context``.
    """

    context: str
    choices: List[str]
    gold: int
    contexts: List[str] = None


# headline metric per task (the lm-eval convention used by the
# quantization papers the reference compares against)
TASK_METRIC: Dict[str, str] = {
    "arc_challenge": "acc_norm",
    "arc_easy": "acc_norm",
    "hellaswag": "acc_norm",
    "piqa": "acc_norm",
    "winogrande": "acc",
}


# ---------------------------------------------------------------------------
# task loaders (datasets-library record layouts, offline JSON/JSONL)
# ---------------------------------------------------------------------------


def _read_records(path: str) -> List[dict]:
    with open(path) as f:
        head = f.read(1)
        f.seek(0)
        if head == "[":
            return json.load(f)
        return [json.loads(line) for line in f if line.strip()]


def _load_arc(records: Sequence[dict]) -> List[QAItem]:
    """allenai/ai2_arc rows: question / choices{text,label} / answerKey."""
    items = []
    for r in records:
        labels = list(r["choices"]["label"])
        items.append(
            QAItem(
                context=f"Question: {r['question']}\nAnswer:",
                choices=[" " + t for t in r["choices"]["text"]],
                gold=labels.index(r["answerKey"]),
            )
        )
    return items


def _hellaswag_preprocess(text: str) -> str:
    """The harness's light detokenization for HellaSwag fields."""
    text = text.strip().replace(" [title]", ". ")
    text = re.sub(r"\[.*?\]", "", text)
    return text.replace("  ", " ")


def _load_hellaswag(records: Sequence[dict]) -> List[QAItem]:
    """Rowan/hellaswag rows: activity_label / ctx_a / ctx_b / ctx /
    endings / label."""
    items = []
    for r in records:
        ctx = r.get("ctx") or (
            r.get("ctx_a", "") + " " + r.get("ctx_b", "")
        )
        if r.get("ctx_b"):
            ctx = r.get("ctx_a", "") + " " + r["ctx_b"].capitalize()
        query = _hellaswag_preprocess(
            r.get("activity_label", "") + ": " + ctx
        )
        items.append(
            QAItem(
                context=query,
                choices=[
                    " " + _hellaswag_preprocess(e) for e in r["endings"]
                ],
                gold=int(r["label"]),
            )
        )
    return items


def _load_piqa(records: Sequence[dict]) -> List[QAItem]:
    """ybisk/piqa rows: goal / sol1 / sol2 / label."""
    return [
        QAItem(
            context=f"Question: {r['goal']}\nAnswer:",
            choices=[" " + r["sol1"], " " + r["sol2"]],
            gold=int(r["label"]),
        )
        for r in records
    ]


def _load_winogrande(records: Sequence[dict]) -> List[QAItem]:
    """allenai/winogrande rows: sentence (with "_") / option1 /
    option2 / answer ("1"|"2").

    Partial-evaluation protocol: the option fills the blank, so the
    CONTEXT varies per choice while the scored continuation is the
    (shared) text after the blank.
    """
    items = []
    for r in records:
        sent = r["sentence"]
        cut = sent.index("_")
        suffix = sent[cut + 1:]
        items.append(
            QAItem(
                context="",
                choices=[suffix, suffix],
                gold=int(r["answer"]) - 1,
                contexts=[
                    sent[:cut] + r["option1"],
                    sent[:cut] + r["option2"],
                ],
            )
        )
    return items


TASKS: Dict[str, Callable[[Sequence[dict]], List[QAItem]]] = {
    "arc_challenge": _load_arc,
    "arc_easy": _load_arc,
    "hellaswag": _load_hellaswag,
    "piqa": _load_piqa,
    "winogrande": _load_winogrande,
}


def load_task(task: str, path: str) -> List[QAItem]:
    """Parse ``path`` (JSON array or JSONL) with the ``task`` layout."""
    if task not in TASKS:
        raise ValueError(f"unknown task {task!r}; choices: {sorted(TASKS)}")
    return TASKS[task](_read_records(path))




# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------


def _batch_ll(
    model: Model,
    inp: torch.Tensor,
    tgt: torch.Tensor,
    mask: torch.Tensor,
    dtype=torch.bfloat16,
) -> torch.Tensor:
    """Summed continuation logprob per row.

    ``inp``/``tgt`` are the (B, S) shifted token windows; ``mask``
    marks target positions belonging to the continuation. One fresh-
    cache forward scores the whole batch (no KV reuse: each request is
    independent); a fresh chunk of 1024 tokens or more in bf16 attends
    through K8 (``llama.takes_flash``).
    """
    cache = init_cache(model.cfg, inp.shape[0], inp.shape[1], dtype,
                       inp.device)
    logits, _ = forward(model, inp, cache, dtype=dtype, fresh_prefill=True)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    tok_lp = torch.gather(logp, -1, tgt[..., None])[..., 0]
    return torch.sum(tok_lp * mask, dim=1)


def _buckets(max_seq: int) -> List[int]:
    """Powers of two from 32 below ``max_seq``, then ``max_seq``."""
    buckets = []
    b = 32
    while b < max_seq:
        buckets.append(b)
        b *= 2
    buckets.append(max_seq)
    return buckets


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(
        f"sequence of {n} tokens exceeds the largest bucket "
        f"{buckets[-1]}; raise --max-seq"
    )


def _prepared(pairs: Sequence, max_seq: int) -> List[tuple]:
    """(bucket, inp, tgt, mask, index) of each (context, continuation)
    pair: the context truncated from the LEFT to fit ``max_seq`` (harness
    convention; the continuation never is), shifted, right-padded to its
    bucket."""
    buckets = _buckets(max_seq)
    prepared = []
    for idx, (ctx, cont) in enumerate(pairs):
        ctx = list(ctx)
        cont = list(cont)
        if not cont:
            raise ValueError(f"empty continuation for request {idx}")
        if len(ctx) + len(cont) > max_seq:
            ctx = ctx[-(max_seq - len(cont)):]
        full = ctx + cont
        # BOS-less windows: the first context token is the model input
        # at position 0; scoring starts at the first continuation
        # target. A context of 0/1 tokens still works (the first
        # continuation token is conditioned on what's there).
        inp, tgt = full[:-1], full[1:]
        if not inp:
            # single-token continuation with empty context: score it
            # unconditionally behind a pad-0 prompt
            inp, tgt = [0], full
        mask_start = max(len(ctx) - 1, 0)
        S = _bucket(len(inp), buckets)
        pad = S - len(inp)
        mask = np.zeros(S, np.float32)
        mask[mask_start: len(tgt)] = 1.0
        prepared.append(
            (
                S,
                np.pad(np.asarray(inp, np.int64), (0, pad)),
                np.pad(np.asarray(tgt, np.int64), (0, pad)),
                mask,
                idx,
            )
        )
    return prepared


def _batches(prepared: Sequence[tuple], batch: int):
    """(bucket, rows) of each forward call: the rows of one bucket in
    groups of at most ``batch``, buckets in increasing order."""
    by_bucket: Dict[int, List] = {}
    for row in prepared:
        by_bucket.setdefault(row[0], []).append(row)
    for S, rows in sorted(by_bucket.items()):
        for i in range(0, len(rows), batch):
            yield S, rows[i: i + batch]


@torch.inference_mode()
def loglikelihoods(
    model: Model,
    pairs: Sequence,
    batch: int = 8,
    max_seq: int = 2048,
    dtype=torch.bfloat16,
    progress: bool = False,
) -> np.ndarray:
    """Summed logprob of each (context_tokens, continuation_tokens) pair.

    Pairs are grouped by length bucket (powers of two up to
    ``max_seq``) and padded to a fixed ``batch`` of rows. Contexts
    longer than the bucket cap are truncated from the LEFT (harness
    convention); the continuation is never truncated. Runs on the
    model's device.
    """
    device = model.embed_tokens.device
    prepared = _prepared(pairs, max_seq)
    out = np.zeros(len(prepared), np.float64)
    done = 0
    for S, chunk in _batches(prepared, batch):
        n = len(chunk)
        pad_rows = batch - n
        inp = np.stack([r[1] for r in chunk])
        tgt = np.stack([r[2] for r in chunk])
        mask = np.stack([r[3] for r in chunk])
        if pad_rows:
            inp = np.pad(inp, ((0, pad_rows), (0, 0)))
            tgt = np.pad(tgt, ((0, pad_rows), (0, 0)))
            mask = np.pad(mask, ((0, pad_rows), (0, 0)))
        ll = _batch_ll(
            model,
            torch.from_numpy(inp).to(device),
            torch.from_numpy(tgt).to(device),
            torch.from_numpy(mask).to(device),
            dtype,
        ).cpu().numpy()
        for j, r in enumerate(chunk):
            out[r[4]] = float(ll[j])
        done += n
        if progress:
            print(
                f"scored {done}/{len(prepared)} "
                f"(bucket {S}, batch {batch})",
                flush=True,
            )
    return out


def _pairs(items: Sequence[QAItem], tokenize: Callable[[str], List[int]]):
    """The (context, continuation) token pairs of every choice of every
    item, and each continuation's byte length."""
    pairs = []
    lens = []
    for it in items:
        shared = tokenize(it.context) if it.context else []
        for i, c in enumerate(it.choices):
            ctx_toks = (
                tokenize(it.contexts[i]) if it.contexts else shared
            )
            cont = tokenize(c)
            pairs.append((ctx_toks, cont))
            lens.append(len(c.encode("utf-8")))
    return pairs, lens


def evaluate_qa(
    model: Model,
    items: Sequence[QAItem],
    tokenize: Callable[[str], List[int]],
    batch: int = 8,
    max_seq: int = 2048,
    dtype=torch.bfloat16,
    progress: bool = False,
) -> Dict[str, float]:
    """Run the loglikelihood-comparison protocol over ``items``.

    ``tokenize`` maps text to token ids WITHOUT special tokens; the
    continuation tokenization must compose (ctx + cont tokenized
    separately), which holds for BPE tokenizers when the continuation
    starts with a space; the task loaders ensure it.
    """
    pairs, lens = _pairs(items, tokenize)
    ll = loglikelihoods(
        model, pairs, batch=batch, max_seq=max_seq, dtype=dtype,
        progress=progress,
    )

    acc = acc_norm = 0
    pos = 0
    for it in items:
        n = len(it.choices)
        scores = ll[pos: pos + n]
        blen = np.asarray(lens[pos: pos + n], np.float64)
        pos += n
        if int(np.argmax(scores)) == it.gold:
            acc += 1
        if int(np.argmax(scores / np.maximum(blen, 1.0))) == it.gold:
            acc_norm += 1
    n_items = max(len(items), 1)
    return {
        "acc": acc / n_items,
        "acc_norm": acc_norm / n_items,
        "n": len(items),
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _byte_tokenizer(text: str) -> List[int]:
    return list(text.encode("utf-8"))


def main(argv=None) -> int:
    import argparse

    from vptq_tpu_torch.models.loader import entry_device, load_model

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", required=True)
    p.add_argument("--task", required=True, choices=sorted(TASKS))
    p.add_argument(
        "--data", required=True,
        help="task records as JSON array or JSONL (datasets-library "
        "field layout; see the loaders in eval/qa.py)",
    )
    p.add_argument(
        "--tokenizer", default="",
        help="HF tokenizer dir (default: --model dir); 'byte' = raw "
        "UTF-8 bytes for fixture/smoke runs",
    )
    p.add_argument(
        "--runtime-format", default="int8",
        choices=(
            "int8", "int4", "int4-mixed", "int3", "int3-mixed",
            "int2", "int2-mixed",
            "bf16", "codebook",
        ),
    )
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--max-seq", type=int, default=2048)
    p.add_argument("--limit", type=int, default=0,
                   help="evaluate only the first N records")
    p.add_argument("--device", default="cuda",
                   help="where the model runs (cuda or cpu)")
    args = p.parse_args(argv)
    device = entry_device(args.device)

    if args.tokenizer == "byte":
        tokenize = _byte_tokenizer
    else:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(args.tokenizer or args.model)

        def tokenize(text: str) -> List[int]:
            return tok(text, add_special_tokens=False)["input_ids"]

    items = load_task(args.task, args.data)
    if args.limit:
        items = items[: args.limit]

    model = load_model(
        args.model, dtype=torch.bfloat16,
        runtime_format=args.runtime_format, device=device,
    )
    res = evaluate_qa(
        model, items, tokenize, batch=args.batch,
        max_seq=args.max_seq, progress=True,
    )
    headline = TASK_METRIC[args.task]
    print(
        f"{args.task}: acc {res['acc']:.4f}  acc_norm "
        f"{res['acc_norm']:.4f}  ({res['n']} items; headline metric "
        f"= {headline} -> {res[headline]:.4f})"
    )
    print(
        "reference AvgQA anchors (README.md:272-279): 7B@2.02 58.2, "
        "13B@2.02 62.4, 70B@2.07 68.6"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
