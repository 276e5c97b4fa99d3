"""Evaluation-corpus loaders for the reference PPL protocol.

Port of ``vptq_tpu/eval/datasets.py``. The reference's published
accuracy anchor is WikiText-2 / C4 perplexity at context 4096
(reference README.md:266-279, BASELINE.md), on this protocol:

  * ``wikitext2``: the raw test split, documents joined with "\\n\\n",
    tokenized as one stream (the GPTQ/AQLM convention the reference's
    tech report follows).
  * ``c4``: the first ``c4_docs`` documents of the ``en`` validation
    split joined the same way (the full split is ~45 GB; the standard
    eval uses a prefix).

Needs the ``datasets`` package and network access on first use, so the
import is deferred to the call and its error says what to do instead:

    python -m vptq_tpu_torch.eval.ppl --model DIR --dataset wikitext2
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["load_eval_tokens", "EVAL_DATASETS"]

EVAL_DATASETS = ("wikitext2", "c4")


def _require_datasets():
    try:
        import datasets  # noqa: F401

        return datasets
    except ImportError as e:  # pragma: no cover - env-dependent
        raise ImportError(
            "the PPL dataset loaders need the `datasets` package "
            "(pip install datasets) and network access on first "
            "download; offline, pass --text FILE instead"
        ) from e


def load_eval_tokens(
    dataset: str,
    tokenizer,
    c4_docs: int = 2000,
    cache_dir: Optional[str] = None,
) -> np.ndarray:
    """Tokenized evaluation stream (1-D int32) for ``dataset``.

    ``tokenizer``: a HF tokenizer (``AutoTokenizer``). Joins documents
    with "\\n\\n" and tokenizes once, the protocol behind the reference's
    published numbers (see the module docstring).
    """
    if dataset not in EVAL_DATASETS:
        raise ValueError(
            f"unknown dataset {dataset!r}; choices: {EVAL_DATASETS}"
        )
    ds = _require_datasets()
    if dataset == "wikitext2":
        split = ds.load_dataset(
            "wikitext", "wikitext-2-raw-v1", split="test",
            cache_dir=cache_dir,
        )
        text = "\n\n".join(split["text"])
    else:
        stream = ds.load_dataset(
            "allenai/c4", "en", split="validation", streaming=True,
            cache_dir=cache_dir,
        )
        docs = []
        for i, row in enumerate(stream):
            if i >= c4_docs:
                break
            docs.append(row["text"])
        text = "\n\n".join(docs)
    ids = tokenizer(text, return_tensors=None)["input_ids"]
    return np.asarray(ids, dtype=np.int32)
