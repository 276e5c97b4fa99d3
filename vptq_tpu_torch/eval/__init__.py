"""Evaluation of the port: perplexity (``ppl``), zero-shot QA (``qa``),
the corpora (``datasets``) and reconstruction diagnostics
(``diagnostics``)."""

from vptq_tpu_torch.eval.ppl import perplexity
from vptq_tpu_torch.eval.qa import evaluate_qa, load_task

__all__ = ["perplexity", "evaluate_qa", "load_task"]
