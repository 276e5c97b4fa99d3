"""The port's zero-shot QA harness against vptq_tpu's.

The task loaders give vptq_tpu's ``QAItem``s on tests/test_qa.py's
records; ``loglikelihoods`` is within 1e-4 of vptq_tpu's in f32 across
buckets, ragged batch tails and left truncation; ``evaluate_qa`` gives
the same ``acc``, ``acc_norm`` and ``n``; the QA command runs end to end
with ``--tokenizer byte`` and with an HF tokenizer directory.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_qa import _write, _write_toy_hf_tokenizer
from torch_port import TINY, VQ

from vptq_tpu import native
from vptq_tpu.eval import qa as jqa
from vptq_tpu.models import load_model as j_load_model
from vptq_tpu.utils import synth_checkpoint as jsc
from vptq_tpu_torch.eval import evaluate_qa as top_evaluate_qa
from vptq_tpu_torch.eval import load_task as top_load_task
from vptq_tpu_torch.eval import qa
from vptq_tpu_torch.models.loader import load_model

RECORDS = {
    "arc_easy": [
        {"question": "Which is a fruit?",
         "choices": {"text": ["apple", "rock", "chair"],
                     "label": ["A", "B", "C"]},
         "answerKey": "A"},
        {"question": "Pick the colour",
         "choices": {"text": ["red", "run"], "label": ["1", "2"]},
         "answerKey": "1"},
    ],
    "hellaswag": [
        {"activity_label": "Cooking", "ctx_a": "A person stirs a pot.",
         "ctx_b": "then they",
         "endings": ["serve the food.", "fly away. [title]"], "label": "0"},
        {"activity_label": "Sports", "ctx": "A man runs [header] fast.",
         "endings": ["and  wins.", "and sits."], "label": 1},
    ],
    "piqa": [{"goal": "open a jar", "sol1": "twist the lid",
              "sol2": "eat the jar", "label": 0}],
    "winogrande": [{"sentence": "The cup would not fit because _ was too "
                                "big.",
                    "option1": "the cup", "option2": "the shelf",
                    "answer": "1"}],
}


@pytest.mark.parametrize("jsonl", [True, False])
@pytest.mark.parametrize("task", sorted(RECORDS))
def test_task_loaders_give_jax_items(tmp_path, task, jsonl):
    path = tmp_path / "records"
    _write(path, RECORDS[task], jsonl=jsonl)
    got = qa.load_task(task, str(path))
    want = jqa.load_task(task, str(path))
    assert [vars(g) for g in got] == [vars(w) for w in want]
    assert qa.TASK_METRIC == jqa.TASK_METRIC
    assert sorted(qa.TASKS) == sorted(jqa.TASKS)
    assert top_load_task is qa.load_task


def test_unknown_task_is_refused(tmp_path):
    with pytest.raises(ValueError, match="unknown task"):
        qa.load_task("mmlu", str(tmp_path / "x"))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_qa_ckpt")
    jsc.write_synthetic_checkpoint(
        str(d), jsc.tiny_model_config(**dict(TINY, tie_word_embeddings=False)),
        vq_kwargs=VQ, seed=13)
    return str(d)


@pytest.fixture(scope="module")
def jax_pallas():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "_lib", lambda: None)
        mp.setattr(sys.modules["vptq_tpu.ops.quant_matmul"], "_IMPL",
                   "pallas")
        mp.setenv("VPTQ_TPU_PALLAS_INTERPRET", "1")
        yield
    jax.clear_caches()


def _models(ckpt, fmt):
    return (
        j_load_model(ckpt, dtype=jnp.float32, runtime_format=fmt),
        load_model(ckpt, dtype=torch.float32, runtime_format=fmt,
                   device="cpu"),
    )


@pytest.mark.parametrize("fmt,atol,rtol", [("bf16", 1e-4, 0.0),
                                           ("int8", 0.0, 1e-4)])
def test_loglikelihoods_match_jax(ckpt, jax_pallas, fmt, atol, rtol):
    """Buckets 32 to 128, ragged tails of batch 3, a one-token context and
    continuation, and a context cut from the left to fit ``max_seq``.

    In the bf16 format (f32 products) within 1e-4 absolute. int8's K1 and
    its Pallas twin round x to bf16: the packages' f32 sums before it
    differ in their last bits (~1e-7 relative), and the few elements of an
    x that lie on a bf16 rounding edge go to the other neighbour in one of
    them (3 of layer 1's o_proj inputs at 64 tokens), so the pairs' sums
    are held to 1e-4 relative (~3e-5 seen)."""
    jmodel, tmodel = _models(ckpt, fmt)
    rng = np.random.default_rng(3)
    V = TINY["vocab_size"]
    pairs = [
        (rng.integers(0, V, c).tolist(), rng.integers(0, V, t).tolist())
        for c, t in [(5, 3), (1, 1), (0, 1), (30, 4), (40, 25), (2, 60),
                     (7, 2), (33, 31), (150, 9)]
    ]
    want = jqa.loglikelihoods(jmodel, pairs, batch=3, max_seq=128,
                              dtype=jnp.float32)
    got = qa.loglikelihoods(tmodel, pairs, batch=3, max_seq=128,
                            dtype=torch.float32)
    assert got.dtype == np.float64 and got.shape == (len(pairs),)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    # every forward call: the rows of one bucket, at most ``batch``
    calls = [(S, len(rows)) for S, rows in
             qa._batches(qa._prepared(pairs, 128), 3)]
    assert calls == [(32, 3), (32, 1), (64, 3), (64, 1), (128, 1)]
    with pytest.raises(ValueError, match="empty continuation"):
        qa.loglikelihoods(tmodel, [([1, 2], [])])


def test_evaluate_qa_matches_jax(ckpt, jax_pallas):
    """acc, acc_norm and n of the same items, the gold answers set so that
    both metrics are neither 0 nor 1."""
    jmodel, tmodel = _models(ckpt, "int8")

    def tok(text):
        return [b % TINY["vocab_size"] for b in text.encode()]

    rng = np.random.default_rng(5)
    items = []
    for i in range(6):
        n = 2 + i % 3
        items.append(qa.QAItem(
            context=f"Question {i}: which {'ab' * i}?\nAnswer:",
            choices=[" " + "xy" * int(k) for k in rng.integers(1, 6, n)],
            gold=int(rng.integers(0, n)),
        ))
    items.append(qa.QAItem(context="", choices=[" end.", " end."], gold=1,
                           contexts=["Alpha beta", "Gamma delta epsilon"]))
    jitems = [jqa.QAItem(**vars(it)) for it in items]
    want = jqa.evaluate_qa(jmodel, jitems, tok, batch=4, max_seq=64,
                           dtype=jnp.float32)
    got = qa.evaluate_qa(tmodel, items, tok, batch=4, max_seq=64,
                         dtype=torch.float32)
    assert got == want
    assert want["n"] == 7 and 0 < want["acc"] < 1
    assert top_evaluate_qa is qa.evaluate_qa


ARC = [
    {"question": f"Pick one ({i}) of the {'long ' * i}list",
     "choices": {"text": ["aa", "bb", "a much longer answer"],
                 "label": ["A", "B", "C"]},
     "answerKey": "ABC"[i % 3]}
    for i in range(5)
]


@pytest.mark.parametrize("tokenizer", ["byte", "hf"])
def test_qa_cli_matches_jax(ckpt, jax_pallas, tmp_path, capsys, tokenizer):
    """``python -m vptq_tpu_torch.eval.qa`` end to end: the same printed
    lines as vptq_tpu's command, with raw bytes and with an HF
    tokenizer directory (``AutoTokenizer``)."""
    _write(tmp_path / "arc.jsonl", ARC, jsonl=True)
    tok = ("byte" if tokenizer == "byte"
           else str(_write_toy_hf_tokenizer(tmp_path / "tok")))
    argv = ["--model", ckpt, "--task", "arc_easy",
            "--data", str(tmp_path / "arc.jsonl"), "--tokenizer", tok,
            "--runtime-format", "int8", "--batch", "2", "--max-seq", "64",
            "--limit", "4"]
    assert jqa.main(argv) == 0
    want = capsys.readouterr().out
    assert qa.main([*argv, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert "arc_easy: acc" in got
    assert "headline metric = acc_norm" in got
    assert "(4 items;" in got
    assert got == want
