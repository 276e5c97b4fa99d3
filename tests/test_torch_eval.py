"""The port's perplexity, corpora and reconstruction diagnostics against
vptq_tpu's.

* ``perplexity``: within 1e-5 relative of vptq_tpu's in f32 and 1e-3 in
  bf16, at ``seq_len`` 20 over whole windows and under the tail rule
  (a stream shorter than one window is scored whole; a tail after whole
  windows is dropped), and the CLI on a text file;
* ``load_eval_tokens`` on a stand-in ``datasets`` module (the corpora
  are downloaded in no test);
* ``reconstruction_error`` and ``model_reconstruction_report`` within
  1e-6 relative of vptq_tpu's, with the same keys and formats, for int8,
  int4, int3, bf16 and codebook models (fused q|k|v and gate|up against
  the reference's parts).

The JAX side runs its int8 / int4 kernels in Pallas interpret mode, as a
TPU would, and its numpy encoders.
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port import TINY, VQ, port_layer

from vptq_tpu import native
from vptq_tpu.eval import datasets as jdatasets
from vptq_tpu.eval import diagnostics as jdiag
from vptq_tpu.eval import ppl as jppl
from vptq_tpu.models import load_model as j_load_model
from vptq_tpu.utils import synth_checkpoint as jsc
from vptq_tpu.utils.synth import make_config, make_layer, make_numpy_planes
from vptq_tpu_torch.eval import datasets, diagnostics, ppl
from vptq_tpu_torch.eval import perplexity as top_perplexity
from vptq_tpu_torch.models.loader import load_model
from vptq_tpu_torch.utils.synth_tokenizer import write_byte_tokenizer

CFG = dict(TINY, vocab_size=272, tie_word_embeddings=False)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_eval_ckpt")
    jsc.write_synthetic_checkpoint(
        str(d), jsc.tiny_model_config(**CFG), vq_kwargs=VQ, seed=11)
    write_byte_tokenizer(str(d), vocab_size=272)
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


def _ids(n, seed=2):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], n)


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5),
                                        ("bfloat16", 1e-3)])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_perplexity_matches_jax(ckpt, jax_pallas, fmt, dtype, rtol):
    jmodel = j_load_model(ckpt, dtype=getattr(jnp, dtype),
                          runtime_format=fmt)
    tmodel = load_model(ckpt, dtype=getattr(torch, dtype),
                        runtime_format=fmt, device="cpu")
    # two whole windows; two and a dropped tail of 5; one short stream
    for n in (40, 45, 15):
        ids = _ids(n)
        want = jppl.perplexity(jmodel, ids, seq_len=20,
                               dtype=getattr(jnp, dtype))
        got = ppl.perplexity(tmodel, ids, seq_len=20,
                             dtype=getattr(torch, dtype))
        assert abs(got - want) <= rtol * want, (n, got, want)
    assert top_perplexity is ppl.perplexity


def test_perplexity_tail_rule_and_refusals(ckpt):
    tmodel = load_model(ckpt, dtype=torch.float32, runtime_format="bf16",
                        device="cpu")
    ids = _ids(45)
    # the tail after whole windows is dropped
    assert ppl.perplexity(tmodel, ids, seq_len=20, dtype=torch.float32) == (
        ppl.perplexity(tmodel, ids[:40], seq_len=20, dtype=torch.float32))
    # a window is one fresh forward: its NLL over the window's 19 targets
    nll, cnt = ppl.window_nll(tmodel, torch.from_numpy(ids[:20])[None],
                              torch.float32)
    assert cnt == 19
    assert ppl.perplexity(tmodel, ids[:20], seq_len=20,
                          dtype=torch.float32) == pytest.approx(
        np.exp(nll / cnt), rel=1e-12)
    with pytest.raises(ValueError, match="1-D"):
        ppl.perplexity(tmodel, ids.reshape(5, 9), seq_len=20)
    with pytest.raises(ValueError, match="not enough tokens"):
        ppl.perplexity(tmodel, ids[:1], seq_len=20)


def test_ppl_cli_matches_jax(ckpt, jax_pallas, tmp_path, capsys):
    text = tmp_path / "text.txt"
    text.write_text("the quick brown fox jumps over the lazy dog. " * 3)
    argv = ["--model", ckpt, "--text", str(text), "--seq-len", "32"]
    assert jppl.main(argv) == 0
    want = capsys.readouterr().out.splitlines()
    assert ppl.main([*argv, "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 5  # four windows, then the result
    assert got[-1].split("(")[1] == want[-1].split("(")[1]
    value = [float(line.split(": ")[1].split()[0]) for line in
             (got[-1], want[-1])]
    assert value[0] == pytest.approx(value[1], rel=1e-3)


def _fake_datasets():
    fake = types.ModuleType("datasets")

    def fake_load_dataset(name, config, split, streaming=False,
                          cache_dir=None):
        if name == "wikitext":
            assert (config, split) == ("wikitext-2-raw-v1", "test")
            return {"text": ["doc one", "", "doc two"]}
        assert (name, config, split) == ("allenai/c4", "en", "validation")
        assert streaming
        return iter({"text": f"c4 doc {i}"} for i in range(10))

    fake.load_dataset = fake_load_dataset
    return fake


class _Tok:
    def __call__(self, text, return_tensors=None):
        return {"input_ids": [len(w) for w in text.split()]}


def test_dataset_loaders_protocol(monkeypatch):
    """wikitext2 / c4: documents joined with blank lines, tokenized once,
    as vptq_tpu's loaders do (a stand-in ``datasets`` module)."""
    monkeypatch.setitem(sys.modules, "datasets", _fake_datasets())
    for name, kwargs, n in (("wikitext2", {}, 4), ("c4", {"c4_docs": 3}, 9)):
        got = datasets.load_eval_tokens(name, _Tok(), **kwargs)
        want = jdatasets.load_eval_tokens(name, _Tok(), **kwargs)
        assert got.dtype == np.int32 and len(got) == n
        np.testing.assert_array_equal(got, want)
    assert datasets.EVAL_DATASETS == jdatasets.EVAL_DATASETS
    with pytest.raises(ValueError):
        datasets.load_eval_tokens("ptb", _Tok())


def test_dataset_loader_names_the_missing_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(ImportError, match="--text FILE"):
        datasets.load_eval_tokens("wikitext2", _Tok())


def _close(got, want, rtol=1e-6):
    assert got == pytest.approx(want, rel=rtol, abs=1e-30)


@pytest.mark.parametrize("hessian", [False, True])
def test_reconstruction_error_matches_jax(hessian):
    cfg = make_config(in_features=64, out_features=32, vector_len=4,
                      num_centroids=32)
    planes = make_numpy_planes(cfg, seed=6)
    tlayer = port_layer(planes, cfg)
    jlayer = make_layer(cfg, seed=6)
    w = np.asarray(jdiag._exact_weight(jlayer), np.float32)
    rng = np.random.default_rng(1)
    h = None
    if hessian:
        x = rng.standard_normal((128, 64)).astype(np.float32)
        h = x.T @ x / 128
    for orig in (w, w + 0.1, w + rng.standard_normal(w.shape).astype(
            np.float32) * 0.05):
        got = diagnostics.reconstruction_error(tlayer, orig, h)
        want = jdiag.reconstruction_error(jlayer, orig, h)
        assert got.keys() == want.keys()
        for k in want:
            _close(got[k], want[k])
    # perfect reconstruction -> zero error
    assert diagnostics.reconstruction_error(tlayer, w)["error_mean"] < 1e-10


@pytest.mark.parametrize("fmt", ["int8", "int4", "int3", "bf16", "codebook"])
def test_reconstruction_report_matches_jax(ckpt, jax_pallas, fmt):
    jmodel = j_load_model(ckpt, dtype=jnp.float32, runtime_format=fmt)
    jref = j_load_model(ckpt, dtype=jnp.float32, runtime_format="codebook",
                        fuse=False)
    tmodel = load_model(ckpt, dtype=torch.float32, runtime_format=fmt,
                        device="cpu")
    tref = load_model(ckpt, dtype=torch.float32, runtime_format="codebook",
                      fuse=False, device="cpu")
    want = jdiag.model_reconstruction_report(jmodel, jref)
    got = diagnostics.model_reconstruction_report(tmodel, tref)
    assert list(got) == list(want)
    fused = fmt != "codebook"
    assert ("layers.0.attn.qkv_proj" in got) == fused
    assert ("layers.1.mlp.gate_up_proj" in got) == fused
    assert "lm_head" in got
    for name, w in want.items():
        g = got[name]
        assert g.keys() == w.keys() and g["format"] == w["format"]
        for k in ("rel_rms", "max_abs_err", "ref_rms"):
            _close(g[k], w[k])
    summary = diagnostics.summarize_report(got)
    want_summary = jdiag.summarize_report(want)
    assert summary["n_layers"] == want_summary["n_layers"]
    for k in ("mean_rel_rms", "worst_rel_rms"):
        _close(summary[k], want_summary[k])
    if fmt == "codebook":
        assert summary["worst_rel_rms"] == 0.0


def test_runtime_weight_takes_what_vptq_tpu_takes(ckpt):
    model = load_model(ckpt, dtype=torch.float32, runtime_format="int2",
                       device="cpu")
    with pytest.raises(TypeError, match="Int2Linear"):
        diagnostics.runtime_weight(model.blocks[0].attn.qkv_proj)
    assert diagnostics.runtime_weight(None) is None
    assert diagnostics.summarize_report({}) == {"n_layers": 0}
