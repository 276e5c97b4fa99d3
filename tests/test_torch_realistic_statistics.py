"""The port against vptq_tpu on the synthetic writers' two options: a
VQ-quantized lm_head (``vq_lm_head``) and heavy-tailed weights
(``heavy_tailed``). The ports of ``tests/test_calibrate.py``'s
``test_calibrated_vq_lm_head_converted`` and
``test_mixed_formats_on_realistic_statistics``.

* A checkpoint whose lm_head is a VQ layer: loaded as codebook, int8 and
  int4 by both packages (f32), the lm_head of the port's kind (VQLinear,
  Int8Linear, Int4Linear) and the logits within ``HEAD_TOL`` of max of
  JAX's (measured: 1.2e-6 codebook, 4e-8 int8, 0 int4); the calibrated
  int4-mixed load converts the lm_head to ``Int4Linear``, in both.
* Heavy-tailed weights (Student-t(4) marginals, lognormal channel scales,
  boosted outlier channels): the calibrated int3-mixed and int2-mixed
  beat plain int3 and int2 in logit KL against the exact model, in the
  port as in JAX, and each KL is within ``KL_RTOL`` of JAX's (measured:
  int3 2.4e-5 and int2 9.4e-6 relative, the same codes summed in another
  order; int3-mixed 2.8e-4 and int2-mixed 5.9e-5, GPTQ's codes as well,
  of which ``tests/test_torch_gptq.py`` lets 0.1% differ).

JAX runs with its Pallas kernels in interpret mode and its numpy
encoders, as the port's plain versions compute.
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vptq_tpu import native
from vptq_tpu.models import load_model as j_load_model
from vptq_tpu.models.llama import forward as j_forward
from vptq_tpu.models.llama import init_cache as j_init_cache
from vptq_tpu.quant.calibrate import (
    synthetic_calibration_tokens as j_calibration_tokens,
)
from vptq_tpu_torch.examples.fidelity_gauntlet import kl
from vptq_tpu_torch.layers.runtime import Int4Linear, Int8Linear
from vptq_tpu_torch.layers.vqlinear import VQLinear
from vptq_tpu_torch.models.llama import forward, init_cache
from vptq_tpu_torch.models.loader import load_model
from vptq_tpu_torch.quant.calibrate import synthetic_calibration_tokens
from vptq_tpu_torch.utils import synth_checkpoint as tsc

# logits against JAX's, max |diff| <= HEAD_TOL * max |logit|
HEAD_TOL = {"codebook": 1e-4, "int8": 1e-2, "int4": 1e-2}
# a KL against JAX's, |port - JAX| <= KL_RTOL * JAX: RTN's codes, then
# the calibrated ones
KL_RTOL = (2e-4, 5e-3)
HEAD_KINDS = {"codebook": VQLinear, "int8": Int8Linear, "int4": Int4Linear}


@pytest.fixture(scope="module", autouse=True)
def jax_pallas():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "_lib", lambda: None)
        mp.setattr(sys.modules["vptq_tpu.ops.quant_matmul"], "_IMPL", "pallas")
        mp.setenv("VPTQ_TPU_PALLAS_INTERPRET", "1")
        yield
        jax.clear_caches()


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("realistic"))


def _logits(model, tokens: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(tokens.astype(np.int64))
    cache = init_cache(model.cfg, t.shape[0], t.shape[1] + 8, torch.float32,
                       "cpu")
    logits, _ = forward(model, t, cache, dtype=torch.float32)
    return logits.double().numpy()


def _j_logits(model, tokens: np.ndarray) -> np.ndarray:
    cache = j_init_cache(model.cfg, tokens.shape[0], tokens.shape[1] + 8,
                         jnp.float32)
    logits, _ = j_forward(model, jnp.asarray(tokens, jnp.int32), cache,
                          dtype=jnp.float32)
    return np.asarray(logits, np.float64)


@functools.lru_cache(maxsize=None)
def _vq_head_checkpoint(root: str) -> str:
    path = f"{root}/vq_head"
    tsc.write_synthetic_checkpoint(
        path, tsc.tiny_model_config(tie_word_embeddings=False),
        vq_kwargs=dict(vector_len=4, num_centroids=64, num_res_centroids=16,
                       enable_norm=True, is_indice_packed=True),
        seed=3, vq_lm_head=True,
    )
    return path


@pytest.mark.parametrize("fmt", sorted(HEAD_KINDS))
def test_vq_lm_head_loads_as_jax(workdir, fmt):
    path = _vq_head_checkpoint(workdir)
    model = load_model(path, dtype=torch.float32, runtime_format=fmt,
                       device="cpu")
    jmodel = j_load_model(path, dtype=jnp.float32, runtime_format=fmt)
    assert type(model.lm_head) is HEAD_KINDS[fmt]
    assert type(jmodel.lm_head).__name__ == HEAD_KINDS[fmt].__name__
    tokens = np.random.default_rng(5).integers(0, model.cfg.vocab_size,
                                               (2, 16))
    got, want = _logits(model, tokens), _j_logits(jmodel, tokens)
    gap = np.abs(got - want).max() / np.abs(want).max()
    assert gap <= HEAD_TOL[fmt], (fmt, gap)


def test_calibrated_vq_lm_head_converted(workdir):
    """A calibrated load converts a VQ lm_head to its base format, as JAX's
    does, so that the vocabulary projection never pays the codebook
    gather."""
    path = _vq_head_checkpoint(workdir)
    model = load_model(path, runtime_format="int4-mixed", calibration=128,
                       device="cpu")
    jmodel = j_load_model(path, runtime_format="int4-mixed", calibration=128)
    assert type(model.lm_head) is Int4Linear
    assert type(jmodel.lm_head).__name__ == "Int4Linear"


MIXED = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
             num_hidden_layers=2, num_attention_heads=8,
             num_key_value_heads=4, head_dim=32)


@functools.lru_cache(maxsize=None)
def _heavy(root: str):
    """(checkpoint, tokens, the exact logits of the port, of JAX)."""
    path = f"{root}/heavy"
    tsc.write_synthetic_checkpoint(
        path, tsc.tiny_model_config(**MIXED),
        vq_kwargs=dict(vector_len=8, num_centroids=1024, num_res_centroids=64,
                       enable_norm=True, is_indice_packed=True),
        seed=3, heavy_tailed=True,
    )
    tokens = np.random.default_rng(5).integers(0, MIXED["vocab_size"], (2, 32))
    exact = load_model(path, dtype=torch.float32, runtime_format="codebook",
                       fuse=False, device="cpu")
    jexact = j_load_model(path, dtype=jnp.float32, runtime_format="codebook",
                          fuse=False)
    return path, tokens, _logits(exact, tokens), _j_logits(jexact, tokens)


@functools.lru_cache(maxsize=None)
def _kls(root: str, fmt: str):
    """(the port's KL, JAX's) of ``fmt`` against each one's exact model."""
    path, tokens, lcb, jlcb = _heavy(root)
    kwargs = {}
    jkwargs = {}
    if fmt.endswith("-mixed"):
        kwargs["calibration"] = synthetic_calibration_tokens(
            MIXED["vocab_size"], n_tokens=512, seq_len=256, seed=7)
        jkwargs["calibration"] = j_calibration_tokens(
            MIXED["vocab_size"], n_tokens=512, seq_len=256, seed=7)
        assert (kwargs["calibration"].numpy()
                == np.asarray(jkwargs["calibration"])).all()
    model = load_model(path, runtime_format=fmt, device="cpu", **kwargs)
    jmodel = j_load_model(path, runtime_format=fmt, **jkwargs)
    return kl(lcb, _logits(model, tokens)), kl(jlcb, _j_logits(jmodel, tokens))


@pytest.mark.parametrize("base", ["int3", "int2"])
def test_mixed_formats_on_realistic_statistics(workdir, base):
    """Per-column extraction still pays for itself on heavy-tailed
    weights, in the port as in JAX, with JAX's KLs."""
    plain, jplain = _kls(workdir, base)
    mixed, jmixed = _kls(workdir, f"{base}-mixed")
    assert jmixed < jplain, (jmixed, jplain)
    assert mixed < plain, (mixed, plain)
    for got, want, tol in ((plain, jplain, KL_RTOL[0]),
                           (mixed, jmixed, KL_RTOL[1])):
        assert abs(got - want) <= tol * want, (base, got, want)
