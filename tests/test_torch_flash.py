"""K8 ``flash_attention`` and the long-prompt path against vptq_tpu.

* The plain version ``flash_attention_reference`` against the real TPU
  kernel (JAX's Pallas flash-attention op, the one ``vptq_tpu`` calls),
  run on the CPU in Pallas' TPU interpret mode, K/V repeated and
  transposed on the JAX side as ``vptq_tpu/models/llama.py`` does.
* The plain version against the port's own ``_cache_and_attend`` on an
  empty cache.
* ``forward(fresh_prefill=True)`` at 1024 tokens, and ``Generator`` on
  prompts past the 512 bucket and past the largest bucket, against
  vptq_tpu on one set of weights (``convert_params``). On the CPU the
  JAX package takes ``_cache_and_attend`` (its flash op is TPU-only).
  The port routes a long fresh chunk by dtype and head size alone, as on
  the card: bf16 at a head size K8 is built for takes the flash op,
  whose plain version runs on the CPU; f32, fp16 and other head sizes
  take ``_cache_and_attend``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import (
    flash_attention as j_flash_attention,
)
from torch_port import TINY, VQ, jax_params

from vptq_tpu.models import load_model as j_load_model
from vptq_tpu.models.llama import forward as j_forward
from vptq_tpu.models.llama import init_cache as j_init_cache
from vptq_tpu.serving.generate import Generator as JGenerator
from vptq_tpu_torch.convert import convert_params
from vptq_tpu_torch.models import llama as tl
from vptq_tpu_torch.ops.flash_attention import (
    HEAD_DIMS,
    flash_attention,
    flash_attention_reference,
    kernel_takes,
)
from vptq_tpu_torch.serving.generate import Generator
from vptq_tpu_torch.utils import synth_checkpoint as tsc


def _qkv(seed, seq, heads, kv_heads, dim, batch=1):
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal((batch, seq, n, dim)).astype(np.float32)
        for n in (heads, kv_heads, kv_heads)
    ]


def _torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _jnp(a, dtype):
    return jnp.asarray(a).astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq", [1024, 1280])
@pytest.mark.parametrize("dim", [64, 128])
def test_reference_matches_tpu_kernel(dim, seq, dtype):
    heads, kv_heads = 4, 2
    group = heads // kv_heads
    scale = dim ** -0.5
    q, k, v = _qkv(seq + dim, seq, heads, kv_heads, dim)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = j_flash_attention(
            _jnp(q, jd).transpose(0, 2, 1, 3),
            jnp.repeat(_jnp(k, jd), group, axis=2).transpose(0, 2, 1, 3),
            jnp.repeat(_jnp(v, jd), group, axis=2).transpose(0, 2, 1, 3),
            causal=True, sm_scale=scale,
        )
    want = np.asarray(
        want.transpose(0, 2, 1, 3).reshape(1, seq, heads * dim), np.float32
    )
    got = flash_attention_reference(
        _torch(q, td), _torch(k, td), _torch(v, td), scale
    )
    assert got.dtype == td and got.shape == (1, seq, heads * dim)
    # f32: summation order and exp rounding only. bf16: both round p to
    # bf16 before p.v and the result to bf16 once, but the TPU kernel
    # rescales its accumulator at every K block, so a final rounding can
    # fall the other way: one to two bf16 ulps at the largest magnitude
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    err = np.abs(got.to(torch.float32).numpy() - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("batch,seq,heads,kv_heads,dim", [
    (1, 1, 4, 2, 16), (2, 65, 4, 2, 16), (1, 300, 6, 6, 8), (1, 128, 8, 1, 32),
])
def test_reference_matches_cache_and_attend(batch, seq, heads, kv_heads, dim):
    """The flash op's plain version and the masked attention over an
    empty cache compute one function, with v a strided view."""
    q, k, v = _qkv(seq, seq, heads, kv_heads, dim, batch=batch)
    q, k = _torch(q, torch.float32), _torch(k, torch.float32)
    wide = torch.zeros((batch, seq, kv_heads * dim + 24))
    v_view = wide[..., 24:].reshape(batch, seq, kv_heads, dim)
    v_view.copy_(_torch(v, torch.float32))
    assert not v_view.is_contiguous() or seq == 1
    cfg = tsc.tiny_model_config(
        num_hidden_layers=1, num_attention_heads=heads,
        num_key_value_heads=kv_heads, head_dim=dim,
    )
    cache = tl.init_cache(cfg, batch, seq + 3, torch.float32, "cpu")
    want = tl._cache_and_attend(
        0, q, k, v_view, cache, torch.zeros(batch, dtype=torch.int64), cfg,
        tl.attended(0, seq, seq + 3), scale=dim ** -0.5,
    )
    before = flash_attention.launches
    got = flash_attention(q, k, v_view, dim ** -0.5)
    assert flash_attention.launches == before  # the CPU launches nothing
    # f32 throughout: only the summation order differs
    torch.testing.assert_close(
        got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item()
    )


def test_pad_rows_stay_out_of_real_rows():
    """Rows after the prompt in a bucket-padded chunk reach no real row."""
    q, k, v = [_torch(a, torch.float32) for a in _qkv(0, 40, 4, 2, 16)]
    want = flash_attention_reference(q, k, v, 0.25)[:, :25]
    for t in (q, k, v):
        t[:, 25:] = 1e4
    got = flash_attention_reference(q, k, v, 0.25)
    assert torch.equal(got[:, :25], want)
    assert bool(torch.isfinite(got).all())


def test_wrapper_refuses_bad_shapes():
    q, k, v = [_torch(a, torch.float32) for a in _qkv(0, 8, 4, 2, 16)]
    with pytest.raises(ValueError, match="share batch"):
        flash_attention(q, k[:, :7], v, 1.0)
    with pytest.raises(ValueError, match="query heads"):
        flash_attention(q[:, :, :3], k, v, 1.0)
    with pytest.raises(ValueError, match="one float dtype"):
        flash_attention(q, k, v.to(torch.bfloat16), 1.0)
    with pytest.raises(ValueError, match=r"\(B, S, heads, D\)"):
        flash_attention(q[0], k[0], v[0], 1.0)


# ------------------------------------------------------------ the model


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """One tiny bf16-weight Llama in both packages (f32 activations)."""
    return _models(tmp_path_factory.mktemp("flash"))


@pytest.fixture(scope="module")
def models96(tmp_path_factory):
    """The same at head size 96 (Phi-3's), bf16 activations: the route
    through K8."""
    return _models(tmp_path_factory.mktemp("flash96"), jnp.bfloat16,
                   head_dim=96)


def _models(path, dtype=jnp.float32, **cfg):
    tsc.write_synthetic_checkpoint(
        path,
        tsc.tiny_model_config(**{**TINY, "tie_word_embeddings": False, **cfg}),
        vq_kwargs=VQ, seed=5,
    )
    jmodel = j_load_model(str(path), dtype=dtype, runtime_format="bf16")
    with open(path / "config.json") as f:
        hf = json.load(f)
    return jmodel, convert_params(jax_params(jmodel), hf, device="cpu")


@pytest.mark.parametrize("dtype,dim,takes", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 96, True),
    (torch.bfloat16, 128, True), (torch.float32, 128, False),
    (torch.float16, 128, False), (torch.bfloat16, 80, False),
    (torch.bfloat16, 16, False),
])
def test_long_chunks_route_by_dtype_and_head_size(dtype, dim, takes):
    """K8 takes bf16 at the head sizes it is built for; everything else
    takes the cache attention. The route depends on no device."""
    assert HEAD_DIMS == (64, 96, 128)
    assert kernel_takes(dtype, dim) is takes
    cfg = tsc.tiny_model_config(head_dim=dim)
    assert tl.takes_flash(cfg, 1024, dtype) is takes
    assert not tl.takes_flash(cfg, 1023, dtype)
    windowed = tsc.tiny_model_config(head_dim=dim, model_type="mistral",
                                     sliding_window=48)
    assert not tl.takes_flash(windowed, 2048, dtype)


@pytest.fixture
def flash_calls(monkeypatch):
    """Sequence lengths of the calls that entered the flash op."""
    calls = []

    def counted(q, k, v, scale):
        calls.append(q.shape[1])
        return flash_attention(q, k, v, scale)

    monkeypatch.setattr(tl, "flash_attention", counted)
    return calls


def _fresh_prefill(jmodel, tmodel, seq, jdtype, tdtype):
    """Logits of one fresh ``seq``-token chunk through vptq_tpu and the
    port, and the port's cache after it."""
    tokens = np.random.default_rng(0).integers(0, TINY["vocab_size"], (1, seq))
    want, _ = j_forward(
        jmodel, jnp.asarray(tokens, jnp.int32),
        j_init_cache(jmodel.cfg, 1, 2048, jdtype), dtype=jdtype,
        fresh_prefill=True,
    )
    cache = tl.init_cache(tmodel.cfg, 1, 2048, tdtype, "cpu")
    with torch.inference_mode():
        got, cache = tl.forward(
            tmodel, torch.from_numpy(tokens), cache, dtype=tdtype,
            fresh_prefill=True,
        )
    assert cache.lengths.tolist() == [seq] and cache.max_len == seq
    # the chunk's K/V went into the cache
    assert float(cache.k[0][0, seq - 1].abs().sum()) > 0
    assert float(cache.v[1][0, seq:].abs().sum()) == 0
    return got.float().numpy(), np.asarray(want, np.float32)


def test_long_fresh_prefill_matches_vptq_tpu(models96, flash_calls,
                                             monkeypatch):
    """bf16 at head size 96: the chunk goes through the flash op, once per
    layer, and gives vptq_tpu's logits (its cache attention) to bf16."""
    jmodel, tmodel = models96
    seq = 1024
    got, want = _fresh_prefill(jmodel, tmodel, seq, jnp.bfloat16,
                               torch.bfloat16)
    # once per layer, on the whole chunk
    assert flash_calls == [seq] * TINY["num_hidden_layers"]
    # the port's own cache attention on the same chunk, for scale
    monkeypatch.setattr(tl, "takes_flash", lambda *args: False)
    cached, _ = _fresh_prefill(jmodel, tmodel, seq, jnp.bfloat16,
                               torch.bfloat16)
    assert len(flash_calls) == TINY["num_hidden_layers"]
    # bf16 activations, rounded at other points than vptq_tpu rounds them:
    # about one bf16 ulp (2^-8) of the largest logit on average, and at
    # worst no further from vptq_tpu than the port's cache attention is
    # (here 0.0026 and 0.18 of max|want| against 0.0021 and 0.10)
    gap, cached_gap = np.abs(got - want), np.abs(cached - want)
    assert gap.mean() <= 2.0 ** -8 * np.abs(want).max()
    assert gap.max() <= 2 * cached_gap.max()


def test_long_fresh_prefill_f32_takes_cache_attention(models, flash_calls):
    jmodel, tmodel = models
    got, want = _fresh_prefill(jmodel, tmodel, 1024, jnp.float32,
                               torch.float32)
    # f32 activations take the cache attention, as on the card
    assert flash_calls == []
    # f32 activations on the same bf16 weights: summation order only
    np.testing.assert_allclose(
        got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max()
    )


def test_short_or_continued_chunks_skip_the_flash_op(models96, flash_calls):
    # bf16 at head size 96: a fresh chunk of 1024 would take K8
    _, tmodel = models96
    cache = tl.init_cache(tmodel.cfg, 1, 2048, torch.bfloat16, "cpu")
    with torch.inference_mode():
        tokens = torch.zeros((1, 1023), dtype=torch.int64)
        tl.forward(tmodel, tokens, cache, dtype=torch.bfloat16,
                   fresh_prefill=True)
        tokens = torch.zeros((1, 1024), dtype=torch.int64)
        tl.forward(tmodel, tokens, cache, dtype=torch.bfloat16)
    assert flash_calls == []


LONG_PROMPTS = pytest.mark.parametrize("prompt_len,max_seq,chunks", [
    (1100, 2048, [2048]),       # past the 512 bucket: one fresh 2048 chunk
    (2500, 4096, [2048]),       # fresh chunk, then 512 at offset 2048
])


def _greedy(jmodel, tmodel, prompt_len, max_seq, jdtype, tdtype):
    prompt = np.random.default_rng(prompt_len).integers(
        0, TINY["vocab_size"], prompt_len
    )
    want = JGenerator(jmodel, max_seq=max_seq, dtype=jdtype).generate(
        prompt, max_new_tokens=6
    )
    got = Generator(tmodel, max_seq=max_seq, dtype=tdtype).generate(
        prompt, max_new_tokens=6
    )
    return got, want


@LONG_PROMPTS
def test_long_prompt_greedy_tokens_identical(
    models, flash_calls, prompt_len, max_seq, chunks
):
    """f32 at head size 16 takes the cache attention and gives the JAX
    tokens."""
    jmodel, tmodel = models
    got, want = _greedy(jmodel, tmodel, prompt_len, max_seq, jnp.float32,
                        torch.float32)
    assert flash_calls == []
    assert len(want) == 6 and got == want


@LONG_PROMPTS
def test_long_prompt_greedy_tokens_through_flash(
    models96, flash_calls, prompt_len, max_seq, chunks
):
    """bf16 at head size 96 takes the flash op for its fresh chunk and
    gives the JAX tokens."""
    jmodel, tmodel = models96
    got, want = _greedy(jmodel, tmodel, prompt_len, max_seq, jnp.bfloat16,
                        torch.bfloat16)
    assert flash_calls == chunks * TINY["num_hidden_layers"]
    assert len(want) == 6 and got == want


def test_sliding_window_keeps_long_prefill_out_of_flash(tmp_path, flash_calls):
    # head size 96: bf16 activations would take K8 without the window
    jmodel, tmodel = _models(tmp_path, model_type="mistral", sliding_window=48,
                             head_dim=96)
    assert tmodel.cfg.sliding_window == jmodel.cfg.sliding_window == 48
    tokens = np.random.default_rng(1).integers(0, TINY["vocab_size"], (1, 1024))
    want, _ = j_forward(
        jmodel, jnp.asarray(tokens, jnp.int32),
        j_init_cache(jmodel.cfg, 1, 1024, jnp.float32), dtype=jnp.float32,
        fresh_prefill=True,
    )
    with torch.inference_mode():
        got, _ = tl.forward(
            tmodel, torch.from_numpy(tokens),
            tl.init_cache(tmodel.cfg, 1, 1024, torch.float32, "cpu"),
            dtype=torch.float32, fresh_prefill=True,
        )
    with torch.inference_mode():
        tl.forward(
            tmodel, torch.from_numpy(tokens),
            tl.init_cache(tmodel.cfg, 1, 1024, torch.bfloat16, "cpu"),
            dtype=torch.bfloat16, fresh_prefill=True,
        )
    assert flash_calls == []
    want = np.asarray(want)
    # f32 activations on the same bf16 weights: summation order only
    np.testing.assert_allclose(
        got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max()
    )


def test_jax_is_on_the_cpu():
    assert jax.default_backend() == "cpu"
