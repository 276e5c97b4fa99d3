"""vptq_tpu_torch's calibrated re-encode (``quant/calibrate.py``) against
vptq_tpu's.

* ``synthetic_calibration_tokens`` gives JAX's ids; ``_select_cols`` its
  columns; ``_site_map`` its sites and paths for every family.
* Llama, Phi-3 (q|k|v and gate|up stored fused), Mixtral and DeepSeek
  (MLA with q_lora, the grouped MoE with a shared expert) calibrated in
  int4-mixed, int3-mixed, int2-mixed and plain int4 on 128 tokens, the
  JAX package with its Pallas kernels in interpret mode (the port's plain
  versions round x to bf16 as those kernels do; JAX's XLA path keeps it
  f32): the report's format per site, the int8 site set, ``int8_cols``
  and ``col_idx`` are JAX's; the codes are JAX's but for a stated share
  (the Hessians and the error feedback round in another order than
  numpy's and LAPACK's, and GPTQ carries a flipped code's error onward);
  the logits are those of JAX's calibrated model (its codes through the
  port's forward, ``convert_params``) within a stated tolerance, and so
  are the greedy tokens; for Llama they are the JAX ``Generator``'s too
  (its Pallas interpret mode costs ~10 s a MoE model, and the port's
  forward is held to JAX's for every family by the other test files).
* ``resume_dir``: stopped inside the main pass and run again, the model
  is the uninterrupted run's, byte for byte (``tp_shards`` is
  ``tests/test_torch_tp_calibrate.py``'s).

The checkpoints are written at weight spread 0.05: at the writer's
default (0.02) these tiny random models are so ill-conditioned that a
one-bf16-ulp change of the embedding moves their logits 12–22% of the
largest (``examples/mixed_sensitivity.py``'s ``nudged``), which no
comparison of two calibrations can see through; at 0.05 it moves them
about 0.1%. Each logit comparison also reports that sensitivity.
"""

import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port import TINY, VQ, jax_params

from vptq_tpu import native
from vptq_tpu.models import load_model as j_load_model
from vptq_tpu.quant import calibrate as jcal
from vptq_tpu.serving.generate import Generator as JGenerator
from vptq_tpu.tools import export_runtime as jexport
from vptq_tpu_torch.convert import convert_params
from vptq_tpu_torch.examples.mixed_sensitivity import nudged
from vptq_tpu_torch.models import llama as tl
from vptq_tpu_torch.models.loader import load_model
from vptq_tpu_torch.ops import packing as tp
from vptq_tpu_torch.quant import calibrate as tcal
from vptq_tpu_torch.serving.generate import Generator
from vptq_tpu_torch.tools import export_runtime as texport
from vptq_tpu_torch.utils import synth_checkpoint as tsc

STD = 0.05
FAMILIES = {
    "llama": dict(TINY, tie_word_embeddings=False),
    "phi3": dict(TINY, tie_word_embeddings=False, model_type="phi3"),
    "mixtral": dict(TINY, tie_word_embeddings=False, model_type="mixtral",
                    num_local_experts=4, num_experts_per_tok=2),
    # DS_CFG of tests/test_deepseek.py cut to two layers: dense, then MoE
    "deepseek": dict(
        TINY, model_type="deepseek_v3", intermediate_size=96,
        num_hidden_layers=2, num_key_value_heads=4, q_lora_rank=24,
        kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
        v_head_dim=16, rope_interleave=True, moe_intermediate_size=32,
        n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
        n_group=4, topk_group=2, norm_topk_prob=True,
        routed_scaling_factor=2.5, first_k_dense_replace=1,
        tie_word_embeddings=True,
    ),
}
FORMATS = ["int4-mixed", "int3-mixed", "int2-mixed", "int4"]
CALIBRATION = 128
# at most this share of all codes may differ from JAX's (measured: at
# most 3e-5 over the sixteen cases)
CODE_SHARE = 1e-3
# logits against JAX's codes run through the port: max |diff| within
# LOGIT_TOL of max |logit| (measured: at most 2.5e-3)
LOGIT_TOL = 1e-2


@pytest.fixture(scope="module", autouse=True)
def jax_pallas():
    """vptq_tpu's Pallas kernels in interpret mode and its numpy encoders
    for the whole module (its models are made once and shared)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "_lib", lambda: None)
        mp.setattr(sys.modules["vptq_tpu.ops.quant_matmul"], "_IMPL", "pallas")
        mp.setenv("VPTQ_TPU_PALLAS_INTERPRET", "1")
        yield
        # jit caches are keyed on shapes, not on the switch
        jax.clear_caches()


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("calibrate"))


@functools.lru_cache(maxsize=None)
def _checkpoint(root: str, family: str) -> str:
    path = f"{root}/ckpt_{family}"
    tsc.write_synthetic_checkpoint(
        path, tsc.tiny_model_config(**FAMILIES[family]), vq_kwargs=VQ,
        seed=6, std=STD,
    )
    return path


@functools.lru_cache(maxsize=None)
def _exact(root: str, family: str):
    """(JAX's, the port's) exact codebook models, unfused, f32."""
    path = _checkpoint(root, family)
    return (
        j_load_model(path, dtype=jnp.float32, runtime_format="codebook",
                     fuse=False),
        load_model(path, dtype=torch.float32, runtime_format="codebook",
                   fuse=False, device="cpu"),
    )


@functools.lru_cache(maxsize=None)
def _calibrated(root: str, family: str, fmt: str, **kw):
    """((JAX model, report), (port model, report)) of one case."""
    jexact, texact = _exact(root, family)
    tokens = tcal.synthetic_calibration_tokens(
        texact.cfg.vocab_size, CALIBRATION)
    return (
        jcal.quantize_model_calibrated(jexact, tokens.numpy(), fmt, **kw),
        tcal.quantize_model_calibrated(texact, tokens, fmt, **kw),
    )


def _codes(flat: dict) -> dict:
    """{key: int16 codes} of every quantized plane of a flattened model."""

    def get(k):
        a = flat[k]
        return a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.array(a))

    out = {}
    for k in flat:
        if k.endswith(".wq4"):
            out[k] = tp.unpack_int4(get(k))
        elif k.endswith(".wq2p"):
            out[k] = tp.unpack_int2(get(k))
        elif k.endswith(".wq3_2"):
            out[k] = tp.unpack_int3(get(k), get(k[:-1] + "1"))
        elif ".stacked_int4." in k and k.endswith("_wq"):
            wq = get(k)  # (E, out, in / 2) nibbles
            out[k] = tp.unpack_int4(wq.reshape(-1, wq.shape[-1]))
        elif k.endswith((".wq", "_wq")):
            out[k] = get(k)
    return {k: v.to(torch.int16) for k, v in out.items()}


def _logits(model, tokens):
    with torch.inference_mode():
        logits, _ = tl.forward(
            model, torch.from_numpy(tokens),
            tl.init_cache(model.cfg, 1, 32, torch.float32, "cpu"),
            dtype=torch.float32,
        )
    return logits


def test_synthetic_tokens_equal_jax():
    for args in ((256, 128), (256, 4096), (1000, 100, 64, 3), (50, 7)):
        got = tcal.synthetic_calibration_tokens(*args)
        want = jcal.synthetic_calibration_tokens(*args)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("in_f,fraction", [
    (64, 1 / 48), (512, 1 / 48), (512, 1 / 32), (300, 0.3), (1000, 0.2),
])
def test_select_cols_equal_jax(in_f, fraction):
    rng = np.random.default_rng(in_f)
    weights = [(rng.standard_normal((n, in_f)) * 0.02).astype(np.float32)
               for n in (48, 16, 16)]
    x = rng.standard_normal((256, in_f)).astype(np.float32)
    x[:, ::5] *= 4.0  # salient columns
    h = x.T @ x
    for hess in (h, None):
        want = jcal._select_cols(weights, hess, fraction)
        got = tcal._select_cols(
            [torch.from_numpy(w) for w in weights],
            None if hess is None else torch.from_numpy(hess), fraction,
        )
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_site_map_equals_jax(workdir, family):
    jexact, texact = _exact(workdir, family)
    for jb, tb in zip(jexact.blocks, texact.blocks):
        assert tcal._site_map(tb) == jcal._site_map(jb)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_calibrated_model_matches_jax(workdir, family, fmt):
    (jmodel, jrep), (tmodel, trep) = _calibrated(workdir, family, fmt)

    # the report: one format per site, the int8 sites, the side columns
    def site_fields(rep, field):
        return {k: v.get(field) for k, v in rep.items() if k != "summary"}

    for field in ("format", "int8_cols"):
        assert site_fields(trep, field) == site_fields(jrep, field)
    jsum, tsum = jrep["summary"], trep["summary"]
    for k in jsum:
        if k != "wall_s":
            assert tsum[k] == jsum[k], k
    assert tsum["sites"] > 0
    for k in ("rank_s", "capture_s", "gptq_s", "propagate_s"):
        assert tsum[k] >= 0.0
    assert len(tsum["block_s"]) == tmodel.cfg.num_hidden_layers
    # sensitivities rank the sites alike (int4-mixed's ranking pass)
    sens = site_fields(trep, "sensitivity")
    if any(v is not None for v in sens.values()):
        want = site_fields(jrep, "sensitivity")
        for k, v in sens.items():
            assert v == pytest.approx(want[k], rel=1e-3), k

    # the codes: the same tensors under the same names, col_idx equal,
    # and at most CODE_SHARE of the codes off JAX's
    jflat, tflat = jexport._flatten_model(jmodel), texport._flatten_model(
        tmodel)
    assert sorted(tflat) == sorted(jflat)
    for k in tflat:
        if k.endswith("mix_cols"):
            np.testing.assert_array_equal(tflat[k].numpy(), jflat[k])
    jcodes, tcodes = _codes(jflat), _codes(tflat)
    assert tcodes and sorted(tcodes) == sorted(jcodes)
    total = sum(c.numel() for c in tcodes.values())
    differ = sum(int((tcodes[k] != jcodes[k]).sum()) for k in tcodes)
    assert differ <= CODE_SHARE * total, (differ, total)

    # logits against JAX's codes through the port, beside the model's own
    # sensitivity to a one-ulp change of its embedding
    with open(f"{_checkpoint(workdir, family)}/config.json") as f:
        hf = json.load(f)
    jtorch = convert_params(jax_params(jmodel), hf, device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, tmodel.cfg.vocab_size, (1, 24))
    got, want = _logits(tmodel, tokens), _logits(jtorch, tokens)
    scale = want.abs().max()
    gap = ((got - want).abs().max() / scale).item()
    embed = jtorch.embed_tokens
    jtorch.embed_tokens = nudged(embed)
    moved = ((_logits(jtorch, tokens) - want).abs().max() / scale).item()
    jtorch.embed_tokens = embed
    assert gap <= LOGIT_TOL, (gap, moved)

    # greedy tokens: those of JAX's codes (the JAX Generator's own, for
    # Llama: test_greedy_tokens_equal_the_jax_generator)
    assert _greedy(tmodel, tokens) == _greedy(jtorch, tokens)


def _greedy(model, tokens):
    return Generator(model, max_seq=64, dtype=torch.float32,
                     prompt_buckets=(32,)).generate(
        tokens[0, :9].tolist(), max_new_tokens=8)


@pytest.mark.parametrize("fmt", FORMATS)
def test_greedy_tokens_equal_the_jax_generator(workdir, fmt):
    (jmodel, _), (tmodel, _) = _calibrated(workdir, "llama", fmt)
    tokens = np.random.default_rng(0).integers(
        0, tmodel.cfg.vocab_size, (1, 24))
    want = JGenerator(jmodel, max_seq=64, dtype=jnp.float32,
                      prompt_buckets=(32,)).generate(
        tokens[0, :9].tolist(), max_new_tokens=8)
    assert _greedy(tmodel, tokens) == want


def test_int8_threshold_picks_jax_sites(workdir):
    # the H-weighted int4 error of every site (no site passes 1.0), then a
    # threshold halfway between the two middle ones
    (_, jrep), _ = _calibrated(workdir, "llama", "int4", int8_threshold=1.0)
    errs = sorted(v["err_ratio_int4"] for k, v in jrep.items()
                  if k != "summary")
    mid = len(errs) // 2
    threshold = (errs[mid - 1] + errs[mid]) / 2
    (_, jrep), (_, trep) = _calibrated(
        workdir, "llama", "int4", int8_threshold=threshold)
    formats = {k: v["format"] for k, v in trep.items() if k != "summary"}
    assert formats == {
        k: v["format"] for k, v in jrep.items() if k != "summary"}
    assert sorted(formats.values()) == ["int4"] * mid + ["int8"] * (
        len(errs) - mid)
    for k, v in trep.items():
        if k != "summary":
            assert v["err_ratio_int4"] == pytest.approx(
                jrep[k]["err_ratio_int4"], rel=2e-2)


def test_loader_calibrates_as_the_call_does(workdir):
    """``load_model(calibration=N)`` is the exact load, N synthetic tokens
    and ``quantize_model_calibrated``: the same bytes."""
    path = _checkpoint(workdir, "llama")
    (_, _), (direct, _) = _calibrated(workdir, "llama", "int4-mixed")
    loaded = load_model(path, dtype=torch.float32, runtime_format="int4-mixed",
                        calibration=CALIBRATION, device="cpu")
    a, b = texport._flatten_model(direct), texport._flatten_model(loaded)
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k].view(torch.uint8), b[k].view(torch.uint8)), k


def _bytes_of(model) -> dict:
    return {k: v.contiguous().view(torch.uint8).clone()
            for k, v in texport._flatten_model(model).items()}


@pytest.mark.parametrize("fmt", ["int4-mixed", "int2-mixed"])
def test_resume_gives_the_uninterrupted_bytes(workdir, tmp_path, monkeypatch,
                                              fmt):
    _, exact = _exact(workdir, "deepseek")
    before = {k: v.clone() for k, v in exact.state_dict().items()}
    tokens = tcal.synthetic_calibration_tokens(exact.cfg.vocab_size, 128)
    rdir = str(tmp_path / "resume")
    real = tcal._capture_block
    calls = []

    def dying(i, *a, diag_only=False, **kw):
        calls.append((i, diag_only))
        # the main pass's block 1: block 0 and the carried x are saved
        if i == 1 and not diag_only:
            raise RuntimeError("killed")
        return real(i, *a, diag_only=diag_only, **kw)

    monkeypatch.setattr(tcal, "_capture_block", dying)
    with pytest.raises(RuntimeError, match="killed"):
        tcal.quantize_model_calibrated(exact, tokens, fmt, resume_dir=rdir)
    with open(f"{rdir}/manifest.json") as f:
        assert json.load(f)["next_block"] == 1

    calls.clear()
    monkeypatch.setattr(tcal, "_capture_block", lambda i, *a, **kw: (
        calls.append((i, kw.get("diag_only", False))) or real(i, *a, **kw)))
    resumed, rep = tcal.quantize_model_calibrated(
        exact, tokens, fmt, resume_dir=rdir)
    # nothing before the kill is captured again: no ranking, main from 1
    assert calls == [(i, False) for i in range(1, len(exact.blocks))]
    monkeypatch.setattr(tcal, "_capture_block", real)
    straight, rep2 = tcal.quantize_model_calibrated(exact, tokens, fmt)
    assert {k: v for k, v in rep.items() if k != "summary"} == {
        k: v for k, v in rep2.items() if k != "summary"}
    a, b = _bytes_of(resumed), _bytes_of(straight)
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # the exact model is left as it was
    for k, v in exact.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_int8_threshold_is_refused_for_column_mixing(workdir):
    _, exact = _exact(workdir, "llama")
    with pytest.raises(ValueError, match="column"):
        tcal.quantize_model_calibrated(exact, None, "int2-mixed",
                                       int8_threshold=0.1)
