"""The synthetic writers' ``heavy_tailed`` and ``vq_lm_head`` options
against vptq_tpu's, byte for byte from one seed.

* ``make_numpy_planes(heavy_tailed=True)``: every plane equal to
  vptq_tpu's (the Student-t draws, then the ids; for the norm
  ``exp(0.5·normal)``, the boosted channels' ``choice``, then their
  ``uniform``) over residual, outlier, perm, norm and bias layers, and
  the Gaussian path left as it was.
* ``write_synthetic_checkpoint(heavy_tailed=, vq_lm_head=)``: every
  tensor and config.json equal to vptq_tpu's writer's (the lm_head's seed
  is drawn after the embedding and the final norm), and the tied
  embedding refused with its ``ValueError``.
"""

import json

import numpy as np
import pytest
import safetensors.numpy
from torch_port import VQ

from vptq_tpu.utils import synth as jsynth
from vptq_tpu.utils import synth_checkpoint as jsc
from vptq_tpu_torch.utils import synth as tsynth
from vptq_tpu_torch.utils import synth_checkpoint as tsc

LAYERS = {
    "plain": dict(),
    "residual": dict(num_res_centroids=256),
    "outlier": dict(outlier_size=64, outlier_vector_len=4,
                    num_outlier_centroids=512),
    "perm-norm": dict(enable_perm=True, enable_norm=True),
    "norm-bias": dict(enable_norm=True, bias=True, num_codebooks=2),
    "all": dict(num_res_centroids=64, outlier_size=32, outlier_vector_len=8,
                num_outlier_centroids=256, enable_perm=True,
                enable_norm=True, bias=True),
}


@pytest.mark.parametrize("heavy", [True, False])
@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_planes_equal_jax(layer, heavy):
    kw = dict(in_features=1280, out_features=96, vector_len=8,
              num_centroids=4096, **LAYERS[layer])
    jcfg = jsynth.make_config(**kw)
    tcfg = tsynth.make_config(**kw)
    want = jsynth.make_numpy_planes(jcfg, seed=17, heavy_tailed=heavy)
    got = tsynth.make_numpy_planes(tcfg, seed=17, heavy_tailed=heavy)
    assert sorted(got) == sorted(want)
    for name, a in want.items():
        if a is None:
            assert got[name] is None, name
            continue
        assert got[name].dtype == a.dtype and got[name].shape == a.shape
        assert got[name].tobytes() == a.tobytes(), name
    if heavy and tcfg.enable_norm:
        # max(4, 1280 // 128) = 10 channels boosted above the lognormal's
        ws = got["weight_scale"]
        assert (ws > 3.0).sum() >= 4


CHECKPOINTS = {
    "llama": dict(tie_word_embeddings=False),
    "qwen2-bias": dict(tie_word_embeddings=False, model_type="qwen2"),
    "phi3": dict(tie_word_embeddings=False, model_type="phi3"),
    "tied": dict(),
}
VQ_KWARGS = {
    "packed-perm": VQ,
    "outlier": dict(vector_len=8, num_centroids=256, outlier_size=16,
                    outlier_vector_len=4, num_outlier_centroids=64,
                    enable_norm=True),
}


@pytest.mark.parametrize("vq", sorted(VQ_KWARGS))
@pytest.mark.parametrize("model", sorted(CHECKPOINTS))
@pytest.mark.parametrize("heavy,vq_head", [(True, True), (True, False),
                                           (False, True)])
def test_checkpoint_equals_jax(tmp_path, model, vq, heavy, vq_head):
    over = CHECKPOINTS[model]
    qkv_bias = model == "qwen2-bias"
    kwargs = dict(vq_kwargs=VQ_KWARGS[vq], seed=9, qkv_bias=qkv_bias,
                  vq_lm_head=vq_head, heavy_tailed=heavy)
    if vq_head and model == "tied":
        for writer, sub in ((jsc, "jax"), (tsc, "port")):
            with pytest.raises(ValueError, match="tie_word_embeddings"):
                writer.write_synthetic_checkpoint(
                    tmp_path / sub, writer.tiny_model_config(**over),
                    **kwargs)
        return
    jsc.write_synthetic_checkpoint(
        tmp_path / "jax", jsc.tiny_model_config(**over), **kwargs)
    tsc.write_synthetic_checkpoint(
        tmp_path / "port", tsc.tiny_model_config(**over), **kwargs)
    want = safetensors.numpy.load_file(tmp_path / "jax" / "model.safetensors")
    got = safetensors.numpy.load_file(tmp_path / "port" / "model.safetensors")
    assert sorted(got) == sorted(want)
    assert ("lm_head.centroids.weight" in got) == vq_head
    assert ("lm_head.weight" in got) == (not vq_head and model != "tied")
    for name, a in want.items():
        assert got[name].dtype == a.dtype, name
        assert got[name].tobytes() == a.tobytes(), name
    with open(tmp_path / "jax" / "config.json") as f:
        jconf = json.load(f)
    with open(tmp_path / "port" / "config.json") as f:
        tconf = json.load(f)
    assert (tconf["quantization_config"]
            == jconf["quantization_config"])
    assert list(tconf["quantization_config"]["config_for_layers"]) == list(
        jconf["quantization_config"]["config_for_layers"])
    for key, value in tconf.items():
        assert jconf.get(key, value) == value, key
    assert np.isfinite(got["model.embed_tokens.weight"]).all()
