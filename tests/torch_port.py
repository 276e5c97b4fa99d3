"""Shared helpers of the tests that hold vptq_tpu_torch against vptq_tpu."""

import numpy as np
import torch

from vptq_tpu_torch.config import VQLinearConfig
from vptq_tpu_torch.layers.vqlinear import VQLinear
from vptq_tpu_torch.ops.packing import to_index_plane

# The tests run in several worker processes at once on a few cores; torch's
# default of one thread per core in every worker oversubscribes them, and
# the many small ops of these tiny models then run tens of times slower.
torch.set_num_threads(1)

# tiny GQA Llama: 2 layers, width 64, 4 heads over 2 KV heads
TINY = dict(
    vocab_size=256, hidden_size=64, intermediate_size=128,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    head_dim=16,
)
# llama3 scaling whose thresholds fall inside head_dim 16's frequencies,
# so the scaled, smoothed and unscaled branches are all taken
LLAMA3_SCALING = {
    "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
    "high_freq_factor": 4.0, "original_max_position_embeddings": 64,
}
VQ = dict(
    vector_len=8, num_centroids=4096, num_res_centroids=256,
    enable_norm=True, enable_perm=True, is_indice_packed=True,
)


def tensor(a, dtype=None):
    if a is None:
        return None
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def jax_params(model) -> dict:
    """Flat {tree path: numpy array} of a vptq_tpu pytree."""
    import jax

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(model)[0]:
        parts = [
            str(getattr(k, "name", getattr(k, "idx", getattr(k, "key", k))))
            for k in path
        ]
        out[".".join(parts)] = np.asarray(leaf)
    return out


def port_layer(planes, cfg) -> VQLinear:
    """The port's VQLinear holding vptq_tpu synth planes."""
    tcfg = VQLinearConfig.from_dict(cfg.to_dict())

    def plane(name, k):
        a = planes[name]
        return None if a is None else to_index_plane(tensor(a, torch.int64), k)

    perm = planes["perm"]
    return VQLinear(
        centroids=tensor(planes["centroids"]),
        ids=plane("ids", cfg.num_main_centroids),
        res_centroids=tensor(planes["res_centroids"]),
        res_ids=plane("res_ids", cfg.num_main_res_centroids),
        outlier_centroids=tensor(planes["outlier_centroids"]),
        outlier_ids=plane("outlier_ids", cfg.num_outlier_centroids),
        inv_perm=None if perm is None else torch.argsort(tensor(perm, torch.int64)),
        weight_scale=tensor(planes["weight_scale"]),
        weight_bias=tensor(planes["weight_bias"]),
        bias=tensor(planes["bias"]),
        cfg=tcfg,
    )


def xla_cpu_silu(x):
    """``jax.nn.silu`` as XLA's CPU backend lowers it: ``x * (1 / (1 +
    exp(-x)))``, each op rounded to the input's dtype. In bf16 the port's
    ``F.silu`` rounds once, so one down_proj input element in a few
    differs by a bf16 ulp and a greedy token on a near tie can part; with
    this in its place the port's bf16 logits equal those of vptq_tpu's
    op-by-op forward bit for bit (``tests/test_torch_cli.py``). Tests that
    hold bf16 text to the JAX package's swap it in with
    ``monkeypatch.setattr(F, "silu", ...)``."""
    return x * (1 / (1 + torch.exp(-x)))
