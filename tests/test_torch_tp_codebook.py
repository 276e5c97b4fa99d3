"""A codebook model under a mesh (``load_model(runtime_format="codebook",
mesh=)``, ``parallel/tp.py``'s VQ placement) against the port's one
device and against vptq_tpu's GSPMD placement (``load_model(mesh=)`` on
2 of conftest's 8 CPU devices).

Two gloo ranks, spawned once for every case (``torch_port.
tp_rank_codebook``), each load its shard, run ``forward_tp`` over a
fresh prefill and a decode step, and serve greedy tokens through
``Generator(mesh=)``. Every rank's logits are within 1e-4 of max of the
port's one-device model's and of JAX's placed model's; the greedy tokens
equal the one-device ``Generator``'s. The cases cover the permutation
(row-parallel sites gather the activations first), a residual codebook,
outliers and two codebooks (stored columns that are no contiguous block
of the input), planes the mesh does not divide (column-parallel k / v
kept whole and their rows picked; row-parallel o / down held whole by
rank 0 alone, summed once), Qwen2's q/k/v bias and a VQ lm_head.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port import TINY, VQ, spawn_ranks, tp_rank_codebook

from vptq_tpu.models import load_model as j_load_model
from vptq_tpu.models.llama import forward as j_forward
from vptq_tpu.models.llama import init_cache as j_init_cache
from vptq_tpu.parallel.sharding import make_mesh as j_make_mesh
from vptq_tpu_torch.models.llama import forward, init_cache
from vptq_tpu_torch.models.loader import load_model
from vptq_tpu_torch.parallel import tp
from vptq_tpu_torch.parallel.mesh import Mesh
from vptq_tpu_torch.serving.generate import Generator
from vptq_tpu_torch.utils import synth_checkpoint as tsc

WORLD = 2
LOGIT_TOL = 1e-4
TOKENS = [[3, 17, 42, 9, 100, 7, 1, 250], [5, 5, 8, 200, 13, 2, 99, 31]]
PROMPT = [1, 2, 3, 4, 5]
# (name, model config, VQ geometry, writer keywords, the placements the
# case must reach)
CASES = (
    ("perm-res-vqhead", dict(TINY, tie_word_embeddings=False), VQ,
     dict(vq_lm_head=True), {"VQRowShard", "VQLinear"}),
    ("outliers-2cb", dict(TINY, tie_word_embeddings=False),
     dict(vector_len=8, num_centroids=256, num_codebooks=2, outlier_size=16,
          outlier_vector_len=4, num_outlier_centroids=64, enable_norm=True),
     {}, {"VQRowShard"}),
    # k / v: 48 rows of vectors of 16 are 3 index rows; o / down: one
    # outlier column leaves odd groups
    ("undivided", dict(TINY, tie_word_embeddings=False, head_dim=24),
     dict(vector_len=16, num_centroids=256, outlier_size=1,
          outlier_vector_len=4, num_outlier_centroids=16, enable_norm=True,
          enable_perm=True),
     {}, {"VQOutRows", "VQRowShard"}),
    ("qwen2-bias", dict(TINY, model_type="qwen2", tie_word_embeddings=False),
     VQ, dict(qkv_bias=True), {"VQRowShard"}),
)


def _checkpoint(root, name, cfg, vq, writer) -> str:
    path = str(root / name)
    tsc.write_synthetic_checkpoint(path, tsc.tiny_model_config(**cfg),
                                   vq_kwargs=vq, seed=13, std=0.05, **writer)
    return path


def _port_logits(model, tokens):
    t = torch.tensor(tokens)
    cache = init_cache(model.cfg, t.shape[0], 64, torch.float32, "cpu")
    with torch.inference_mode():
        logits, cache = forward(model, t, cache, dtype=torch.float32,
                                fresh_prefill=True)
        step, _ = forward(model, torch.tensor([[11], [12]]), cache,
                          dtype=torch.float32)
    return logits, step


def _jax_logits(path, tokens):
    mesh = j_make_mesh(data=1, model=WORLD,
                       devices=np.asarray(jax.devices()[:WORLD]))
    model = j_load_model(path, runtime_format="codebook", dtype=jnp.float32,
                         mesh=mesh)
    cache = j_init_cache(model.cfg, len(tokens), 64, jnp.float32)
    with mesh:
        logits, _ = j_forward(model, jnp.asarray(tokens, jnp.int32), cache,
                              dtype=jnp.float32)
    return torch.from_numpy(np.asarray(logits, np.float32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (one device's logits, step and tokens, JAX's logits, each
    rank's results)}."""
    root = tmp_path_factory.mktemp("tp_codebook")
    spec, out = [], {}
    for name, cfg, vq, writer, _ in CASES:
        path = _checkpoint(root, name, cfg, vq, writer)
        one = load_model(path, dtype=torch.float32, runtime_format="codebook",
                         device="cpu")
        logits, step = _port_logits(one, TOKENS)
        greedy = Generator(one, max_seq=64, dtype=torch.float32,
                           prompt_buckets=(16,)).generate(
            PROMPT, max_new_tokens=8, chunk_size=4)
        out[name] = (logits, step, greedy, _jax_logits(path, TOKENS))
        spec.append(dict(name=name, ckpt=path, tokens=TOKENS,
                         next=[[11], [12]], prompt=PROMPT))
    torch.save(spec, root / "spec.pt")
    spawn_ranks(tp_rank_codebook, WORLD, root, str(root / "spec.pt"),
                str(root))
    ranks = [torch.load(root / f"{r}.pt") for r in range(WORLD)]
    return {name: (*out[name], [r[name] for r in ranks]) for name in out}


def _close(got, want, what):
    gap = (got - want).abs().max() / want.abs().max()
    assert gap <= LOGIT_TOL, (what, float(gap))


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_logits_are_one_device_and_jax(runs, name):
    logits, step, _, jlogits, ranks = runs[name]
    _close(logits, jlogits, "one device against JAX")
    for r, res in enumerate(ranks):
        _close(res["logits"], logits, f"rank {r} prefill")
        _close(res["logits"], jlogits, f"rank {r} prefill against JAX")
        _close(res["step"], step, f"rank {r} decode step")


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_greedy_tokens_are_one_device(runs, name):
    _, _, greedy, _, ranks = runs[name]
    for res in ranks:
        assert res["greedy"] == greedy


@pytest.mark.parametrize("name,kinds", [(c[0], c[4]) for c in CASES])
def test_cases_reach_their_placements(runs, name, kinds):
    for res in runs[name][-1]:
        assert kinds <= set(res["kinds"]), res["kinds"]


def test_row_parallel_shards_cover_every_column_once(tmp_path):
    """Over the ranks, the row-parallel shards' input columns are each
    column once; a layer the axis does not divide lies on rank 0 alone."""
    name, cfg, vq, writer, _ = CASES[1]
    one = load_model(_checkpoint(tmp_path, name, cfg, vq, writer),
                     dtype=torch.float32, runtime_format="codebook",
                     device="cpu")
    o = one.blocks[0].attn.o_proj
    cols = []
    for r in range(WORLD):
        shard = tp._vq_row_parallel(o, Mesh(data=1, model=WORLD, rank=r))
        assert shard.gather and shard.layer.cfg.in_features == 32
        cols.append(shard.cols)
    assert sorted(torch.cat(cols).tolist()) == list(range(64))
    name, cfg, vq, writer, _ = CASES[2]
    one = load_model(_checkpoint(tmp_path, name, cfg, vq, writer),
                     dtype=torch.float32, runtime_format="codebook",
                     device="cpu")
    shards = [tp._vq_row_parallel(one.blocks[0].mlp.down_proj,
                                  Mesh(data=1, model=WORLD, rank=r))
              for r in range(WORLD)]
    assert shards[0].layer is one.blocks[0].mlp.down_proj or (
        shards[0].layer.cfg == one.blocks[0].mlp.down_proj.cfg)
    assert shards[1].layer is None


def test_checkpoint_configs_take_the_cases_geometry(runs, tmp_path):
    """The undivided case's planes are as its name says."""
    name, cfg, vq, writer, _ = CASES[2]
    path = _checkpoint(tmp_path, name, cfg, vq, writer)
    with open(f"{path}/config.json") as f:
        layers = json.load(f)["quantization_config"]["config_for_layers"]
    k = layers["model.layers.0.self_attn.k_proj"]
    assert k["out_features"] // k["vector_lens"][1] % WORLD == 1
    o = layers["model.layers.0.self_attn.o_proj"]
    assert o["group_size"] % WORLD == 1
