"""vptq_tpu_torch's offline tools (``tools/checkpoint_tools.py``,
``tools/pre_process.py``, ``tools/requantize.py``) and ``models/walk.py``
against vptq_tpu's on the same synthetic checkpoints: the files the
tools write are byte for byte vptq_tpu's, the ids requantize finds are
vptq_tpu's, the walk yields vptq_tpu's paths."""

import shutil
import sys

import numpy as np
import pytest
import torch
from torch_port import TINY, VQ

import jax
import jax.numpy as jnp

from vptq_tpu import native
from vptq_tpu.models import load_model as j_load_model
from vptq_tpu.models.walk import named_linears as j_named_linears
from vptq_tpu.ops.dequant import dequant_weight as j_dequant_weight
from vptq_tpu.serving.generate import Generator as JGenerator
from vptq_tpu.tools import checkpoint_tools as jct
from vptq_tpu.tools import pre_process as jpp
from vptq_tpu.tools import requantize as jrq
from vptq_tpu.utils import synth_checkpoint as jsc
from vptq_tpu.utils.synth import make_config, make_numpy_planes
from vptq_tpu_torch.config import VQLinearConfig
from vptq_tpu_torch.models.loader import load_model
from vptq_tpu_torch.models.walk import named_linears
from vptq_tpu_torch.serving.generate import Generator
from vptq_tpu_torch.tools import checkpoint_tools as tct
from vptq_tpu_torch.tools import pre_process as tpp
from vptq_tpu_torch.tools import requantize as trq

# the synthetic checkpoints the tools run on (vptq_tpu's writer): the
# index stream packed or in separate planes, with or without a residual
# codebook, uint16 ids (4096 centroids) or uint8 ones (64)
CHECKPOINTS = {
    "packed": VQ,
    "packed-nores": dict(VQ, num_res_centroids=-1),
    "planes": dict(VQ, is_indice_packed=False),
    "small-k": dict(VQ, vector_len=4, num_centroids=64, num_res_centroids=16),
}
STEPS = {
    "absorb": (jct.absorb_perm, tct.absorb_perm),
    "pack": (jct.pack_checkpoint, tct.pack_checkpoint),
    "unpack": (jct.unpack_checkpoint, tct.unpack_checkpoint),
}


def _checkpoint(root, name, seed=21):
    path = root / name
    if not path.exists():
        jsc.write_synthetic_checkpoint(
            path,
            jsc.tiny_model_config(**dict(TINY, tie_word_embeddings=False)),
            vq_kwargs=CHECKPOINTS[name], seed=seed,
        )
    return path


def _same_files(a, b):
    for name in ("model.safetensors", "config.json"):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def _jax_save(state, cfg, out):
    """vptq_tpu's ``save_state`` of its arrays in C order. Its
    ``absorb_perm`` on separate index planes leaves an array that is not
    C-contiguous, and the safetensors package writes such an array in its
    memory order, so vptq_tpu's own file of it holds scrambled ids
    (ROADMAP Queue 3, recorded); the port writes the ids in order. Every
    other array vptq_tpu's tools make is C-contiguous, and its file is
    this one."""
    jct.save_state({k: np.ascontiguousarray(v) for k, v in state.items()},
                   cfg, str(out))


@pytest.mark.parametrize("name,steps", [
    ("packed", ("absorb",)),
    ("packed", ("unpack",)),
    ("packed", ("unpack", "pack")),
    ("packed", ("absorb", "unpack")),
    ("packed-nores", ("absorb",)),
    ("packed-nores", ("unpack",)),
    ("planes", ("absorb",)),
    ("planes", ("pack",)),
    ("planes", ("absorb", "pack")),
    ("small-k", ("absorb",)),
    ("small-k", ("unpack", "pack")),
])
def test_transforms_write_jax_bytes(tmp_path, name, steps):
    """Each transform on the state vptq_tpu reads and on the state the port
    reads (CPU tensors): the two saved checkpoints are the same files, the
    config dict included."""
    src = _checkpoint(tmp_path, name)
    j_state, j_cfg = jct.load_raw_state(str(src))
    t_state, t_cfg = tct.load_raw_state(str(src), "cpu")
    for step in steps:
        j_state, j_cfg = STEPS[step][0](j_state, j_cfg)
        t_state, t_cfg = STEPS[step][1](t_state, t_cfg)
    assert t_cfg == j_cfg
    _jax_save(j_state, j_cfg, tmp_path / "jax")
    tct.save_state(t_state, t_cfg, str(tmp_path / "port"))
    _same_files(tmp_path / "jax", tmp_path / "port")


def test_wrapper_prefix_checkpoints(tmp_path):
    """SentenceTransformer-style nesting (``0.auto_model.<name>``): the
    prefix is resolved as vptq_tpu resolves it, and absorb / unpack / pack
    under it write vptq_tpu's bytes."""
    src = _checkpoint(tmp_path, "packed")
    j_state, j_cfg = jct.load_raw_state(str(src))
    t_state, t_cfg = tct.load_raw_state(str(src), "cpu")
    j_wrapped = {f"0.auto_model.{k}": v for k, v in j_state.items()}
    t_wrapped = {f"0.auto_model.{k}": v for k, v in t_state.items()}
    assert (tct.resolve_layer_prefix(t_wrapped, t_cfg)
            == jct.resolve_layer_prefix(j_wrapped, j_cfg) == "0.auto_model.")
    assert tct.resolve_layer_prefix(t_state, t_cfg) == ""
    for step in ("absorb", "unpack", "pack"):
        j_wrapped, j_cfg = STEPS[step][0](j_wrapped, j_cfg)
        t_wrapped, t_cfg = STEPS[step][1](t_wrapped, t_cfg)
    _jax_save(j_wrapped, j_cfg, tmp_path / "jax")
    tct.save_state(t_wrapped, t_cfg, str(tmp_path / "port"))
    _same_files(tmp_path / "jax", tmp_path / "port")
    with pytest.raises(KeyError, match="wrapper layout"):
        tct.resolve_layer_prefix({"x.weight": t_state["model.norm.weight"]},
                                 t_cfg)


@pytest.mark.parametrize("name", sorted(CHECKPOINTS))
def test_absorbed_checkpoint_keeps_every_weight(tmp_path, name):
    """The port's absorbed checkpoint, read by vptq_tpu's loader, gives
    the original's exact weights in every linear: the permutation went
    into the index order."""
    from vptq_tpu.layers.runtime import _exact_weight

    src = _checkpoint(tmp_path, name)
    state, cfg = tct.absorb_perm(*tct.load_raw_state(str(src), "cpu"))
    tct.save_state(state, cfg, str(tmp_path / "out"))
    assert not any(k.endswith(".perm") for k in state)
    assert not any(c["enable_perm"] for c in
                   cfg["quantization_config"]["config_for_layers"].values())
    before, after = (
        j_load_model(str(p), dtype=jnp.float32)
        for p in (src, tmp_path / "out"))
    def weight(lin):
        return np.asarray(_exact_weight(lin) if hasattr(lin, "centroids")
                          else lin.weight)

    for (pb, b), (pa, a) in zip(j_named_linears(before),
                                j_named_linears(after)):
        assert pa == pb
        np.testing.assert_array_equal(weight(a), weight(b))


@pytest.mark.parametrize("name", ["packed", "planes"])
def test_unpack_then_pack_gives_the_original_bytes(tmp_path, name):
    """In the port alone: the round trip through the other index layout
    gives back every tensor bit for bit."""
    src = _checkpoint(tmp_path, name)
    state, cfg = tct.load_raw_state(str(src), "cpu")
    original = dict(state)
    first, second = ((tct.unpack_checkpoint, tct.pack_checkpoint)
                     if name == "packed"
                     else (tct.pack_checkpoint, tct.unpack_checkpoint))
    state, cfg = second(*first(state, cfg))
    assert set(state) == set(original)
    for k, v in original.items():
        assert state[k].dtype == v.dtype or name == "planes", k
        assert torch.equal(state[k].contiguous().view(torch.uint8).reshape(-1),
                           v.contiguous().view(torch.uint8).reshape(-1)), k


@pytest.mark.parametrize("args", [
    [], ["--unpack"], ["--no-absorb-perm", "--unpack"], ["--pack"],
])
def test_pre_process_cli_writes_jax_bytes(tmp_path, args, capsys):
    """``python -m vptq_tpu_torch.tools.pre_process --device cpu`` writes
    the files vptq_tpu's CLI writes; vptq_tpu's reader finds its own
    arrays in them."""
    name = "planes" if "--pack" in args else "packed"
    src = _checkpoint(tmp_path, name)
    assert jpp.main(["-m", str(src), "-o", str(tmp_path / "jax"), *args]) == 0
    assert tpp.main(["-m", str(src), "-o", str(tmp_path / "port"), *args,
                     "--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == (
        f"wrote {tmp_path / 'port'}")
    _same_files(tmp_path / "jax", tmp_path / "port")
    want, want_cfg = jct.load_raw_state(str(tmp_path / "jax"))
    got, got_cfg = jct.load_raw_state(str(tmp_path / "port"))
    assert got_cfg == want_cfg and set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_pre_process_flags_exclude_each_other(tmp_path, capsys):
    src = _checkpoint(tmp_path, "packed")
    argv = ["-m", str(src), "-o", str(tmp_path / "o"), "--pack", "--unpack"]
    assert jpp.main(argv) == tpp.main([*argv, "--device", "cpu"]) == 2
    assert capsys.readouterr().err.count("exclusive") == 2
    assert not (tmp_path / "o").exists()


def test_processed_checkpoint_gives_jax_tokens(tmp_path, monkeypatch):
    """The port's pre-processed checkpoint (perm absorbed) serves, through
    the port, the greedy tokens vptq_tpu's Generator gives on the original
    one (f32, int8 with Pallas in interpret mode); vptq_tpu reads the same
    tokens from the processed one."""
    monkeypatch.setattr(native, "_lib", lambda: None)
    monkeypatch.setattr(sys.modules["vptq_tpu.ops.quant_matmul"], "_IMPL",
                        "pallas")
    monkeypatch.setenv("VPTQ_TPU_PALLAS_INTERPRET", "1")
    src = _checkpoint(tmp_path, "packed")
    dst = tmp_path / "processed"
    assert tpp.main(["-m", str(src), "-o", str(dst), "--device", "cpu"]) == 0
    prompt = [3, 17, 42, 99, 5, 250, 7]
    try:
        want = JGenerator(
            j_load_model(str(src), dtype=jnp.float32, runtime_format="int8"),
            max_seq=32, dtype=jnp.float32,
        ).generate(prompt, max_new_tokens=8)
        again = JGenerator(
            j_load_model(str(dst), dtype=jnp.float32, runtime_format="int8"),
            max_seq=32, dtype=jnp.float32,
        ).generate(prompt, max_new_tokens=8)
    finally:
        jax.clear_caches()
    got = Generator(
        load_model(str(dst), dtype=torch.float32, runtime_format="int8",
                   device="cpu"),
        max_seq=32, dtype=torch.float32,
    ).generate(prompt, max_new_tokens=8)
    assert got == want == again


def test_raw_state_reads_bin_checkpoints(tmp_path):
    """``load_raw_state`` reads a ``pytorch_model.bin`` checkpoint through
    the loader's reader: the tensors of the safetensors one."""
    src = _checkpoint(tmp_path, "packed")
    state, cfg = tct.load_raw_state(str(src), "cpu")
    dst = tmp_path / "bin"
    dst.mkdir()
    shutil.copy(src / "config.json", dst / "config.json")
    torch.save({k: v.clone() for k, v in state.items()},
               dst / "pytorch_model.bin")
    got, got_cfg = tct.load_raw_state(str(dst), "cpu")
    assert got_cfg == cfg and set(got) == set(state)
    for k, v in state.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_raw_state_default_device_is_cuda(tmp_path, monkeypatch):
    src = _checkpoint(tmp_path, "packed")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tct.load_raw_state(str(src))


# ------------------------------------------------------------- requantize


def _clear_margin(vectors, centroids, ids):
    """What counts as a match: the ids are equal. The inputs are held to
    have no near tie, so that an f32 sum in another order than numpy's
    cannot part them: each vector's best centroid beats the second by more
    than 1e-3 of its squared distance scale (in f64)."""
    d = ((vectors[:, None, :].astype(np.float64)
          - centroids[None].astype(np.float64)) ** 2).sum(-1)
    best = np.sort(d, axis=1)[:, :2]
    assert (np.argmin(d, axis=1) == ids).all()
    assert (best[:, 1] - best[:, 0] > 1e-3 * (1 + best[:, 1])).all()


@pytest.mark.parametrize("k,v,batch", [(32, 4, 16384), (300, 8, 7),
                                       (65536 // 64, 8, 100)])
def test_nearest_indices_match_jax(k, v, batch):
    rng = np.random.default_rng(k)
    centroids = rng.standard_normal((k, v)).astype(np.float32)
    vectors = (centroids[rng.integers(0, k, 257)]
               + 0.01 * rng.standard_normal((257, v))).astype(np.float32)
    want = jrq.nearest_indices(vectors, centroids, batch_size=batch)
    _clear_margin(vectors, centroids, want)
    got = trq.nearest_indices(torch.from_numpy(vectors),
                              torch.from_numpy(centroids), batch_size=batch)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_nearest_indices_keep_the_first_of_a_tie():
    centroids = np.asarray([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0]], np.float32)
    vectors = np.asarray([[1.0, 0.0], [0.5, 0.5], [0.0, 1.0]], np.float32)
    want = jrq.nearest_indices(vectors, centroids)
    got = trq.nearest_indices(torch.from_numpy(vectors),
                              torch.from_numpy(centroids))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.tolist() == [0, 0, 1]


@pytest.mark.parametrize("out_f,in_f,v,k,kres", [
    (24, 48, 4, 64, -1), (26, 40, 4, 64, -1), (32, 48, 8, 256, 16),
])
def test_requantize_matches_jax(out_f, in_f, v, k, kres):
    """On a reconstructed weight (residual-free: the ids come back) and on
    a random one: the port's main and residual ids are vptq_tpu's."""
    cfg = make_config(in_features=in_f, out_features=out_f, vector_len=v,
                      num_centroids=k, num_res_centroids=kres)
    tcfg = VQLinearConfig.from_dict(cfg.to_dict())
    planes = make_numpy_planes(cfg, seed=7)
    rng = np.random.default_rng(3)
    weights = [rng.standard_normal((out_f, in_f)).astype(np.float32)]
    if kres <= 0:
        weights.append(np.asarray(j_dequant_weight(
            centroids=planes["centroids"],
            ids=planes["ids"].astype(np.int64), cfg=cfg, xp=np,
        ), np.float32))
    res_c = planes["res_centroids"]
    for w in weights:
        want = jrq.requantize(w, planes["centroids"], res_c, cfg)
        got = trq.requantize(
            torch.from_numpy(w), torch.from_numpy(planes["centroids"]),
            None if res_c is None else torch.from_numpy(res_c), tcfg,
        )
        for g, wnt in zip(got, want):
            assert (g is None) == (wnt is None)
            if wnt is not None:
                assert tuple(g.shape) == wnt.shape
                np.testing.assert_array_equal(g.numpy(), wnt)
    if kres <= 0 and not cfg.padding:
        # the padded rows' ids are lost with the rows; the rest come back
        np.testing.assert_array_equal(got[0].numpy(), planes["ids"])


def test_requantize_refuses_what_jax_refuses():
    cfg = make_config(in_features=48, out_features=24, vector_len=4,
                      num_centroids=64, num_res_centroids=-1,
                      num_codebooks=2)
    w = torch.zeros(24, 48)
    with pytest.raises(NotImplementedError, match="one codebook"):
        trq.requantize(w, torch.zeros(2, 64, 4), None,
                       VQLinearConfig.from_dict(cfg.to_dict()))


# ------------------------------------------------------------------ walk

# tests/test_torch_phi3.py's, tests/test_torch_moe.py's and
# tests/test_torch_deepseek.py's geometries
FAMILIES = {
    "llama": dict(TINY, tie_word_embeddings=False),
    "phi3": dict(TINY, model_type="phi3", num_key_value_heads=4,
                 tie_word_embeddings=False),
    "mixtral": dict(TINY, model_type="mixtral", num_local_experts=4,
                    num_experts_per_tok=2, tie_word_embeddings=False),
    "deepseek": dict(
        model_type="deepseek_v3", vocab_size=256, hidden_size=64,
        intermediate_size=96, num_hidden_layers=3, num_attention_heads=4,
        num_key_value_heads=4, head_dim=16, q_lora_rank=24, kv_lora_rank=16,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        rope_interleave=True, moe_intermediate_size=32, n_routed_experts=8,
        num_experts_per_tok=2, n_shared_experts=1, n_group=4, topk_group=2,
        norm_topk_prob=True, routed_scaling_factor=2.5,
        first_k_dense_replace=1, tie_word_embeddings=True,
    ),
}


@pytest.mark.parametrize("fmt,fuse", [("int8", True), ("int8", False),
                                      ("codebook", False)])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_named_linears_give_jax_paths(tmp_path, family, fmt, fuse):
    """The same paths in the same order as vptq_tpu's walk over the same
    load: fused q|k|v and gate|up, Phi-3's stored fused layers, stacked
    experts (no per-expert paths then), the shared experts, MLA's
    projections (kv_b_proj absorbed), the untied lm_head."""
    jsc.write_synthetic_checkpoint(
        tmp_path, jsc.tiny_model_config(**FAMILIES[family]), vq_kwargs=VQ,
        seed=5,
    )
    want = [p for p, _ in j_named_linears(j_load_model(
        str(tmp_path), dtype=jnp.float32, runtime_format=fmt, fuse=fuse))]
    got = [p for p, _ in named_linears(load_model(
        str(tmp_path), dtype=torch.float32, runtime_format=fmt, fuse=fuse,
        device="cpu"))]
    assert got == want
    assert len(got) == len(set(got))
