"""vptq_tpu_torch's planner (``tools/plan.py``) and ``utils/profiling.py``
against vptq_tpu's: the geometries and the VQ spec parser, the abstract
model against the real encoders' shapes and dtypes (blocked over 2 and 4
shards too), one decode step on the meta device at full geometry (one
rank's under TP 2 and 8), the cost model with vptq_tpu's rates over one
device and several, the CLI's exit codes and its placement, budget and
prediction lines over several devices and hosts; the roofline with the
same peaks, device_time and trace on the CPU."""

import re

import json

import pytest
import torch
from torch_port import TINY, VQ

from vptq_tpu.models.llama import ModelConfig as JModelConfig
from vptq_tpu.tools import plan as jplan
from vptq_tpu.utils import profiling as jprof
from vptq_tpu.utils import synth_checkpoint as jsc
from vptq_tpu_torch.models.llama import ModelConfig
from vptq_tpu_torch.models.loader import load_model
from vptq_tpu_torch.tools import plan
from vptq_tpu_torch.utils import memory as tm
from vptq_tpu_torch.utils import profiling


def _cfg(name, cls=ModelConfig, **changes):
    return cls(**{**dict(tie_word_embeddings=False, model_type="llama"),
                  **plan.GEOMETRIES[name], **changes})


def test_geometries_and_parse_vq_are_jax():
    assert plan.GEOMETRIES == jplan.GEOMETRIES
    for spec in ("v8-k65536-256", "v8-k65536-0", "v6-k4096-16"):
        assert plan.parse_vq(spec) == jplan.parse_vq(spec)
    for bad in ("8-65536", "v8-k65536", "v8-k-256"):
        with pytest.raises(ValueError, match="bad --vq"):
            plan.parse_vq(bad)


def _state(model):
    """{name: (shape, dtype)} of every persistent buffer, in order."""
    return [(k, tuple(t.shape), t.dtype)
            for k, t in model.state_dict().items()]


# tests/test_torch_moe.py's and tests/test_torch_deepseek.py's geometries
FAMILIES = {
    "llama": dict(TINY, tie_word_embeddings=False),
    "llama-tied": dict(TINY),
    "mixtral": dict(TINY, model_type="mixtral", num_local_experts=4,
                    num_experts_per_tok=2, tie_word_embeddings=False),
    "deepseek": dict(
        model_type="deepseek_v3", vocab_size=256, hidden_size=64,
        intermediate_size=96, num_hidden_layers=3, num_attention_heads=4,
        num_key_value_heads=4, head_dim=16, q_lora_rank=24, kv_lora_rank=16,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        moe_intermediate_size=32, n_routed_experts=8, num_experts_per_tok=2,
        n_shared_experts=1, n_group=4, topk_group=2,
        first_k_dense_replace=1, tie_word_embeddings=False,
    ),
}
CASES = [(f, fmt) for f in ("llama", "llama-tied")
         for fmt in ("int8", "int4", "int3", "int2", "bf16")]
CASES += [(f, fmt) for f in ("mixtral", "deepseek")
          for fmt in ("int8", "int4")]


@pytest.mark.parametrize("family,fmt", CASES)
def test_abstract_shapes_match_the_real_encoders(tmp_path, family, fmt):
    """The meta model the planner builds holds the buffers the loader's
    model holds (fused, the lm_head in int8), name for name, with their
    shapes and dtypes; its bytes are the estimate's and the loaded
    model's; vptq_tpu's abstract model has the same leaves' shapes."""
    jsc.write_synthetic_checkpoint(
        tmp_path, jsc.tiny_model_config(**FAMILIES[family]), vq_kwargs=VQ,
        seed=11,
    )
    real = load_model(str(tmp_path), runtime_format=fmt,
                      quantize_lm_head=True, device="cpu")
    abstract = plan.abstract_runtime_model(real.cfg, fmt,
                                           quantize_lm_head=True)
    assert _state(abstract) == _state(real)
    assert all(t.device.type == "meta" for t in abstract.state_dict().values())
    assert tm.model_bytes(abstract) == tm.model_bytes(real)
    with open(tmp_path / "config.json") as f:
        hf = json.load(f)
    jabstract = jplan.abstract_runtime_model(
        JModelConfig.from_hf_dict(hf), fmt, quantize_lm_head=True)
    import jax

    want = sorted((tuple(a.shape), str(a.dtype).replace("uint16", "int16"))
                  for a in jax.tree_util.tree_leaves(jabstract))
    got = sorted((s, str(d).removeprefix("torch."))
                 for _, s, d in _state(abstract))
    assert got == want


def test_codebook_abstract_layer_is_the_loaders():
    """The codebook plan's layer at the community geometry: vptq_tpu's
    shapes (uint16 planes held as int16) and the estimate's bytes."""
    lin = plan._abs_linear(4096, 11008, "codebook", vq=(8, 65536, 256))
    jlin = jplan._abs_linear(4096, 11008, "codebook", vq=(8, 65536, 256))
    for name in ("centroids", "ids", "res_centroids", "res_ids",
                 "weight_scale", "weight_bias"):
        assert tuple(getattr(lin, name).shape) == getattr(jlin, name).shape
    assert lin.ids.dtype == torch.int16 and lin.res_ids.dtype == torch.uint8
    assert tm.model_bytes(lin) == tm.linear_runtime_bytes(
        11008, 4096, "codebook", tm.synth_vq_config(11008, 4096))


@pytest.mark.parametrize("geometry,fmt", [
    ("llama3-8b", "int8"), ("mixtral-8x7b", "int8"), ("deepseek-r1", "int8"),
    ("llama2-7b", "codebook"),
])
def test_meta_decode_step_at_full_geometry(geometry, fmt):
    """One decode step of ``forward`` on the meta device at the published
    geometry (DeepSeek-R1's 671B too), through the kernels' plain versions:
    logits of the vocabulary, the estimate's weight bytes (but for the
    routers vptq_tpu's geometry leaves out), the cache's bytes; the kernels
    are back in place after it."""
    from vptq_tpu_torch.layers import runtime
    from vptq_tpu_torch.models import llama
    from vptq_tpu_torch.ops.w8_matmul import w8_matmul

    cfg = _cfg(geometry)
    step = plan.validate_plan(cfg, fmt, max_seq=512)
    assert step["logits_shape"] == (1, 1, cfg.vocab_size)
    assert step["logits_dtype"] == "torch.float32"
    est = tm.estimate_model_bytes(cfg, fmt, quantize_lm_head=True,
                                  default_vq=(8, 65536, 256))["total"]
    moe_layers = cfg.num_hidden_layers - min(cfg.first_k_dense_replace,
                                             cfg.num_hidden_layers)
    routers = (cfg.num_hidden_layers * cfg.num_local_experts
               * cfg.hidden_size * 2
               + moe_layers * cfg.n_routed_experts * (cfg.hidden_size + 1) * 4
               + cfg.num_hidden_layers * ((cfg.q_lora_rank or 0)
                                          + cfg.kv_lora_rank) * 4)
    assert step["weights_bytes"] == est + routers
    assert step["kv_bytes"] == tm.kv_cache_bytes(cfg, 1, 512)
    assert runtime.w8_matmul is w8_matmul
    assert llama._PAIRS_MATMUL["int8"].__name__ == "w8_matmul_pairs"


def test_meta_step_refuses_what_it_cannot_plan():
    with pytest.raises(ValueError, match="int8/int4"):
        plan.abstract_runtime_model(_cfg("mixtral-8x7b"), "int3")
    with pytest.raises(ValueError, match="plan supports"):
        plan._abs_linear(64, 64, "int5")
    # the codebook format has no blocked layout: JAX's message
    with pytest.raises(ValueError) as want:
        jplan.abstract_runtime_model(_cfg("llama2-70b", JModelConfig),
                                     "codebook", tp_shards=8)
    with pytest.raises(ValueError) as got:
        plan.abstract_runtime_model(_cfg("llama2-70b"), "codebook",
                                    tp_shards=8)
    assert str(got.value) == str(want.value)


TP_FAMILIES = [("llama", "int8"), ("llama", "int4"), ("llama", "int3"),
               ("llama", "int2"), ("mixtral", "int4"), ("deepseek", "int8")]


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("family,fmt", TP_FAMILIES)
def test_abstract_blocked_model_is_jax(family, fmt, shards):
    """``abstract_runtime_model(tp_shards=n)``: vptq_tpu's abstract model's
    leaves, shape and dtype, leaf for leaf (o_proj and the dense and
    shared down_proj blocked); a dense model's bytes are
    ``estimate_model_bytes(tp_shards=n)``'s."""
    import jax

    cfg = jsc.tiny_model_config(**FAMILIES[family])
    jabstract = jplan.abstract_runtime_model(cfg, fmt, tp_shards=shards)
    want = sorted((tuple(a.shape), str(a.dtype).replace("uint16", "int16"))
                  for a in jax.tree_util.tree_leaves(jabstract))
    tcfg = ModelConfig(**{k: getattr(cfg, k) for k in (
        "vocab_size", "hidden_size", "intermediate_size",
        "num_hidden_layers", "num_attention_heads", "num_key_value_heads",
        "head_dim", "tie_word_embeddings", "model_type")},
        **{k: v for k, v in FAMILIES[family].items() if k not in (
            "vocab_size", "hidden_size", "intermediate_size",
            "num_hidden_layers", "num_attention_heads",
            "num_key_value_heads", "head_dim", "tie_word_embeddings",
            "model_type")})
    abstract = plan.abstract_runtime_model(tcfg, fmt, tp_shards=shards)
    got = sorted((s, str(d).removeprefix("torch."))
                 for _, s, d in _state(abstract))
    assert got == want
    if family == "llama":
        assert tm.model_bytes(abstract) == tm.estimate_model_bytes(
            tcfg, fmt, quantize_lm_head=True, tp_shards=shards)["total"]


PREDICT_CASES = [
    ("llama2-7b", "int8", 1, 264), ("llama2-7b", "int4", 1, 2048),
    ("llama2-13b", "int3", 2, 2048), ("llama3-70b", "int2", 1, 4096),
    ("llama3-8b", "int2-mixed", 1, 2048), ("llama3-8b", "int3-mixed", 4, 512),
    ("mixtral-8x7b", "int4", 1, 2048), ("mixtral-8x7b", "int8", 8, 2048),
    ("deepseek-r1", "int4", 1, 2048), ("llama2-70b", "bf16", 1, 2048),
]


@pytest.mark.parametrize("lm", [True, False])
@pytest.mark.parametrize("geometry,fmt,batch,max_seq", PREDICT_CASES)
def test_predict_is_jax_with_jax_rates(geometry, fmt, batch, max_seq, lm):
    """The cost model keeps vptq_tpu's formula: with its rates and HBM
    peak put in, the port's tok/s is vptq_tpu's to 1e-9 (one device)."""
    want = jplan.predict_decode_tok_s(
        _cfg(geometry, JModelConfig), fmt, 1, batch, max_seq,
        quantize_lm_head=lm)
    got = plan.predict_decode_tok_s(
        _cfg(geometry), fmt, 1, batch, max_seq, quantize_lm_head=lm,
        rates=jplan.E2E_GBPS, hbm_gbps=jplan._V5E_HBM_GBPS)
    assert abs(got - want) <= 1e-9 * want


def test_fitted_rates_give_back_the_steps():
    """``fit_e2e_rates`` on a set of steps, then ``predict_decode_tok_s``
    with those rates: the same steps (bf16 lm_head, as they were read)."""
    cfg = _cfg("llama3-8b")
    steps = {"int8": 8.0e-3, "int4": 7.2e-3, "int3": 8.1e-3, "int2": 7.5e-3}
    rates = plan.fit_e2e_rates(cfg, steps)
    assert rates["bf16"] == rates["int8"]
    for fmt, t in steps.items():
        got = 1 / plan.predict_decode_tok_s(cfg, fmt, quantize_lm_head=False,
                                            rates=rates)
        assert abs(got - t) <= 1e-12
    assert set(plan.E2E_GBPS) == set(rates)


def test_predict_refuses_unmeasured_formats():
    with pytest.raises(ValueError, match="no rate measured"):
        plan.predict_decode_tok_s(_cfg("llama2-7b"), "codebook")


@pytest.mark.parametrize("chips", [2, 4, 8])
@pytest.mark.parametrize("geometry,fmt,batch,max_seq", PREDICT_CASES[::3])
def test_predict_over_devices_is_jax(geometry, fmt, batch, max_seq, chips):
    """Over several devices the cost model is vptq_tpu's too: every stream
    term over the devices (the blocks blocked), plus ``(2L + 1) ·
    ici_us``; with its rates, its tok/s to 1e-9, at two latencies."""
    for ici in (plan.ICI_US, 3.0):
        want = jplan.predict_decode_tok_s(
            _cfg(geometry, JModelConfig), fmt, chips, batch, max_seq,
            ici_us=ici)
        got = plan.predict_decode_tok_s(
            _cfg(geometry), fmt, chips, batch, max_seq, ici_us=ici,
            rates=jplan.E2E_GBPS, hbm_gbps=jplan._V5E_HBM_GBPS)
        assert abs(got - want) <= 1e-9 * want


@pytest.mark.parametrize("argv,rc", [
    (["--geometry", "llama2-7b", "--format", "int4", "--hbm-gb", "16"], 0),
    (["--geometry", "llama2-70b", "--format", "bf16", "--hbm-gb", "16"], 1),
    (["--geometry", "llama3-8b", "--format", "int8", "--hbm-gb", "80"], 0),
    (["--geometry", "llama3-405b", "--format", "int2-mixed", "--hbm-gb",
      "80"], 1),
    (["--geometry", "mistral-large-123b", "--format", "codebook",
      "--hbm-gb", "80", "--max-seq", "4096"], 0),
])
def test_cli_exit_codes_are_jax(argv, rc, capsys):
    """Fits (0) or over the budget (1) as vptq_tpu's CLI decides on one
    device of the same size; the budget table's rows are its."""
    assert jplan.main(argv) == rc
    want = capsys.readouterr().out.splitlines()
    assert plan.main(argv) == rc
    got = capsys.readouterr().out.splitlines()
    table = [ln for ln in want if ln.lstrip().startswith(
        ("format", "codebook", "int", "bf16"))]
    assert table and all(ln in got for ln in table)
    assert any(ln.startswith("OVER BUDGET" if rc else "fits:") for ln in got)


def test_cli_runs_the_meta_step(capsys):
    assert plan.main(["--geometry", "llama2-7b", "--format", "int2-mixed",
                      "--hbm-gb", "80", "--compile", "--max-seq", "256"]) == 0
    out = capsys.readouterr().out
    assert "int2 base plan" in out
    assert "meta decode step: logits (1, 1, 32000) torch.float32" in out
    assert "decode step runs on the meta device: OK" in out


def _placement_numbers(lines, port: bool) -> dict:
    """The numbers of the placement, budget, prediction and aggregate
    lines, by label."""
    out = {}
    for ln in lines:
        if ln.startswith("# ") and "pp=" in ln:
            out["placement"] = re.search(r"pp=(\d+) x tp=(\d+)", ln).groups()
        elif ln.startswith("fits:"):
            out["fits"] = re.match(r"fits: ([\d.]+) GiB/", ln).group(1)
        elif ln.startswith("OVER"):
            out["over"] = True
        elif ln.startswith("predicted decode:"):
            m = re.match(r"predicted decode: ([\d.]+) tok/s [^\[(]*"
                         r"(?:\[([\d.]+)\.\.([\d.]+))?", ln)
            out["predicted"] = m.groups()
        elif ln.startswith("aggregate throughput:"):
            out["aggregate"] = re.search(
                r"(\d+) \w+\(s\) x (\d+) pipelined .* up to ([\d.]+) tok/s "
                r"at batch >= (\d+)", ln).groups()
    return out


@pytest.mark.parametrize("argv", [
    ["--geometry", "llama2-70b", "--format", "int4", "--chips", "8"],
    ["--geometry", "llama2-70b", "--format", "int2-mixed", "--chips", "8",
     "--hosts", "2", "--batch", "4"],
    # 8 KV heads cap TP at 8: two pipeline stages
    ["--geometry", "llama3-70b", "--format", "int8", "--chips", "16",
     "--max-seq", "4096"],
    ["--geometry", "mixtral-8x7b", "--format", "int4", "--chips", "4",
     "--hosts", "2"],
    ["--geometry", "llama3-405b", "--format", "int4", "--chips", "8"],
    ["--geometry", "llama2-70b", "--format", "int4", "--chips", "6",
     "--hosts", "4"],
])
def test_cli_placement_is_jax(argv, capsys, monkeypatch):
    """Over several devices and hosts the CLI prints vptq_tpu's placement
    (pp × tp), budget per device, prediction per host with its ici_us
    range, and aggregate, number for number, given its rates and the same
    memory; the exit code is its."""
    argv = [*argv, "--hbm-gb", "16"]
    rc = jplan.main(argv)
    want = _placement_numbers(capsys.readouterr().out.splitlines(), False)
    monkeypatch.setattr(plan, "E2E_GBPS", jplan.E2E_GBPS)
    monkeypatch.setattr(plan, "H100_HBM_GBPS", jplan._V5E_HBM_GBPS)
    assert plan.main(argv) == rc
    got = _placement_numbers(capsys.readouterr().out.splitlines(), True)
    assert got == want and want


@pytest.mark.parametrize("tp_size", [2, 8])
def test_meta_step_under_tensor_parallelism(tp_size, capsys):
    """One rank's decode step on the meta device under TP: the logits of
    the whole vocabulary (gathered), the rank's weights as
    ``tp_place_model`` places the blocked model, its share of the cache;
    the CLI runs it, and one pipeline stage's layers when TP cannot take
    every device."""
    from vptq_tpu_torch.parallel.mesh import Mesh
    from vptq_tpu_torch.parallel.tp import tp_place_model

    cfg = _cfg("llama3-8b")
    step = plan.validate_plan(cfg, "int4", max_seq=512, tp=tp_size)
    assert step["logits_shape"] == (1, 1, cfg.vocab_size)
    placed = tp_place_model(
        plan.abstract_runtime_model(cfg, "int4", tp_shards=tp_size),
        Mesh(data=1, model=tp_size, rank=0, device="meta"),
        reencode_rows=False)
    assert step["weights_bytes"] == tm.model_bytes(placed)
    assert step["kv_bytes"] == tm.kv_cache_bytes(cfg, 1, 512) // tp_size
    argv = ["--geometry", "llama3-8b", "--format", "int4", "--hbm-gb", "80",
            "--max-seq", "256", "--compile",
            "--chips", str(2 * tp_size if tp_size == 8 else tp_size)]
    assert plan.main(argv) == 0
    out = capsys.readouterr().out
    stages = 2 if tp_size == 8 else 1
    assert f"(pp={stages} x tp={tp_size})" in out
    assert (f"one of 2 pipeline stages (16 layers, tp=8)" in out) == (
        stages == 2)
    assert (f"meta decode step of one rank of tp={tp_size}: logits "
            f"(1, 1, 128256)") in out


def test_a_real_tensor_never_takes_the_meta_collectives():
    """The collectives give a meta tensor its result's shape and call no
    group; a real tensor goes to ``torch.distributed`` (with no process
    group here, which raises)."""
    from vptq_tpu_torch.parallel import distributed
    from vptq_tpu_torch.parallel.mesh import TPAxis

    axis = TPAxis(None, 4, 0)
    meta = torch.empty((2, 3), device="meta")
    assert distributed.all_reduce(meta, axis) is meta
    assert distributed.all_gather_dim(meta, axis, 1).shape == (2, 12)
    with pytest.raises((RuntimeError, ValueError)):
        distributed.all_reduce(torch.ones(2, 3), axis)
    with pytest.raises((RuntimeError, ValueError)):
        distributed.all_gather_dim(torch.ones(2, 3), axis, 1)


@pytest.mark.parametrize("argv,needle", [
    (["--chips", "8", "--parallel", "gspmd"], "spec-annotation"),
    (["--format", "int8", "--chips", "2", "--parallel", "gspmd",
      "--hbm-gb", "80"], "spec-annotation"),
    ([], "--hbm-gb"),
])
def test_cli_refuses_what_it_cannot_plan(argv, needle, monkeypatch):
    """GSPMD placement of a runtime format has no counterpart (the
    codebook format plans under gspmd, below); without a card the
    device's memory must be given."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        plan.main(["--geometry", "llama3-8b", *argv])
    assert exc.value.code not in (0, None) and needle in str(exc.value.code)


@pytest.mark.parametrize("chips", ["2", "8"])
@pytest.mark.parametrize("geometry", ["llama2-70b", "llama2-7b",
                                      "mixtral-8x7b", "deepseek-r1"])
def test_codebook_plans_under_gspmd_as_jax(geometry, chips, capsys):
    """The codebook format over several devices: vptq_tpu's GSPMD
    placement line (pp=1 x tp=1), its budget per device and its exit
    code, number for number. Its prediction rests on a TPU rate for the
    codebook gather, which the port has not measured: the port prints
    none."""
    argv = ["--geometry", geometry, "--format", "codebook", "--chips", chips,
            "--hbm-gb", "16"]
    rc = jplan.main(argv)
    jlines = capsys.readouterr().out.splitlines()
    assert plan.main(argv) == rc
    lines = capsys.readouterr().out.splitlines()
    def unpredicted(lines):
        return [ln for ln in lines if not ln.startswith("predicted decode")]

    want = _placement_numbers(unpredicted(jlines), False)
    got = _placement_numbers(unpredicted(lines), True)
    assert got == want and want
    assert jlines[0] == lines[0] == (
        "# codebook plans under GSPMD (no shard_map-TP path)")
    assert any(ln.startswith("predicted decode: none") for ln in lines) == (
        rc == 0)


def test_codebook_meta_step_over_devices(capsys):
    """``--compile`` under gspmd runs one rank's decode step of the
    codebook placement on the meta device: the whole vocabulary's
    logits, the rank's index planes."""
    argv = ["--geometry", "llama2-7b", "--format", "codebook", "--chips", "2",
            "--hbm-gb", "80", "--max-seq", "256", "--compile"]
    assert plan.main(argv) == 0
    out = capsys.readouterr().out
    assert ("meta decode step of one rank of gspmd=2: logits (1, 1, 32000)"
            in out)
    one = plan.validate_plan(_cfg("llama2-7b"), "codebook", max_seq=256)
    two = plan.validate_plan(_cfg("llama2-7b"), "codebook", max_seq=256, tp=2)
    assert two["weights_bytes"] < 0.6 * one["weights_bytes"]


# -------------------------------------------------------------- profiling


@pytest.mark.parametrize("seconds,nbytes,flops", [
    (1e-4, 58_720_256, 234_881_024),  # a GEMV: memory bound
    (2e-3, 60_000_000, 2 * 2048 * 28672 * 4096),  # a long chunk: compute
    (5e-5, 0, 10 ** 9), (3e-6, 10 ** 6, 0),
])
def test_roofline_is_jax_with_the_same_peaks(seconds, nbytes, flops):
    want = jprof.roofline(seconds, nbytes, flops)
    got = profiling.roofline(seconds, nbytes, flops, jprof.V5E_HBM_GBPS,
                             jprof.V5E_BF16_TFLOPS)
    assert got == want
    card = profiling.roofline(seconds, nbytes, flops)
    assert set(card) == set(want)
    assert card["GB_per_s"] == want["GB_per_s"]


def test_device_time_and_trace_on_the_cpu(tmp_path):
    """On CPU tensors device_time chains the calls on the host clock (the
    output's prefix is the next input); a trace writes its Chrome file,
    with no card kernel in it."""
    calls = []

    def fn(x, w):
        calls.append(tuple(x.shape))
        return x @ w

    x, w = torch.ones(2, 8), torch.full((8, 16), 0.125)
    seconds = profiling.device_time(fn, x, w, n_iter=5, n_time=2)
    assert seconds > 0
    assert calls == [(2, 8)] * 11
    with profiling.trace(str(tmp_path / "t")) as d:
        fn(x, w)
    assert d == str(tmp_path / "t")
    with open(tmp_path / "t" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    assert profiling.trace_kernel_names(d) == []


def test_peaks_are_the_h100s():
    assert (profiling.H100_HBM_GBPS, profiling.H100_BF16_TFLOPS,
            profiling.H100_INT8_TOPS) == (3350.0, 989.0, 1979.0)
