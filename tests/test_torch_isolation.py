"""vptq_tpu_torch stands alone, picks its device, and chip_smoke.py's
phases run at a tiny size on the CPU with the plain versions.

Tests marked ``cuda`` need an NVIDIA GPU; they skip elsewhere. This file
imports no JAX, so a machine with a GPU and no JAX runs them with
``python -m pytest --noconftest tests/test_torch_isolation.py -m cuda``.
"""

import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from unittest import mock

import pytest
import torch
from torch_port import LLAMA3_SCALING, TINY, VQ

import chip_smoke
from vptq_tpu_torch import AutoModelForCausalLM
from vptq_tpu_torch.convert import convert_params
from vptq_tpu_torch.examples import (
    kernel_bench,
    kernel_turns,
    mixed_sensitivity,
    profile_decode,
    vq_smallk_probe,
    w4_unpack_ablation,
    w4_wall_candidates,
)
from vptq_tpu_torch.ops import _build
from vptq_tpu_torch.ops.bf16_matmul import bf16_matmul, bf16_matmul_reference
from vptq_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
)
from vptq_tpu_torch.ops.vq_smallk_matmul import (
    vq_smallk_matmul,
    vq_smallk_matmul_reference,
)
from vptq_tpu_torch.ops.scaled_matmul import (
    DECODE_FORMATS,
    DECODE_SPLITS,
    DECODE_STAGE,
    decode_blocks,
    decode_smem,
    decode_split,
)
from vptq_tpu_torch.ops.w2_matmul import w2_matmul, w2_matmul_reference
from vptq_tpu_torch.ops.w3_matmul import w3_matmul, w3_matmul_reference
from vptq_tpu_torch.ops.w4_i32x8_matmul import (
    w4_i32x8_matmul,
    w4_i32x8_matmul_reference,
)
from vptq_tpu_torch.ops.w4_matmul import w4_matmul, w4_matmul_reference
from vptq_tpu_torch.ops.w4_matmul_expert import (
    w4_matmul_expert,
    w4_matmul_expert_reference,
)
from vptq_tpu_torch.ops.w4_matmul_pairs import (
    w4_matmul_pairs,
    w4_matmul_pairs_reference,
)
from vptq_tpu_torch.ops.w4_probe_matmul import (
    W4_PROBE_MODES,
    w4_probe_matmul,
    w4_probe_matmul_reference,
)
from vptq_tpu_torch.ops.w4_raw_probe import (
    w4_raw_probe,
    w4_raw_probe_reference,
)
from vptq_tpu_torch.ops.w8_matmul import (
    takes_decode_gemv as w8_takes_decode_gemv,
)
from vptq_tpu_torch.ops.w8_matmul import w8_matmul, w8_matmul_reference
from vptq_tpu_torch.ops.w8_matmul_expert import (
    w8_matmul_expert,
    w8_matmul_expert_reference,
)
from vptq_tpu_torch.ops.w8_matmul_pairs import (
    w8_matmul_pairs,
    w8_matmul_pairs_reference,
)
from vptq_tpu_torch.utils.synth_checkpoint import (
    tiny_model_config,
    write_synthetic_checkpoint,
)

ROOT = Path(__file__).resolve().parent.parent

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import vptq_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vptq_tpu_torch.__path__, "vptq_tpu_torch.")]
assert {"vptq_tpu_torch.ops.flash_attention", "vptq_tpu_torch.ops.bf16_matmul",
        "vptq_tpu_torch.ops.vq_smallk_matmul",
        "vptq_tpu_torch.examples.w4_wall_candidates",
        "vptq_tpu_torch.__main__", "vptq_tpu_torch.serving.webapp",
        "vptq_tpu_torch.eval.qa", "vptq_tpu_torch.eval.datasets"} <= set(names)
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "ml_dtypes", "safetensors", "vptq_tpu",
                           "transformers", "tokenizers", "datasets")
)
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_vptq_tpu():
    """Nor ``transformers``, ``tokenizers`` or ``datasets``, which the
    card's machine lacks: the entry points import them inside the
    functions that read a tokenizer or a corpus. Importing
    ``vptq_tpu_torch.__main__`` runs nothing."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout.split(maxsplit=1)
    assert int(out[0]) >= 40  # every module of the package was imported
    assert out[1].strip() == "[]"


@pytest.fixture
def checkpoint(tmp_path):
    write_synthetic_checkpoint(
        tmp_path, tiny_model_config(**TINY, tie_word_embeddings=False),
        vq_kwargs=VQ, seed=0,
    )
    return str(tmp_path)


def test_default_device_is_cuda(checkpoint, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AutoModelForCausalLM.from_pretrained(checkpoint)
    with open(Path(checkpoint) / "config.json") as f:
        hf = json.load(f)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert_params({}, hf)


def test_cpu_path_launches_no_kernel(checkpoint):
    before = w8_matmul.launches
    engine = AutoModelForCausalLM.from_pretrained(
        checkpoint, device="cpu", dtype=torch.float32, max_seq=64
    )
    out = engine.generate([1, 2, 3], max_new_tokens=5)
    assert len(out) == 5
    assert w8_matmul.launches == before


def test_chip_smoke_phases_on_cpu():
    shapes = [("a", 40, 1024), ("b", 24, 600)]
    kernels = list(chip_smoke.FORMAT_KERNEL.values())
    rows = []
    for name in kernels:
        rows += chip_smoke.phase_kernel(name, "cpu", shapes, tokens=(1, 20),
                                        iters=1)
    assert len(rows) == 16 and all(r["max_abs_err"] == 0.0 for r in rows)
    for fmt in chip_smoke.MOE_KERNELS:
        rows += chip_smoke.phase_moe_kernels(
            fmt, "cpu", shapes, n_experts=4, tokens=(1, 20), pairs=(2, 6),
            iters=1,
        )
    moe_rows = rows[16:]
    # K7 takes widths that 512 divides
    rows += chip_smoke.phase_bf16(
        "cpu", [("a", 40, 1024), ("b", 24, 512)], tokens=(1, 20), iters=1)
    flash_cases = (
        ("heads", 1, 40, 4, 2, 16, 1.0, True),
        ("heads", 1, 70, 4, 2, 16, 1.0, True),
        ("two sequences, big scores", 2, 33, 2, 2, 8, 3.0, False),
    )
    rows += chip_smoke.phase_flash("cpu", cases=flash_cases, iters=1)
    assert all(r["max_abs_err"] == 0.0 for r in rows[32:])
    # v is the view the model hands over: rows 4 + 2 + 2 heads wide
    assert [r["v_row_stride"] for r in rows[-3:]] == [128, 128, 48]
    # bytes: q and out at H heads, k and v at KV heads; operations: both
    # products over the lower triangle with its diagonal
    assert rows[-3]["bytes"] == 2 * 40 * 16 * (4 + 4 + 2 + 2)
    assert rows[-3]["flops"] == 4 * 16 * 4 * (40 * 41 // 2)
    assert len(moe_rows) == 16
    assert all(r["max_abs_err"] == 0.0 for r in moe_rows)
    # one token's top-2 are two experts; three tokens' pick at most four
    assert [r["distinct"] for r in moe_rows if r["T"] == 2] == [2] * 4
    assert all(2 <= r["distinct"] <= 4 for r in moe_rows if r["T"] == 6)
    assert set(chip_smoke.ALL_KERNELS) - set(chip_smoke.PROBE_KERNELS) == {
        r["kernel"] for r in rows}
    assert len(chip_smoke.ALL_KERNELS) == 14
    records = chip_smoke.kernel_records(
        rows, dict.fromkeys(chip_smoke.ALL_KERNELS, 0), tokens=(1, 20),
        pairs=(2, 6), seqs=(40, 70),
    )
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert len(records) == 20 and all(keys <= set(r) for r in records)
    assert [r["name"] for r in records if "flash" in r["name"]] == [
        f"flash_attention (S={n}, one layer's attention at Llama-3.1-8B's "
        "heads)" for n in (40, 70)
    ]
    assert sum(
        "scaled_dot_product_attention" in r["library"] for r in records) == 2
    assert all((ROOT / r["source"]).exists() for r in records)
    assert [r["name"] for r in records if "pairs" in r["name"]] == [
        f"{k} (P={p}, one layer's gate_up and down)"
        for k in ("w8_matmul_pairs", "w4_matmul_pairs") for p in (2, 6)
    ]
    json.dumps(records)

    enc = chip_smoke.phase_encoders("cpu", out_f=16, in_f=1024)
    assert sorted(enc) == ["int2", "int3", "int4"]

    cfg = dict(TINY, tie_word_embeddings=False,
               rope_scaling=tuple(sorted(LLAMA3_SCALING.items())))
    path, _ = chip_smoke.write_checkpoint(cfg, VQ)
    try:
        for fmt in chip_smoke.FORMAT_KERNEL:
            e2e = chip_smoke.phase_e2e(
                "cpu", path, fmt, TINY["vocab_size"], prompt_lens=(5, 20, 40),
                new_tokens=4, max_seq=64,
            )
            assert [r["prompt"] for r in e2e["requests"]] == [5, 20, 40]
            assert "long_prefill_logits_max_abs_diff" not in e2e
            # the CPU runs the plain versions
            assert e2e["launches"] == {chip_smoke.FORMAT_KERNEL[fmt]: 0}
            assert e2e["prefill_logits_max_abs_diff"] == 0.0
            assert e2e["decode_logits_max_abs_diff"] == 0.0
    finally:
        shutil.rmtree(path, ignore_errors=True)

    cfg = dict(TINY, tie_word_embeddings=False, model_type="mixtral",
               num_local_experts=4, num_experts_per_tok=2)
    path, _ = chip_smoke.write_checkpoint(cfg, VQ)
    try:
        for fmt, moe_kernels in chip_smoke.MOE_KERNELS.items():
            e2e = chip_smoke.phase_e2e(
                "cpu", path, fmt, TINY["vocab_size"], prompt_lens=(5, 70),
                new_tokens=3, max_seq=128,
            )
            assert e2e["kernels"] == [
                chip_smoke.FORMAT_KERNEL[fmt], *moe_kernels]
            assert set(e2e["launches"].values()) == {0}
            assert e2e["prefill_logits_max_abs_diff"] == 0.0
            assert e2e["decode_logits_max_abs_diff"] == 0.0
    finally:
        shutil.rmtree(path, ignore_errors=True)


@pytest.mark.parametrize("window", [None, 64], ids=["llama", "mistral"])
def test_chip_smoke_long_prompts_on_cpu(window):
    """The smoke's long requests at a tiny size: a prompt in one fresh
    2048-token chunk and one in two chunks; K8 is on the path unless the
    model has a sliding window, and the long prompt's logits are held
    against the plain versions."""
    # head size 64, which K8 is built for (TINY's 16 is not)
    cfg = dict(TINY, tie_word_embeddings=False, hidden_size=256, head_dim=64)
    if window:
        cfg.update(model_type="mistral", sliding_window=window)
    path, _ = chip_smoke.write_checkpoint(cfg, VQ)
    try:
        e2e = chip_smoke.phase_e2e(
            "cpu", path, "int8", TINY["vocab_size"],
            prompt_lens=(5, 1030, 2100), new_tokens=3, max_seq=4096,
        )
    finally:
        shutil.rmtree(path, ignore_errors=True)
    assert [r["prompt"] for r in e2e["requests"]] == [5, 1030, 2100]
    if window:
        assert e2e["kernels"] == ["w8_matmul"]
        assert "long_prefill_logits_max_abs_diff" not in e2e
    else:
        assert e2e["kernels"] == ["w8_matmul", "flash_attention"]
        assert e2e["long_prefill_logits_max_abs_diff"] == 0.0
    assert set(e2e["launches"].values()) == {0}  # the CPU launches nothing


def test_chip_smoke_entry_points_on_cpu(capsys):
    """The smoke's entry-points phase at a tiny size with the plain
    versions: the CLI (one-shot and chat, streamed = returned = eager
    ids), perplexity against the plain versions and the cross entropy,
    ``qa.main`` and the pairs, the web app (JSON and SSE, the switch to
    int4, a bad name), the diagnostics and their CPU recompute."""
    cfg = dict(TINY, vocab_size=272, tie_word_embeddings=False)
    path, _ = chip_smoke.write_checkpoint(cfg, VQ)
    try:
        out = chip_smoke.phase_entry_points(
            "cpu", path, cfg["vocab_size"], prompt_len=12, new_tokens=4,
            max_seq=256, ppl_seq=24, qa_items=8, qa_context=(1, 60))
    finally:
        shutil.rmtree(path, ignore_errors=True)
    got = out["entry_points"]
    assert set(out["launches"].values()) == {0}  # the CPU launches nothing
    assert [r["prompt"] for r in got["cli"]["requests"]] == [12, 22, 69]
    assert got["ppl"]["mean_nll_gap"] == 0.0 and got["ppl"]["windows"] == 2
    assert got["qa"]["buckets"] == [32, 64, 128] and got["qa"]["pairs"] == 32
    assert got["qa"]["worst_of_bound"] == 0.0
    assert got["web"]["chat_int4"]["new"] == 4
    diag = got["diagnostics"]
    assert diag["int8"]["n_layers"] == diag["int4"]["n_layers"] == 9
    assert diag["int4"]["worst_rel_rms"] > diag["int8"]["worst_rel_rms"]
    assert diag["int8"]["cpu_recompute_gap"] == 0.0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in lines if ln.startswith("entry ")] == [
        "cli", "ppl", "qa", "web", "diagnostics"]


@pytest.mark.parametrize("text", [
    "hello", "The quick brown fox, 42 times!\n", "héllo wörld ✓ 😀", "",
    "\x00\x01 \x7f\xa0\xad",
])
def test_smoke_byte_tokenizer_gives_the_directory_ids(tmp_path, text):
    """The smoke's tokenizer (the card has no transformers) gives the ids
    of ``utils/synth_tokenizer.py``'s directory as ``AutoTokenizer`` reads
    it: the text, the chat template with and without the generation
    prompt, and decodes them back."""
    transformers = pytest.importorskip("transformers")
    from vptq_tpu_torch.utils.synth_tokenizer import write_byte_tokenizer

    write_byte_tokenizer(str(tmp_path), vocab_size=300)
    hf = transformers.AutoTokenizer.from_pretrained(str(tmp_path))
    tok = chip_smoke.ByteTokenizer()
    assert tok.eos_token_id == hf.eos_token_id
    assert tok(text)["input_ids"] == hf(text)["input_ids"]
    messages = [{"role": "system", "content": "be brief"},
                {"role": "user", "content": text}]
    for gen_prompt in (True, False):
        assert tok.apply_chat_template(
            messages, add_generation_prompt=gen_prompt
        ) == hf.apply_chat_template(messages,
                                    add_generation_prompt=gen_prompt)
    ids = tok(text)["input_ids"]
    assert tok.decode(ids) == hf.decode(ids, skip_special_tokens=True)
    assert tok.decode([2, *ids, 270]) == hf.decode(
        [2, *ids, 270], skip_special_tokens=True)
    assert sorted(tok.id_of.values()) == list(range(3, 259))


@pytest.mark.parametrize("entry,argv", [
    ("cli", ["--model", "d", "--prompt", "hi"]),
    ("webapp", ["--model", "d"]),
    ("ppl", ["--model", "d", "--text", "t"]),
    ("qa", ["--model", "d", "--task", "arc_easy", "--data", "t"]),
])
def test_entry_points_exit_nonzero_without_a_card(entry, argv, monkeypatch):
    """Every new ``main`` runs on the card unless given ``--device cpu``:
    without a card it exits non-zero before it reads anything."""
    module = importlib.import_module({
        "cli": "vptq_tpu_torch.serving.cli",
        "webapp": "vptq_tpu_torch.serving.webapp",
        "ppl": "vptq_tpu_torch.eval.ppl",
        "qa": "vptq_tpu_torch.eval.qa",
    }[entry])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        module.main(argv)
    assert exc.value.code not in (0, None)
    assert "--device cpu" in str(exc.value.code)
    # --tp above 1 is refused before anything else, naming M16
    if entry in ("cli", "webapp"):
        with pytest.raises(SystemExit, match="M16"):
            (module._load(module.build_parser().parse_args(
                [*argv, "--tp", "2"])) if entry == "cli"
             else module.main([*argv, "--tp", "2"]))


def test_device_monitor_poll_asks_the_runtime_nothing(monkeypatch):
    """The web app's memory poll runs beside a handler thread that may be
    capturing a CUDA graph in the global mode, so it reads the allocator's
    counters (``memory_stats``) and never ``mem_get_info``; the card's
    total memory is read once, when the monitor is made."""
    import types

    from vptq_tpu_torch.utils.device_monitor import DeviceMonitor

    asked = []

    def forbidden(*a, **k):
        raise AssertionError("the poll called the CUDA runtime")

    def props(device):
        asked.append(device)
        return types.SimpleNamespace(total_memory=80 << 30)

    stats = {"allocated_bytes.all.current": 5 << 30,
             "allocated_bytes.all.peak": 7 << 30}
    monkeypatch.setattr(torch.cuda, "mem_get_info", forbidden)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda device: stats)
    mon = DeviceMonitor("cuda", poll_interval=0.01)
    assert mon.device == torch.device("cuda", 0) and len(asked) == 1
    monkeypatch.setattr(torch.cuda, "current_device", forbidden)
    monkeypatch.setattr(torch.cuda, "get_device_properties", forbidden)
    mon.start()
    try:
        for _ in range(500):
            if len(mon.series()["time"]) >= 3:
                break
            threading.Event().wait(0.01)
    finally:
        mon.stop()
    assert not mon._thread.is_alive()
    series = mon.series()
    assert len(series["time"]) >= 3
    assert set(series["bytes_in_use"]) == {5 << 30}
    assert set(series["peak_bytes"]) == {7 << 30}
    assert set(series["bytes_limit"]) == {80 << 30}
    cpu = DeviceMonitor("cpu")
    assert cpu.snapshot() == {"bytes_in_use": 0, "bytes_limit": 0,
                              "peak_bytes": 0}


# tests/test_torch_calibrate.py's spread: a well-conditioned tiny model
CALIBRATION_STD = 0.05
@pytest.mark.parametrize("fmt", ["int2-mixed", "int4-mixed"])
def test_chip_smoke_calibration_on_cpu(fmt):
    """The smoke's calibrated phase at a tiny size: from_pretrained
    calibrates on 4096 synthetic tokens, the report is printed per site
    kind, the model is written and read back byte-equal and served with
    its sensitivity; int2-mixed first holds layer 0's GPTQ against the
    CPU's (here the CPU's own)."""
    path, _ = chip_smoke.write_checkpoint(
        dict(TINY, tie_word_embeddings=False), VQ, std=CALIBRATION_STD)
    try:
        e2e = chip_smoke.phase_calibrated(
            "cpu", path, fmt, TINY["vocab_size"], gptq=fmt == "int2-mixed",
            prompt_lens=(5, 20), new_tokens=4, max_seq=64,
        )
    finally:
        shutil.rmtree(path, ignore_errors=True)
    made = e2e["calibration"]
    assert made["summary"]["calib_tokens"] == 4096
    assert len(made["summary"]["block_s"]) == TINY["num_hidden_layers"]
    assert sorted(made["sites"]) == ["down", "gate_up", "o", "qkv"]
    assert made["calibration_launches"] == {}  # the CPU launches nothing
    # every kernel call of the propagation forwards (7 linears a block,
    # f32 x of 8 x 512 tokens) held against its plain version, which the
    # CPU runs on both sides
    held = made["propagation_vs_plain"]
    assert sum(held["calls"].values()) == 7 * TINY["num_hidden_layers"] * (
        2 if fmt == "int2-mixed" else 1)
    assert all(x.startswith("(8, 512, ") and x.endswith(" float32")
               for x in held["x"])
    assert held["max_abs_err"] == 0.0
    assert made["bytes_equal_gb"] > 0
    if fmt == "int2-mixed":
        # 64 columns: every one on the int8 side
        assert all(k["int8_cols"] == [64] for k in made["sites"].values()
                   if k is not made["sites"]["down"])
        gptq = made["gptq_against_cpu"]
        assert sorted(gptq) == ["down", "o"]
        assert all(g["codes_differ"] == 0.0 for g in gptq.values())
        assert e2e["kernels"] == ["w2_matmul", "w8_matmul"]
    else:
        # a ranking pass put 3 of the 8 sites in int8: K2 and K1 on the path
        assert made["summary"]["int8_sites"] == 3
        assert len(made["int8_sites"]) == 3
        assert e2e["kernels"] == ["w4_matmul", "w8_matmul"]
    assert e2e["prefill_logits_max_abs_diff"] == 0.0
    assert "prefill_logits_sensitivity" in e2e
    # the launches a calibration's propagation makes on the card: a
    # mixed format's base kernel and K1 on every linear of each block
    report = {"layers.0.qkv": {"format": "int2-mixed"},
              "layers.0.o": {"format": "int2-mixed"},
              "layers.1.gate_up": {"format": "int4"},
              "layers.1.e3.down": {"format": "int8"},
              "summary": {}}
    assert chip_smoke.calibration_launches(report, "int2-mixed") == {
        "w2_matmul": 4, "w8_matmul": 5, "w4_matmul": 2}


def test_chip_smoke_calibrated_deepseek_on_cpu():
    """Moonlight's calibrated int4 at a tiny size (TINY_DEEPSEEK: a dense
    layer, then two of 8 experts and two shared ones): the experts stack
    after calibration, and the served model runs the expert and pairs
    plain versions."""
    path, _ = chip_smoke.write_checkpoint(TINY_DEEPSEEK, VQ,
                                          std=CALIBRATION_STD)
    try:
        e2e = chip_smoke.phase_calibrated(
            "cpu", path, "int4", TINY["vocab_size"], calibration=128,
            prompt_lens=(5, 70), new_tokens=3, max_seq=128,
        )
    finally:
        shutil.rmtree(path, ignore_errors=True)
    made = e2e["calibration"]
    assert made["summary"]["calib_tokens"] == 128
    assert made["summary"]["int4_sites"] == made["summary"]["sites"]
    assert sorted(made["sites"]) == [
        "attn_in", "down", "experts.down", "experts.gate_up", "gate_up", "o",
        "shared.down", "shared.gate_up"]
    assert made["sites"]["experts.down"]["sites"] == 16
    assert list(made["propagation_vs_plain"]["calls"]) == ["w4_matmul"]
    assert e2e["kernels"] == [
        "w4_matmul", "w4_matmul_expert", "w4_matmul_pairs"]


@pytest.mark.parametrize("fmt,wrong", [("int2-mixed", "w8_matmul"),
                                       ("int4", "w4_matmul")])
def test_chip_smoke_propagation_check_catches_a_wrong_kernel(fmt, wrong):
    """held_propagation fails a calibration whose propagation forward runs
    a kernel 5% off its plain version (here a mixed layer's side on its
    gathered columns, or K2), holds every call of the format's kernels in
    every block, and passes the capture forwards."""
    from vptq_tpu_torch.layers import runtime
    from vptq_tpu_torch.models.loader import load_model
    from vptq_tpu_torch.quant import calibrate as cal

    path, _ = chip_smoke.write_checkpoint(
        dict(TINY, tie_word_embeddings=False), VQ, std=CALIBRATION_STD)
    try:
        model = load_model(path, runtime_format="codebook", fuse=False,
                           device="cpu")
    finally:
        shutil.rmtree(path, ignore_errors=True)
    ref = chip_smoke.kernel_fns(wrong)[1]
    ids = cal.synthetic_calibration_tokens(TINY["vocab_size"], 64, 32)
    held = []
    with mock.patch.object(cal, "_block_forward", chip_smoke.held_propagation(
            fmt, cal._block_forward, held)):
        cal.quantize_model_calibrated(model, tokens=ids, fmt=fmt, fuse=False)
        assert {h["block"] for h in held} == set(
            range(TINY["num_hidden_layers"]))
        assert {h["kernel"] for h in held} == set(
            chip_smoke.format_kernels(fmt))
        held.clear()
        with mock.patch.object(runtime, wrong,
                               lambda *a, **k: ref(*a, **k) * 1.05), \
                pytest.raises(AssertionError, match="propagation of block 0"):
            cal.quantize_model_calibrated(model, tokens=ids, fmt=fmt,
                                          fuse=False)


def test_chip_smoke_probe_phase_on_cpu():
    """The probe phase at a tiny size with the plain versions: every mode
    of P1 / P2 with K2 beside it, P3 at v 4 and 8 fused and onehot-only,
    and the same at k 200 (outside the records), and the scripts' own
    checks; one record per probe mode."""
    shapes = (("a", 40, 2048), ("b", 24, 1024))
    rows = chip_smoke.phase_probes("cpu", shapes=shapes, iters=1)
    assert all(r["max_abs_err"] == 0.0 for r in rows)
    probe_modes = [
        (r["kernel"], r["mode"]) for r in rows
        if r["shape"] == "a" and r["kernel"] != "w4_matmul"]
    assert probe_modes == [
        *(("w4_probe_matmul", m) for m in W4_PROBE_MODES),
        ("w4_i32x8_matmul", "i32x8"), ("w4_raw_probe", "s8dot"),
        ("w4_raw_probe", "cvtonly"),
        *(("vq_smallk_matmul", f"v{v} {k}{m}") for v in (4, 8)
          for k in ("", "k200 ") for m in ("fused", "onehot_only")),
    ]
    assert [r["mode"] for r in rows if r["kernel"] == "w4_matmul"] == [
        "w4_matmul"] * 2
    checks = [r for r in rows if "script_err" in r]
    assert [(r["shape"], r["mode"]) for r in checks] == [
        ("check_fma16_exact", "fma16"), ("check_fma16_exact", "fma16f32"),
        *(("shift28 check", m) for m in ("prod", "shift28", "t8", "g256")),
        ("--check k=256", "v8 fused"), ("--check k=200", "v8 fused"),
    ]
    assert all(r["T"] == 3 and not r["in_record"] for r in checks)
    assert all(r["script_err"] <= r["script_limit"] for r in checks
               if r["script_limit"] is not None)
    # bytes: x, the bytes and the scale rows each mode reads, y in bf16
    by_mode = {r["mode"]: r for r in rows if r["shape"] == "a"}
    assert by_mode["prod"]["bytes"] == 2 * 2048 + 40 * 1024 + 16 * 40 * 2 + 80
    assert by_mode["g256"]["bytes"] == by_mode["prod"]["bytes"] - 8 * 40 * 2
    assert by_mode["t8"]["bytes"] == by_mode["prod"]["bytes"] + 2 * 2048
    assert by_mode["s8dot"]["bytes"] == 1024 + 40 * 1024 + 40 * 2 + 80
    assert by_mode["v8 onehot_only"]["bytes"] == 2 * 256 + 40 * 256 + 80
    assert by_mode["v8 k200 fused"]["bytes"] == (
        by_mode["v8 fused"]["bytes"] - 56 * 8 * 2)
    assert not any(r["in_record"] for r in rows if "k200" in r["mode"])
    assert by_mode["s8dot"]["flops"] == by_mode["prod"]["flops"] // 2
    launches = dict.fromkeys(chip_smoke.ALL_KERNELS, 0)
    records = chip_smoke.kernel_records(rows, launches)
    assert len(records) == 13
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert all(keys <= set(r) and r["launches"] == 0 for r in records)
    assert all((ROOT / r["source"]).exists() for r in records)
    assert {r["replaces"] for r in records} == {
        "examples/w4_unpack_ablation.py:39", "examples/w4_wall_candidates.py:53",
        "examples/w4_wall_candidates.py:91", "examples/w4_wall_candidates.py:124",
        "examples/w4_wall_candidates.py:161",
        "examples/w4_wall_candidates.py:172", "examples/vq_smallk_probe.py:92",
    }
    json.dumps(records)


@pytest.mark.parametrize("module", [
    kernel_bench, w4_wall_candidates, w4_unpack_ablation, vq_smallk_probe,
    kernel_turns, profile_decode, mixed_sensitivity,
])
def test_examples_exit_nonzero_without_a_card(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        module.main([])
    assert exc.value.code not in (0, None)
    assert "--device cpu" in str(exc.value.code)


def test_expected_launches_of_a_request():
    """The counts the smoke holds each request to: per layer and forward
    call 4 of the format's kernel (dense) or 2 (MoE: qkv, o); per layer
    2 of the pairs kernel for a call of at most 64 tokens and 2·E of the
    expert kernel for a longer one."""
    buckets = [128, 512, 2048]
    # Llama's head size, which K8 is built for
    dense = tiny_model_config(num_hidden_layers=3, head_dim=128)
    got = chip_smoke.expected_launches(dense, "int4", 16, 32, buckets)
    assert got.pop("w4_matmul") == 4 * 3 * 32 and set(got.values()) == {0}
    moe = tiny_model_config(num_hidden_layers=3, model_type="mixtral",
                            num_local_experts=8, num_experts_per_tok=2,
                            head_dim=128)
    for prompt in (16, 128, 512):
        got = chip_smoke.expected_launches(moe, "int8", prompt, 32, buckets)
        assert got.pop("w8_matmul") == 2 * 3 * 32
        assert got.pop("w8_matmul_pairs") == 2 * 3 * 31
        assert got.pop("w8_matmul_expert") == 16 * 3 * 1
        assert set(got.values()) == {0}
    # a prompt over the largest bucket is two prefill chunks; a bucket of
    # at most 64 tokens takes the pairs kernel in its prefill too
    got = chip_smoke.expected_launches(moe, "int4", 2050, 2, buckets)
    assert (got["w4_matmul"], got["w4_matmul_expert"],
            got["w4_matmul_pairs"]) == (2 * 3 * 3, 16 * 3 * 2, 2 * 3 * 1)
    got = chip_smoke.expected_launches(moe, "int4", 10, 2, [64])
    assert (got["w4_matmul_expert"], got["w4_matmul_pairs"]) == (0, 2 * 3 * 2)
    # K8: once per layer when the first chunk holds 1024 tokens or more and
    # the model has no sliding window; a later chunk never; K7 never
    for model in (dense, moe):
        fmt = "int8"
        for prompt, want in ((512, 0), (513, 3), (1536, 3), (2047, 3),
                             (4608, 3)):
            got = chip_smoke.expected_launches(model, fmt, prompt, 32, buckets)
            assert (got["flash_attention"], got["bf16_matmul"]) == (want, 0)
    got = chip_smoke.expected_launches(dense, "int8", 1536, 32, buckets)
    assert got["w8_matmul"] == 4 * 3 * 32
    got = chip_smoke.expected_launches(moe, "int8", 1536, 32, buckets)
    assert got["w8_matmul_expert"] == 16 * 3 and got["flash_attention"] == 3
    windowed = tiny_model_config(num_hidden_layers=3, model_type="mistral",
                                 sliding_window=4096)
    got = chip_smoke.expected_launches(windowed, "int8", 4608, 32, buckets)
    assert got.pop("w8_matmul") == 4 * 3 * (3 + 31)
    assert set(got.values()) == {0}
    assert chip_smoke.expected_launches(
        dense, "int8", 1536, 32, [128, 512])["flash_attention"] == 0
    # K8 is built for bf16 at head sizes 64, 96 and 128 only
    for dtype in (torch.float32, torch.float16):
        assert chip_smoke.expected_launches(
            dense, "int8", 1536, 32, buckets, dtype)["flash_attention"] == 0
    for dim, want in ((96, 3), (80, 0), (16, 0)):
        model = tiny_model_config(num_hidden_layers=3, head_dim=dim)
        assert chip_smoke.expected_launches(
            model, "int8", 1536, 32, buckets)["flash_attention"] == want


def test_k1_shapes_of_qwen25_7b_and_mistral_7b():
    """Qwen2.5-7B's widths make K1 pad and use other scale groups than
    Llama's 2048."""
    from vptq_tpu_torch.layers.runtime import pick_group

    shapes = chip_smoke.k1_shapes(chip_smoke.QWEN25_7B)
    assert shapes == [
        ("qkv", 4608, 3584), ("o", 3584, 3584),
        ("gate_up", 37888, 3584), ("down", 3584, 18944),
    ]
    groups = [pick_group(in_f) for _, _, in_f in shapes]
    assert groups == [512, 512, 512, 1024]
    assert [-(-in_f // g) * g for (_, _, in_f), g in zip(shapes, groups)] == [
        3584, 3584, 3584, 19456]
    qwen = tiny_model_config(**chip_smoke.QWEN25_7B)
    assert qwen.sliding_window is None and qwen.model_type == "qwen2"
    mistral = tiny_model_config(**chip_smoke.MISTRAL_7B)
    assert mistral.sliding_window == 4096
    assert chip_smoke.k1_shapes(chip_smoke.MISTRAL_7B) == chip_smoke.k1_shapes(
        chip_smoke.LLAMA31_8B)


def test_k1_shapes_of_llama31_8b():
    assert chip_smoke.k1_shapes(chip_smoke.LLAMA31_8B) == [
        ("qkv", 6144, 4096), ("o", 4096, 4096),
        ("gate_up", 28672, 4096), ("down", 4096, 14336),
    ]


def test_moe_shapes_of_mixtral_8x7b():
    assert chip_smoke.moe_shapes(chip_smoke.MIXTRAL_8X7B) == [
        ("gate_up", 28672, 4096), ("down", 4096, 14336),
    ]
    cfg = tiny_model_config(**chip_smoke.MIXTRAL_8X7B)
    assert (cfg.num_local_experts, cfg.num_experts_per_tok) == (8, 2)
    assert cfg.sliding_window is None


def _ptxas_log(entry: str, spill: int) -> str:
    return (
        f"ptxas info    : Compiling entry function '{entry}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {entry}\n"
        f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes "
        "spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers\n"
    )


@pytest.mark.parametrize("where,extra,spill,ok", [
    ("all", 0, 0, True),
    ("all", 0, 8, False),                   # every tile spills
    ("all", -1, 0, False),                  # an instance went missing
    ("all", None, 0, False),                # no -Xptxas -v lines
    ("w2_matmul", -1, 0, False),            # K3 lost a group's instance
    ("w2_matmul", 0, 8, False),             # K3's tile spills
    ("w4_matmul_expert", -1, 0, False),     # K6b lost one
    ("w4_matmul_expert", 0, 8, False),      # K6b's tile spills
    ("w8_matmul", -1, 0, False),            # K1 lost an out type's one
    ("w8_matmul", 0, 8, False),             # K1's tile spills
    ("w8_matmul_expert", -1, 0, False),     # K6a lost one
    ("w8_matmul_expert", 0, 8, False),      # K6a's tile spills
    ("bf16_matmul", -1, 0, False),          # K7 lost an out type's one
    ("bf16_matmul", 0, 8, False),           # K7's tile spills
    ("flash_attention", -1, 0, False),      # K8 lost a head size's one
    ("flash_attention", 0, 8, False),       # K8's kernel spills
    ("w4_matmul_pairs", 1, 0, False),       # a tile where none belongs
    ("decode:w8_matmul", -1, 0, False),     # K1 lost a decode GEMV instance
    ("decode:w8_matmul", 0, 8, False),      # K1's decode GEMV spills
    ("decode:w4_matmul", -1, 0, False),     # K2 lost a decode GEMV instance
    ("decode:w4_matmul", 0, 8, False),      # K2's decode GEMV spills
    ("decode:w3_matmul", -1, 0, False),     # K4 lost a decode GEMV instance
    ("decode:w3_matmul", 0, 8, False),      # K4's decode GEMV spills
    ("decode:w2_matmul", -1, 0, False),     # K3 lost a decode GEMV instance
    ("decode:w2_matmul", 0, 8, False),      # K3's decode GEMV spills
    ("decode:w4_matmul_pairs", -1, 0, False),  # K5b lost an out type's one
    ("decode:w4_matmul_pairs", 0, 8, False),   # K5b's decode GEMV spills
    ("decode:w8_matmul_expert", 1, 0, False),  # one where none belongs
])
def test_build_phase_requires_every_tile_instance_spill_free(
    monkeypatch, where, extra, spill, ok
):
    """The build phase passes only when each library of the prefill tile
    (K1, K2, K3, K4, K6a, K6b, K7) reports its number of tile instances,
    K8's library its instances of the attention kernel, K1's, K2's and
    K4's their four instances of the decode GEMV, K3's its eight (two
    scale groups) and K5b's its two (one token a pair, two output types),
    each with 0 spill bytes, and
    the other libraries none. ``where``: every table of one library, or
    (``decode:<library>``) its decode GEMV alone."""
    def tiles(name, instances, decode=False):
        want = instances.get(name, 0)
        hit = where in ("all", name) or (decode and where == f"decode:{name}")
        if not hit:
            return want, 0
        return (0 if extra is None else want + extra), spill

    def log(name):
        n, spilled = tiles(name, chip_smoke.TILE_INSTANCES)
        m, flash_spilled = tiles(name, chip_smoke.FLASH_INSTANCES)
        k, decode_spilled = tiles(name, chip_smoke.DECODE_INSTANCES, True)
        return "".join(
            _ptxas_log(f"_ZN6lowbit4tile7wg_tileI{name}{i}EEvv", spilled)
            for i in range(n)
        ) + "".join(
            _ptxas_log(f"_ZN2fa11flash_wgmmaILi{i}EEEvv{name}", flash_spilled)
            for i in range(m)
        ) + "".join(
            _ptxas_log(f"_ZN5dgemv11decode_gemvI{name}{i}EEvv", decode_spilled)
            for i in range(k)
        ) + _ptxas_log(f"_ZN6lowbit4gemv{name}", 0)

    logs = {name: log(name) for name in _build.SOURCES}
    monkeypatch.setattr(
        _build, "build",
        lambda force=False: {name: (0.0, log) for name, log in logs.items()},
    )
    if ok:
        chip_smoke.phase_build()
    else:
        with pytest.raises(AssertionError, match="tile"):
            chip_smoke.phase_build()


@pytest.mark.parametrize("name", sorted(chip_smoke.ALL_KERNELS))
def test_kernel_names_its_tpu_kernel_and_trace_tags(name):
    """A wrapper's ``replaces`` points at the Pallas kernel body it ports,
    and its ``trace_tags`` occur in its CUDA sources. No two kernels'
    tags pick the same CUDA kernel names."""
    fn, _ = chip_smoke.kernel_fns(name)
    for place in fn.replaces.split(", "):
        path, line = place.split(":")
        body = (ROOT / path).read_text().splitlines()[int(line) - 1]
        if name == "flash_attention":
            # the JAX package calls the library's Pallas op, it has no body
            assert body.strip() == "out = flash_attention(", body
        elif path.startswith("examples/"):
            # a probe script's body: _prod_kernel, _kernel, kernel, ...
            assert re.match(r"\s*def _?\w*kernel\(", body), body
        else:
            # _w8_kernel, _w8e_kernel (expert), _w8p_kernel (pairs), ...
            base, _, kind = name.partition("_matmul")
            assert body.startswith(f"def _{base}{kind[1:2]}_kernel("), body
    # a probe names its body per mode; each is one of replaces'
    assert set(getattr(fn, "bodies", {}).values()) <= set(
        fn.replaces.split(", "))
    csrc = ROOT / "vptq_tpu_torch/csrc"
    src = (csrc / f"{name}.cu").read_text()
    assert f'extern "C" int vptq_{name}(' in src
    # the headers it includes, and theirs
    for _ in range(2):
        for header in sorted(csrc.glob("*.cuh")):
            if f'#include "{header.name}"' in src:
                src += header.read_text()
    mine = chip_smoke.tag_sets(fn.trace_tags)
    assert all(tag in src for tags in mine for tag in tags)
    assert name in _build.SOURCES
    others = [tags for k in chip_smoke.ALL_KERNELS if k != name
              for tags in chip_smoke.tag_sets(chip_smoke.kernel_fns(k)[0].trace_tags)]
    assert all(set(a) - set(b) and set(b) - set(a)
               for a in mine for b in others)


# demangled names of the CUDA kernels of K1, K6a and of the kernels next to
# them, as a profiler trace shows them (the tile's template arguments: the
# format policy, the selection, the scale group within a stage, the output
# type and the scales' struct)
_TILE = ("void lowbit::tile::wg_tile<{p}, sel::{sel}, 128, float, "
         "lowbit::ScalesOf<{s}> >(lowbit::tile::Maps, lowbit::ScalesOf<{s}>, "
         "lowbit::Ids, float*, int, int, int, int)")
_W8 = ("void w8::w8_{k}<sel::{sel}, {t}__nv_bfloat16>(__nv_bfloat16 const*, "
       "signed char const*, float const*, __nv_bfloat16*, int const*, int, "
       "int, int, int, int)")
_GEMV = ("void lowbit::gemv<w4::W4, sel::{sel}, 16, 4, 128, float, "
         "__nv_bfloat16>(__nv_bfloat16 const*, lowbit::Planes, "
         "lowbit::ScalesOf<__nv_bfloat16>, lowbit::Ids, float*, int, int, "
         "int, int)")
_BF16_GEMV = ("void bf16mm::bf16_gemv<{t}, float>(__nv_bfloat16 const*, "
              "__nv_bfloat16 const*, float*, int, int, int)")
_DECODE = ("void dgemv::decode_gemv<{p}, sel::{sel}, {n}, {g}, {o}, {s}>("
           "__nv_bfloat16 const*, lowbit::Planes, lowbit::ScalesOf<{s}>, "
           "{o}*, int, int, int, int, lowbit::Ids)")
# K3's and K4's: their policies (anonymous namespace), scale group g
_ANON = "(anonymous namespace)::W{b}"
_LOWBIT_GEMV = _GEMV.replace("w4::W4", "{p}").replace(", 4, 128,", ", {g},")
_TILE_G = _TILE.replace(", 128, float", ", {g}, float")
KERNEL_NAMES = {
    "bf16_matmul": [_BF16_GEMV.format(t=1), _BF16_GEMV.format(t=16),
                    _TILE.format(p="bf16mm::BF16", sel="Whole", s="float")],
    "flash_attention": [
        f"void fa::flash_wgmma<{d}>(fa::Maps, __nv_bfloat16*, int, int, int, "
        "int, int, float)" for d in (64, 96, 128)],
    "w8_matmul": [_W8.format(k="gemv", sel="Whole", t="16, "),
                  _W8.format(k="gemm", sel="Whole", t=""),
                  _TILE.format(p="w8::W8", sel="Whole", s="float"),
                  *(_DECODE.format(p="w8::W8", sel="Whole", n=n, g=128, o=o,
                                   s="float")
                    for n in (1, 2) for o in ("float", "__nv_bfloat16"))],
    "w8_matmul_expert": [_W8.format(k="gemv", sel="Expert", t="16, "),
                         _W8.format(k="gemm", sel="Expert", t=""),
                         _TILE.format(p="w8::W8", sel="Expert", s="float")],
    "w8_matmul_pairs": [_W8.format(k="gemv", sel="Pairs", t="1, ")],
    "w4_matmul": [_GEMV.format(sel="Whole"),
                  _TILE.format(p="w4::W4", sel="Whole", s="__nv_bfloat16"),
                  *(_DECODE.format(p="w4::W4", sel="Whole", n=n, g=128, o=o,
                                   s="__nv_bfloat16")
                    for n in (1, 2) for o in ("float", "__nv_bfloat16"))],
    "w4_matmul_expert": [
        _GEMV.format(sel="Expert"),
        _TILE.format(p="w4::W4", sel="Expert", s="__nv_bfloat16")],
    "w4_matmul_pairs": [
        _GEMV.format(sel="Pairs"),
        *(_DECODE.format(p="w4::W4", sel="Pairs", n=1, g=128, o=o,
                         s="__nv_bfloat16")
          for o in ("float", "__nv_bfloat16"))],
    "w3_matmul": [
        _LOWBIT_GEMV.format(p=_ANON.format(b=3), sel="Whole", g="1, 128"),
        _TILE_G.format(p=_ANON.format(b=3), sel="Whole", g=128,
                       s="__nv_bfloat16"),
        *(_DECODE.format(p=_ANON.format(b=3), sel="Whole", n=n, g=128, o=o,
                         s="__nv_bfloat16")
          for n in (1, 2) for o in ("float", "__nv_bfloat16"))],
    "w2_matmul": [
        *(_LOWBIT_GEMV.format(p=_ANON.format(b=2), sel="Whole", g=f"1, {g}")
          for g in (64, 128)),
        *(_TILE_G.format(p=_ANON.format(b=2), sel="Whole", g=g,
                         s="__nv_bfloat16") for g in (64, 128)),
        *(_DECODE.format(p=_ANON.format(b=2), sel="Whole", n=n, g=g, o=o,
                         s="__nv_bfloat16")
          for n in (1, 2) for g in (64, 128)
          for o in ("float", "__nv_bfloat16"))],
}


@pytest.mark.parametrize("name", [
    *sorted(KERNEL_NAMES),
    # one family alone: the decode GEMV's instances of K2 (sel::Whole) and
    # of K5b (sel::Pairs), the same kernel template with another policy
    "w4_matmul@decode_gemv", "w4_matmul_pairs@decode_gemv",
])
def test_trace_tags_pick_each_kernel_family_and_no_other(name):
    """K1's and K6a's tags pick their GEMV's, their mma.sync tile's and
    their Hopper tile's names, K1's, K2's, K3's and K4's also their decode
    GEMV's (each instance; K3's and K4's at each scale group, whose
    policies lie in an anonymous namespace), K5b's its lowbit.cuh GEMV's
    and its decode GEMV's (sel::Pairs), K3's and K4's their
    lowbit.cuh GEMV's and their tile's, K7's its GEMV's and its SS tile's,
    K8's its kernel's at each head size, and no name of another kernel
    here (K2, K6b, K5a, K5b among them); no other kernel's tags pick
    theirs. ``kernel@family``: that kernel's tags of one family (the set
    ``check_decode_routes`` takes) pick its own decode GEMV instances and
    no other name, K2's not K5b's and K5b's not K2's."""
    name, _, family = name.partition("@")
    tags = chip_smoke.kernel_fns(name)[0].trace_tags
    if family:
        tags = tuple(t for t in chip_smoke.tag_sets(tags) if family in t)
        assert len(tags) == 1, tags
    for kernel, names in KERNEL_NAMES.items():
        for kernel_name in names:
            mine = kernel == name and (not family or family in kernel_name)
            assert chip_smoke.picks(tags, kernel_name) == mine, (
                name, kernel_name)


# (out, in_p, K1's group) of the decode GEMV's shapes: Llama-3.1-8B's four
# linears (qkv, o, gate_up, down; K1 at the loaders' group 2048) and
# Mixtral's attention among them, Qwen2.5-7B's (groups 512 and 1024; the
# intermediate padded to 19456; K1 only), then an out of 200, no multiple
# of a row block, at splits that cut a scale group (2048: 2 stages a rank
# of a 4-stage group; 4096: 4 of 8; 14336: 14 of 16)
LLAMA_DECODE = [(6144, 4096, 2048), (4096, 4096, 2048), (28672, 4096, 2048),
                (4096, 14336, 2048)]
QWEN_DECODE = [(4608, 3584, 512), (3584, 3584, 512), (38912, 3584, 512),
               (3584, 19456, 1024)]
ODD_DECODE = [(200, 2048, 512), (200, 4096, 1024), (200, 14336, 2048)]
# Moonlight-16B-A3B's (DeepSeek-V3) K1 / K2 shapes: q, kv_a (out 576, 4.5
# row blocks of 128), o, the dense layer's gate_up and down, the shared
# experts' gate_up and down (in 2816: int8 group 512 → 3072, int4 → 4096;
# 11264: int8 group 1024, int4 → 12288)
DEEPSEEK_DECODE = {
    "w8": [(3072, 2048, 2048), (576, 2048, 2048), (2048, 2048, 2048),
           (22528, 2048, 2048), (2048, 11264, 1024), (5632, 2048, 2048),
           (2048, 3072, 512)],
    "w4": [(3072, 2048, 128), (576, 2048, 128), (2048, 2048, 128),
           (22528, 2048, 128), (2048, 12288, 128), (5632, 2048, 128),
           (2048, 4096, 128)],
}


def _decode_positions(kernel, in_p):
    """(parts, positions of a row, planes, scale bytes a row and stage) of
    K1 (one part of in_p), K2 (two of in_p / 2), K4 (eight of in_p / 8, in
    three planes) or K3 (four of in_p / 4; groups 64 or 128)."""
    parts, planes, scale_bytes = DECODE_FORMATS[kernel]
    return parts, in_p // parts, planes, scale_bytes


@pytest.mark.parametrize("kernel,shape", [
    *(("w8", s) for s in LLAMA_DECODE + QWEN_DECODE),
    *((k, s) for k in ("w4", "w3", "w2g64", "w2g128") for s in LLAMA_DECODE),
])
def test_decode_split_puts_two_blocks_on_every_sm(kernel, shape):
    """At every T <= 16 the plan splits each shape of the main paths on
    whole 128-position stages into a cluster of 1, 2, 4 or 8 blocks, with
    two blocks or more for each of an H100's 132 SMs, whose x fits one
    block; at up to 8 tokens (decode runs one) two blocks fit one SM's
    shared memory, int3's ring of three planes' stages included. (Past 8
    tokens Qwen2.5-7B's down, 19 stages of x a block, leaves room for
    one; int3's o, 4 stages of 512 positions, makes 256 blocks of 64 rows
    at most.)"""
    out_f, in_p, _ = shape
    parts, positions, planes, scale_bytes = _decode_positions(kernel, in_p)
    assert positions % DECODE_STAGE == 0
    stages = positions // DECODE_STAGE
    for tokens in range(1, 17):
        split = decode_split(out_f, positions, parts, tokens, 132, planes,
                             scale_bytes)
        assert split in DECODE_SPLITS and split <= stages, (tokens, split)
        assert (decode_blocks(out_f, tokens) * split >= 2 * 132
                or split == stages), (tokens, split)
        per_block = decode_smem(parts, tokens, -(-stages // split), planes,
                                scale_bytes)
        assert per_block <= 232448, (tokens, per_block)
        if tokens <= 8:
            assert 2 * (per_block + 1024) <= 228 * 1024, (tokens, per_block)


@pytest.mark.parametrize("kernel,shape", [
    (k, s) for k, shapes in DEEPSEEK_DECODE.items() for s in shapes])
def test_decode_split_at_deepseek_shapes(kernel, shape):
    """DeepSeek's K1 / K2 shapes at every T <= 16: a split of whole stages
    whose x fits a block (two blocks an SM up to 8 tokens), making two
    blocks or more for each of an H100's 132 SMs where the largest split
    (8) can; Moonlight's narrow outs cannot (kv_a's 576 rows are 18 blocks
    of 32, or 9 of 64: 144 at split 8), and take split 8, the most blocks
    the plan makes."""
    out_f, in_p, _ = shape
    parts, positions, planes, scale_bytes = _decode_positions(kernel, in_p)
    stages = positions // DECODE_STAGE
    for tokens in range(1, 17):
        split = decode_split(out_f, positions, parts, tokens, 132, planes,
                             scale_bytes)
        assert split in DECODE_SPLITS and split <= stages, (tokens, split)
        enough = decode_blocks(out_f, tokens) * split >= 2 * 132
        assert enough or split in (stages, max(DECODE_SPLITS)), tokens
        if not enough and split < stages:
            assert decode_blocks(out_f, tokens) * max(DECODE_SPLITS) < 264
        per_block = decode_smem(parts, tokens, -(-stages // split), planes,
                                scale_bytes)
        assert per_block <= 232448, (tokens, per_block)
        if tokens <= 8:
            assert 2 * (per_block + 1024) <= 228 * 1024, (tokens, per_block)
    if out_f == 576:
        assert decode_split(576, positions, parts, 1, 132, planes,
                            scale_bytes) == 8


def test_decode_split_of_shapes_off_the_main_paths():
    """A small weight takes the largest split its stages allow (the most
    blocks); a width of no whole stages, or whose x no split fits into a
    block, or no token at all, is planned 0, and its wrapper sends it to
    the older GEMV."""
    assert decode_split(200, 2048, 1, 1, 132) == 8
    assert decode_split(200, 512, 1, 16, 132) == 4  # 4 stages
    assert decode_split(64, 128, 2, 3, 132) == 1
    assert decode_split(28672, 4096, 1, 1, 132) == 1
    assert decode_split(4096, 1000, 1, 1, 132) == 0  # no whole stages
    assert decode_split(4096, 65536, 1, 16, 132) == 0  # 256 KB of x a rank
    assert decode_split(4096, 65536, 1, 1, 132) == 4  # 128 blocks of 32
    assert decode_split(4096, 4096, 1, 0, 132) == 0
    assert decode_blocks(200, 1) == 7 and decode_blocks(200, 9) == 4
    assert decode_blocks(4096, 8) == 128 and decode_blocks(4096, 16) == 64
    # K4: eight parts of in_p / 8 in three planes, 16 scale bytes a row and
    # stage; a ring of two slots of 12 KB stages
    assert decode_smem(8, 1, 2, 3, 16) == (
        256 + 2 * 3 * 32 * 128 + 8 * 2 * 128 * 2 + 2 * 32 * 16 + 3 * 32 * 4)
    assert decode_split(200, 256, 8, 1, 132, 3, 16) == 2  # in_p 2048
    # in_p 28672 at 8 tokens: split 4 fits a block (x 112 KB a rank) but
    # not two an SM; 8 does
    assert decode_smem(8, 8, 7, 3, 16) <= 232448
    assert 2 * (decode_smem(8, 8, 7, 3, 16) + 1024) > 233472
    assert decode_split(4096, 3584, 8, 8, 132, 3, 16) == 8
    assert decode_split(4096, 1000, 8, 1, 132, 3, 16) == 0
    # K3: four parts of in_p / 4, one plane; 64 positions a group fold
    # twice a stage (16 scale bytes), 128 once (8)
    assert decode_smem(4, 16, 1, 1, 16) - decode_smem(4, 16, 1, 1, 8) == 64 * 8
    assert decode_split(200, 512, 4, 16, 132, 1, 16) == 4  # in_p 2048
    assert decode_split(28672, 1024, 4, 1, 132, 1, 16) == 1


# K5b at Mixtral-8x7B's two expert shapes (out, in_p) and P pairs: the
# split its plan gives. gate_up (2048 positions, 16 stages) makes 896 row
# blocks of 32 a pair, split 1 at every P; down (7168 positions, 56
# stages) makes 128 a pair: one pair needs split 4 (K2's at T = 1), two
# 2 (256 blocks, below 264), 16 and 128 split 1.
MIXTRAL_PAIRS = [
    ((28672, 4096), 1, 1), ((28672, 4096), 2, 1), ((28672, 4096), 16, 1),
    ((28672, 4096), 128, 1),
    ((4096, 14336), 1, 4), ((4096, 14336), 2, 2), ((4096, 14336), 16, 1),
    ((4096, 14336), 128, 1),
]
# and at DeepSeek's experts: Moonlight-16B-A3B's 64 (gate_up 2816 x 2048,
# down 2048 x 1408 padded to 2048; top 6: P = 6, 48 at 8 slots, 384 at 64
# tokens) and DeepSeek-R1's 256 (gate_up 4096 x 7168 padded to 8192, down
# 7168 x 2048; top 8: P = 8, 64): one pair takes K2's split, six or more
# split 1
DEEPSEEK_PAIRS = [
    ((2816, 2048), 1, 4), ((2816, 2048), 6, 1), ((2816, 2048), 48, 1),
    ((2816, 2048), 384, 1), ((2048, 2048), 1, 8), ((2048, 2048), 6, 1),
    ((2048, 2048), 48, 1), ((2048, 2048), 384, 1), ((4096, 8192), 1, 4),
    ((4096, 8192), 8, 1), ((4096, 8192), 64, 1), ((7168, 2048), 1, 2),
    ((7168, 2048), 8, 1), ((7168, 2048), 64, 1),
]


@pytest.mark.parametrize("shape,pairs,split", MIXTRAL_PAIRS + DEEPSEEK_PAIRS)
def test_decode_split_of_pairs_counts_every_pair(monkeypatch, shape, pairs,
                                                 split):
    """A pairs launch (K5b) runs one token a block and its row blocks once
    for each pair: the plan counts them all, gives the split above, and
    makes two blocks or more for each of an H100's 132 SMs with x and the
    ring in a block, two blocks an SM; the split one size smaller would
    not make two a SM (without the pairs, down would take 4 at P = 2).
    K5b's wrapper asks for the same plan from x's P rows."""
    from vptq_tpu_torch.ops import scaled_matmul

    out_f, in_p = shape
    parts, planes, scale_bytes = DECODE_FORMATS["w4"]
    positions = in_p // 2
    stages = positions // DECODE_STAGE
    got = decode_split(out_f, positions, parts, 1, 132, planes, scale_bytes,
                       pairs)
    assert got == split
    blocks = decode_blocks(out_f, 1) * pairs
    assert blocks * split >= 2 * 132
    assert split == 1 or blocks * (split // 2) < 2 * 132
    per_block = decode_smem(parts, 1, -(-stages // split), planes,
                            scale_bytes)
    assert 2 * (per_block + 1024) <= 228 * 1024
    monkeypatch.setattr(scaled_matmul, "sm_count", lambda device: 132)
    x = torch.zeros((pairs, in_p), dtype=torch.bfloat16)
    assert scaled_matmul.decode_route(out_f, positions, "w4", x,
                                      pairs=True) == split
    # the same rows as tokens of one weight: K2's plan
    if pairs <= 16:
        assert scaled_matmul.decode_route(out_f, positions, "w4", x) == (
            decode_split(out_f, positions, parts, pairs, 132, planes,
                         scale_bytes))


@pytest.mark.parametrize("kernel", ["w8_matmul", "w3_matmul"])
def test_decode_route_sends_few_tokens_on_small_weights_to_the_older_gemv(
        kernel):
    """K1 and K4 send the token counts and shapes at which their older
    GEMV measured faster than the decode GEMV (decode_splits, a clean L2)
    back to it: K1 one or two tokens at every shape; K4 one or two tokens
    on o (4096 x 4096) and on weights no larger (Qwen2.5-7B's qkv and o);
    every other count up to 16 takes the decode GEMV, and no count outside
    1..16 does."""
    rule = importlib.import_module(
        f"vptq_tpu_torch.ops.{kernel}").takes_decode_gemv
    qkv, o, gate_up, down = LLAMA_DECODE
    older = {"w8_matmul": {(t, s) for t in (1, 2)
                           for s in LLAMA_DECODE + QWEN_DECODE},
             "w3_matmul": {(t, s) for t in (1, 2)
                           for s in (o, *QWEN_DECODE[:2])}}[kernel]
    for shape in LLAMA_DECODE + QWEN_DECODE:
        for tokens in range(1, 17):
            want = (tokens, shape) not in older
            assert rule(tokens, *shape[:2]) == want, (tokens, shape)
        assert not rule(0, *shape[:2]) and not rule(17, *shape[:2])


def test_check_decode_routes_holds_each_call_to_its_route(monkeypatch):
    """The smoke's route check takes each call's kernel from one trace and
    passes when K3, K2 and K5b (two pairs) ran the decode GEMV and K1 and
    K4 the kernel their rule picks (K1 at one token: w8_gemv; K4 at one
    token on o: lowbit.cuh's GEMV); a call on another route fails it."""
    names = {
        ("w2_matmul", 16): _DECODE.format(p=_ANON.format(b=2), sel="Whole",
                                          n=2, g=64, o="float",
                                          s="__nv_bfloat16"),
        ("w4_matmul", 1): _DECODE.format(p="w4::W4", sel="Whole", n=1, g=128,
                                         o="float", s="__nv_bfloat16"),
        ("w4_matmul_pairs", 2): _DECODE.format(
            p="w4::W4", sel="Pairs", n=1, g=128, o="float",
            s="__nv_bfloat16"),
        ("w8_matmul", 1): _W8.format(k="gemv", sel="Whole", t="1, "),
        ("w3_matmul", 1): _LOWBIT_GEMV.format(p=_ANON.format(b=3),
                                              sel="Whole", g="4, 128"),
    }
    shape = {"w3_matmul": (4096, 4096)}  # o; the others at qkv's
    routes = [(dict(kernel=k, shape="s", T=t, group=128,
                    unit="P" if k.endswith("_pairs") else "T",
                    out=shape.get(k, (6144, 4096))[0],
                    in_p=shape.get(k, (6144, 4096))[1]), None)
              for k, t in names]
    got = list(names.values())
    monkeypatch.setattr(chip_smoke, "launched_kernels",
                        lambda calls, device: got)
    chip_smoke.check_decode_routes(routes, "cuda")
    got[0] = _LOWBIT_GEMV.format(p=_ANON.format(b=2), sel="Whole",
                                 g="1, 64")
    with pytest.raises(AssertionError, match="decode GEMV expected: True"):
        chip_smoke.check_decode_routes(routes, "cuda")


@pytest.mark.parametrize("ran", ["lowbit_gemv", "k2_decode_gemv"])
def test_check_decode_routes_holds_pairs_calls_to_the_decode_gemv(
        monkeypatch, ran):
    """K5b's calls must run its own decode GEMV (sel::Pairs): at P = 1, 2,
    16 and 128 a pairs call that ran lowbit.cuh's GEMV fails the check,
    and so does one whose name is K2's decode GEMV (sel::Whole)."""
    pairs = _DECODE.format(p="w4::W4", sel="Pairs", n=1, g=128,
                           o="__nv_bfloat16", s="__nv_bfloat16")
    wrong = {"lowbit_gemv": _GEMV.format(sel="Pairs"),
             "k2_decode_gemv": pairs.replace("sel::Pairs", "sel::Whole")}[ran]
    routes = [(dict(kernel="w4_matmul_pairs", shape=shape, unit="P", T=n,
                    group=128, out=out_f, in_p=in_p), None)
              for shape, out_f, in_p in chip_smoke.moe_shapes(
                  chip_smoke.MIXTRAL_8X7B)
              for n in (1, 2, 16, 128)]
    got = [pairs] * len(routes)
    monkeypatch.setattr(chip_smoke, "launched_kernels",
                        lambda calls, device: got)
    chip_smoke.check_decode_routes(routes, "cuda")
    got[-1] = wrong
    with pytest.raises(AssertionError, match="P=128 ran"):
        chip_smoke.check_decode_routes(routes, "cuda")


class _Event:
    def __init__(self, name, us):
        self.name, self.device_time_total = name, us


def test_decode_breakdown_attributes_each_kernel_to_one_family():
    """The decode step's device time per kernel: K2's and K5b's decode
    GEMV instances are summed apart (sel::Whole, sel::Pairs); a name that
    two kernels' tags pick fails the breakdown rather than count twice."""
    whole = _DECODE.format(p="w4::W4", sel="Whole", n=1, g=128,
                           o="__nv_bfloat16", s="__nv_bfloat16")
    pairs = whole.replace("sel::Whole", "sel::Pairs")
    events = [_Event(whole, 30.0), _Event(pairs, 110.0), _Event(pairs, 10.0),
              _Event("void at::native::elementwise_kernel<128, 4>()", 5.0)]
    tags = {k: chip_smoke.kernel_fns(k)[0].trace_tags
            for k in ("w4_matmul", "w4_matmul_pairs")}
    got = chip_smoke._kernel_ms(events, tags, "decode", per=2)
    assert got == {"w4_matmul": 0.015, "w4_matmul_pairs": 0.06}
    # tags that would pick both (K2's before it named its selection)
    tags["w4_matmul"] = (("decode_gemv", "W4"),)
    with pytest.raises(AssertionError, match="picked by"):
        chip_smoke._kernel_ms(events, tags, "decode")


@pytest.mark.parametrize("fmt,family", [
    ("int8", "llama"), ("int4", "llama"), ("int4", "mixtral"),
])
def test_step_routes_hold_each_decode_kernel_to_its_route(tmp_path, fmt,
                                                          family):
    """A decode step's trace against the routes of one token: int8's
    linears on w8_gemv (K1 takes the decode GEMV from 3 tokens on), int4's
    and K5b's on the decode GEMV (sel::Whole, sel::Pairs); a family off
    the route, or one missing, fails."""
    from vptq_tpu_torch.models.loader import load_model

    cfg = dict(TINY, tie_word_embeddings=False)
    if family == "mixtral":
        cfg.update(model_type="mixtral", num_local_experts=4,
                   num_experts_per_tok=2)
    write_synthetic_checkpoint(tmp_path, tiny_model_config(**cfg),
                               vq_kwargs=VQ, seed=0)
    model = load_model(str(tmp_path), runtime_format=fmt, device="cpu")
    calls = chip_smoke.decode_calls(model, fmt)
    kernel = chip_smoke.FORMAT_KERNEL[fmt]
    if family == "mixtral":
        assert [k for k, _, _ in calls] == [kernel] * 2 + [
            "w4_matmul_pairs"] * 2 + [kernel] * 2 + ["w4_matmul_pairs"] * 2
    else:
        assert [k for k, _, _ in calls] == [kernel] * 8
    whole = (_W8.format(k="gemv", sel="Whole", t="1, ") if fmt == "int8"
             else _DECODE.format(p="w4::W4", sel="Whole", n=8, g=128,
                                 o="__nv_bfloat16", s="__nv_bfloat16"))
    step = [_Event(whole, 1.0)] * 4
    if family == "mixtral":
        step += [_Event(whole.replace("sel::Whole", "sel::Pairs"), 1.0)] * 4
    got = chip_smoke.step_routes(step, model, fmt, "step")
    assert got[kernel] == (["w8_gem Whole"] if fmt == "int8"
                           else ["decode_gemv W4 Whole"])
    off_route = (_DECODE.format(p="w8::W8", sel="Whole", n=8, g=2048,
                                o="__nv_bfloat16", s="float")
                 if fmt == "int8" else _GEMV.format(sel="Whole"))
    with pytest.raises(AssertionError, match="routes say"):
        chip_smoke.step_routes(step + [_Event(off_route, 1.0)], model, fmt,
                               "step")
    with pytest.raises(AssertionError, match="routes say"):
        chip_smoke.step_routes(step[:1] if family == "mixtral" else [],
                               model, fmt, "step")


@pytest.mark.parametrize("fmt,family", [
    ("int8", "llama"), ("int4", "llama"), ("int4", "mixtral"),
])
def test_step_routes_hold_a_batched_step_to_its_routes(tmp_path, fmt,
                                                        family):
    """The batched step of 8 slots (one token a slot): int8's linears on the
    decode GEMV at T = 8 (``w8_gemv`` takes 1 and 2 tokens only), int4's
    on the decode GEMV, K5b at P = 16 on ``sel::Pairs``; a one-token
    trace fails the 8-token routes."""
    from vptq_tpu_torch.models.loader import load_model

    cfg = dict(TINY, tie_word_embeddings=False)
    if family == "mixtral":
        cfg.update(model_type="mixtral", num_local_experts=4,
                   num_experts_per_tok=2)
    write_synthetic_checkpoint(tmp_path, tiny_model_config(**cfg),
                               vq_kwargs=VQ, seed=0)
    model = load_model(str(tmp_path), runtime_format=fmt, device="cpu")
    kernel = chip_smoke.FORMAT_KERNEL[fmt]
    fam = ("w8::W8", 2048, "float") if fmt == "int8" else (
        "w4::W4", 128, "__nv_bfloat16")
    whole = _DECODE.format(p=fam[0], sel="Whole", n=8, g=fam[1],
                           o="__nv_bfloat16", s=fam[2])
    step = [_Event(whole, 1.0)] * 4
    if family == "mixtral":
        step += [_Event(_DECODE.format(
            p="w4::W4", sel="Pairs", n=8, g=128, o="__nv_bfloat16",
            s="__nv_bfloat16"), 1.0)] * 4
    got = chip_smoke.step_routes(step, model, fmt, "batched step", tokens=8)
    assert got[kernel] == [f"decode_gemv {fam[0][-2:]} Whole"]
    if family == "mixtral":
        assert got["w4_matmul_pairs"] == ["decode_gemv W4 Pairs"]
    if fmt == "int8":
        one = [_Event(_W8.format(k="gemv", sel="Whole", t="1, "), 1.0)] * 4
        with pytest.raises(AssertionError, match="routes say"):
            chip_smoke.step_routes(one, model, fmt, "batched step", tokens=8)
        assert chip_smoke.step_routes(one, model, fmt, "step") == {
            kernel: ["w8_gem Whole"]}


def test_launches_of_batched_calls():
    """The serving phase's counts: per layer and forward call 4 of a dense
    format's kernel; K8 once a layer for a fresh call of 2048 tokens a row
    whatever its rows (the batched admission, B = 4); a MoE block's call of
    8 one-token slots through the pairs kernel (P = 16), of 4 rows of 128
    through the expert kernel 2·E times."""
    dense = tiny_model_config(num_hidden_layers=3, head_dim=128)
    calls = [(4, 2048, True), (4, 128, True), (1, 512, False)] + [
        (8, 1, False)] * 10
    got = chip_smoke.launches_of(dense, "int4", calls)
    assert got.pop("w4_matmul") == 4 * 3 * 13
    assert got.pop("flash_attention") == 3
    assert set(got.values()) == {0}
    moe = tiny_model_config(num_hidden_layers=3, model_type="mixtral",
                            num_local_experts=8, num_experts_per_tok=2,
                            head_dim=128)
    got = chip_smoke.launches_of(moe, "int4", calls)
    assert got.pop("w4_matmul") == 2 * 3 * 13
    assert got.pop("w4_matmul_pairs") == 2 * 3 * 10
    assert got.pop("w4_matmul_expert") == 16 * 3 * 3
    assert got.pop("flash_attention") == 3
    assert set(got.values()) == {0}
    # 64 tokens in all still take the pairs kernel; 65 the experts
    got = chip_smoke.launches_of(moe, "int8", [(8, 8, False), (5, 13, False)])
    assert (got["w8_matmul_pairs"], got["w8_matmul_expert"]) == (6, 48)
    windowed = tiny_model_config(num_hidden_layers=3, model_type="phi3",
                                 num_key_value_heads=4, head_dim=96,
                                 sliding_window=2047)
    assert chip_smoke.launches_of(windowed, "int8", calls)[
        "flash_attention"] == 0


def test_chip_smoke_serving_on_cpu():
    """The serving phase at a tiny size with the plain versions: requests
    of four prompt lengths through the Scheduler with its prefix cache
    (the longest share a head: a hit), two of them stopping at an EOS, the
    logits of every prefill and first decode step equal to the Generator's,
    the prefill calls the launch count is computed from."""
    cfg = dict(TINY, tie_word_embeddings=False)
    path, _ = chip_smoke.write_checkpoint(cfg, VQ)
    try:
        e2e = chip_smoke.phase_e2e(
            "cpu", path, "int4", TINY["vocab_size"], prompt_lens=(5,),
            new_tokens=2, max_seq=256,
            serve=dict(prompt_lens=(5, 20, 70, 150), per_len=2, shared=64,
                       serve=dict(max_seq=256, prompt_buckets=(16, 64, 128))),
        )
    finally:
        shutil.rmtree(path, ignore_errors=True)
    served = e2e["serving"]
    assert served["requests"] == 8 and served["slots"] == 8
    assert served["prefix_hits"] >= 1 and served["launches"] == {}
    assert served["logits_max_rel_diff"] == 0.0
    assert served["greedy_token_agreement"] == [1.0] * 4
    assert served["eos_fired"] == 2 and served["warm"]["eos_fired"] == 2
    assert sorted(served["ttft_s"]) == [5, 20, 70, 150]
    # fresh prompts of one bucket ride batched admissions of one row a
    # prompt (here each admission step holds one prompt a bucket: no
    # padded row); the 150-token ones take two chunks, the prefix hit its
    # rest at an offset
    calls = served["prefill_calls"]
    assert [1, 16, True] in calls and [1, 128, True] in calls
    assert {rows for rows, _, _ in calls} == {1}
    assert any(not fresh for _, _, fresh in calls)
    assert served["stats"]["batched_admissions"] >= 4


# a tiny DeepSeek-V3 at Moonlight-16B-A3B's layout: MLA without q_lora, a
# dense first layer, 8 experts in one group, top 3, two shared experts
TINY_DEEPSEEK = dict(
    TINY, model_type="deepseek_v3", num_hidden_layers=3,
    num_key_value_heads=4, kv_lora_rank=16, qk_nope_head_dim=16,
    qk_rope_head_dim=8, v_head_dim=16, rope_interleave=True,
    moe_intermediate_size=32, n_routed_experts=8, num_experts_per_tok=3,
    n_shared_experts=2, routed_scaling_factor=2.446,
    first_k_dense_replace=1, tie_word_embeddings=False,
)


def test_chip_smoke_deepseek_on_cpu():
    """The smoke's DeepSeek run at a tiny size with the plain versions:
    from_pretrained, a short and a long request (the latter's prefill
    through every expert), the 8-slot Scheduler with a prefix hit; the
    smoke's launch rule counts MLA's q, kv_a and o, the dense layer's and
    the shared experts' gate_up and down, 2 pairs calls a MoE layer and
    step, 2·E expert calls a MoE layer and long chunk, and no K8; the
    decode calls name every K1 / K2 linear and the pairs calls."""
    from vptq_tpu_torch.models.llama import ModelConfig
    from vptq_tpu_torch.models.loader import load_model

    cfg = ModelConfig(**TINY_DEEPSEEK)
    assert chip_smoke.layer_linears(cfg) == (15, 2, 8)
    got = chip_smoke.launches_of(cfg, "int4", [(1, 2048, True), (8, 1, False)])
    assert {k: n for k, n in got.items() if n} == {
        "w4_matmul": 30, "w4_matmul_expert": 32, "w4_matmul_pairs": 4}
    path, _ = chip_smoke.write_checkpoint(TINY_DEEPSEEK, VQ)
    try:
        model = load_model(path, runtime_format="int8", device="cpu")
        calls = chip_smoke.decode_calls(model, "int8")
        assert [c[1:] for c in calls[:5]] == [
            (96, 512), (24, 512), (64, 512), (256, 512), (64, 512)]
        assert [c[0] for c in calls].count("w8_matmul_pairs") == 4
        assert len(calls) == 15 + 4
        del model
        e2e = chip_smoke.phase_e2e(
            "cpu", path, "int4", TINY["vocab_size"], prompt_lens=(5, 70),
            new_tokens=2, max_seq=256,
            serve=dict(prompt_lens=(5, 20, 70), per_len=2, shared=64,
                       serve=dict(max_seq=256, prompt_buckets=(16, 128))),
        )
    finally:
        shutil.rmtree(path, ignore_errors=True)
    assert e2e["kernels"] == [
        "w4_matmul", "w4_matmul_expert", "w4_matmul_pairs"]
    served = e2e["serving"]
    assert served["prefix_hits"] >= 1 and served["logits_max_rel_diff"] == 0
    assert served["greedy_token_agreement"] == [1.0] * 2
    assert served["eos_fired"] == 2 and served["warm"]["eos_fired"] == 2


def test_profile_decode_runs_the_plain_versions_on_cpu(capsys):
    """profile_decode at a tiny width on the CPU: the card line first, the
    four linears, the lm_head and their sum, then the eager step (the CPU
    has no graphs)."""
    profile_decode.main(["--device", "cpu", "--tiny", "--int3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("# cpu") and lines[-1] == lines[0]
    assert [ln.split()[0] for ln in lines[2:7]] == [
        "qkv", "o", "gate_up", "down", "lm_head"]
    assert lines[7].startswith("linears sum:")
    assert lines[8] == "graphed step: not on the CPU (no CUDA graphs)"
    assert lines[9].startswith("full step (eager):")


def test_moe_phase_takes_one_pair_and_routes_only_card_calls():
    """phase_moe_kernels at P = 1 (one expert) and P = 3 (two tokens'
    top-2, the first three): the ids are the first P of ⌈P / 2⌉ tokens'
    picks; on the CPU no call joins the route check."""
    shapes = [("a", 40, 1024)]
    routes = []
    rows = chip_smoke.phase_moe_kernels(
        "int4", "cpu", shapes, n_experts=4, tokens=(1,), pairs=(1, 3),
        iters=1, routes=routes)
    pair_rows = [r for r in rows if r["unit"] == "P"]
    assert [r["T"] for r in pair_rows] == [1, 3]
    assert pair_rows[0]["distinct"] == 1
    assert pair_rows[1]["distinct"] in (2, 3)
    assert all(r["max_abs_err"] == 0.0 for r in rows)
    assert routes == []


def test_sass_diff_maps_renamed_kernels_onto_their_old_names():
    """sass_diff's rewrites compare a kernel whose name took the selection
    policy (and the ids) with the parent's name for it, in the form
    ``cu++filt`` prints (template parameters numbered in the argument
    types); a rewrite that gives two kernels one name fails."""
    from vptq_tpu_torch.examples import sass_diff

    def name(p, sel, n, g, t):
        sel = f"sel::{sel}, " if sel else ""
        return (f"void dgemv::decode_gemv<{p}, {sel}(int){n}, (int){g}, "
                "float, __nv_bfloat16>(const __nv_bfloat16 *, "
                f"lowbit::Planes, lowbit::ScalesOf<T{t + 1}>, T{t} *, int, "
                "int, int, int)")

    listing = "".join(
        f"\tFunction : {mangled}\n"
        "        /*0000*/                   MOV R1, c[0x0][0x28] ;"
        "  /* 0x00000a0000017a02 */\n"
        for mangled in ("_Z1a", "_Z1b", "_Z1c"))
    funcs = sass_diff.functions(listing, keep_hash=True)
    assert list(funcs) == ["_Z1a", "_Z1b", "_Z1c"]
    assert funcs["_Z1a"] == ["MOV R1, c[0x0][0x28]"]
    new = [name("w4::W4", "Whole", 1, 128, 5),
           name("<unnamed>::W2", "Whole", 2, 64, 5),
           name("w4::W4", "Pairs", 1, 128, 5)[:-1] + ", lowbit::Ids)"]
    demangled = dict(zip(funcs, new))
    rules = [(r"(decode_gemv<.*?), sel::Whole(,.*ScalesOf<)T6>, T5 \*",
              r"\1\2T5>, T4 *"),
             (r"(decode_gemv<.*), lowbit::Ids\)$", r"\1)")]
    got = sass_diff.rewrite_names(
        funcs, rules, lambda names: [demangled[n] for n in names])
    assert list(got) == [name("w4::W4", None, 1, 128, 4),
                         name("<unnamed>::W2", None, 2, 64, 4),
                         name("w4::W4", "Pairs", 1, 128, 5)]
    with pytest.raises(SystemExit, match="two kernels"):
        sass_diff.rewrite_names(funcs, [(r"sel::\w+, ", "")],
                                lambda names: [new[0], new[0], new[1]])


def test_decode_splits_exits_nonzero_without_a_card(monkeypatch):
    from vptq_tpu_torch.examples import decode_splits

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        decode_splits.main(["--kernels", "w4p"])
    assert exc.value.code not in (0, None)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [1, 3, 16, 17, 40])
def test_k1_kernel_matches_plain_version(cuda, tokens):
    gen = torch.Generator(device=cuda).manual_seed(tokens)
    wq = torch.randint(-127, 128, (200, 2048), generator=gen, device=cuda,
                       dtype=torch.int8)
    scales = torch.rand((4, 200), generator=gen, device=cuda) * 1e-2
    x = torch.randn((tokens, 2048), generator=gen, device=cuda)
    before = w8_matmul.launches
    got = w8_matmul(x, wq, scales)
    want = w8_matmul_reference(x, wq, scales)
    torch.cuda.synchronize()
    assert w8_matmul.launches == before + 1
    torch.testing.assert_close(
        got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item()
    )


def _lowbit_case(kernel, gen, device, out_f=200, in_p=2048):
    def codes(n):
        return torch.randint(-128, 128, (out_f, n), generator=gen,
                             device=device, dtype=torch.int8)

    def scales(*shape):
        return (torch.rand(shape, generator=gen, device=device) * 1e-2).to(
            torch.bfloat16)

    if kernel == "w4":
        return w4_matmul, w4_matmul_reference, (
            codes(in_p // 2), scales(in_p // 128, out_f))
    if kernel == "w3":
        return w3_matmul, w3_matmul_reference, (
            codes(in_p // 4), codes(in_p // 8), scales(out_f, in_p // 128))
    group = int(kernel[len("w2g"):])
    return w2_matmul, w2_matmul_reference, (
        codes(in_p // 4), scales(out_f, in_p // group))


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tokens", [1, 3, 16, 17, 40])
@pytest.mark.parametrize("kernel", ["w4", "w2g64", "w2g128", "w3"])
def test_lowbit_kernel_matches_plain_version(cuda, kernel, tokens, out_dtype):
    gen = torch.Generator(device=cuda).manual_seed(tokens)
    fn, ref, weights = _lowbit_case(kernel, gen, cuda)
    x = torch.randn((tokens, 2048), generator=gen, device=cuda)
    before = fn.launches
    got = fn(x, *weights, out_dtype=out_dtype)
    want = ref(x, *weights, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.shape == (tokens, 200) and got.dtype == out_dtype
    # both sum exact products in f32 per group: in f32 only the summation
    # order differs; in bf16, one ulp of the final rounding
    rtol = 1e-5 if out_dtype == torch.float32 else 1e-2
    torch.testing.assert_close(
        got.float(), want.float(), rtol=rtol,
        atol=rtol * want.float().abs().max().item(),
    )


@pytest.mark.cuda
@pytest.mark.parametrize(
    "out_dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("in_p", ["min", 14336])
@pytest.mark.parametrize("tokens", [17, 40, 64, 65, 128, 300, 512])
@pytest.mark.parametrize("kernel", ["w4", "w3", "w2g64", "w2g128"])
def test_lowbit_tile_matches_plain_version(cuda, kernel, tokens, in_p,
                                           out_dtype):
    """K2, K3 and K4 past the GEMV run the Hopper tile: one token tile
    (T <= 128) and several, ragged T, 200 rows (ragged out), the format's
    smallest width (K2 256; K4 and K3 1024, one stage a part) and down's
    depth (many turns of the ring), K3 at both scale groups (64: two
    groups of each part in a stage), f32 / bf16 / fp16 out."""
    in_p = {"w4": 256}.get(kernel, 1024) if in_p == "min" else in_p
    gen = torch.Generator(device=cuda).manual_seed(tokens + in_p)
    fn, ref, weights = _lowbit_case(kernel, gen, cuda, in_p=in_p)
    x = torch.randn((tokens, in_p), generator=gen, device=cuda)
    before = fn.launches
    got = fn(x, *weights, out_dtype=out_dtype)
    want = ref(x, *weights, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.shape == (tokens, 200) and got.dtype == out_dtype
    _assert_kernel_close(got, want, out_dtype)


# (in_p, group) of the int8 layers the loaders make: groups 512, 1024 and
# 2048 (pick_group) at Llama-3.1-8B's and Qwen2.5-7B's widths, where the
# group divides in_p (19456: Qwen2.5-7B's intermediate, padded)
K1_WIDTHS = [(in_p, group) for in_p in (2048, 3584, 14336, 19456)
             for group in (512, 1024, 2048) if in_p % group == 0]


def _int8_case(gen, device, out_f, in_p, group, n_experts=None):
    """Random int8 codes and f32 scales of (in_p / group, out) layout,
    stacked when ``n_experts`` is given."""
    lead = () if n_experts is None else (n_experts,)
    wq = torch.randint(-128, 128, (*lead, out_f, in_p), generator=gen,
                       device=device, dtype=torch.int8)
    scales = torch.rand((*lead, in_p // group, out_f), generator=gen,
                        device=device) * 1e-2
    return wq, scales


@pytest.mark.cuda
@pytest.mark.parametrize(
    "out_dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("in_p,group", K1_WIDTHS)
@pytest.mark.parametrize("out_f", [200, 14336])
@pytest.mark.parametrize("tokens", [17, 40, 128, 130, 300, 512, 2048])
def test_k1_tile_matches_plain_version(cuda, tokens, out_f, in_p, group,
                                       out_dtype):
    """K1 past the GEMV runs the Hopper tile with the W8 policy: one token
    tile and several, ragged T and out (200 rows), gate_up's rows
    (14336), a scale group of 4 to 16 stages summed in acc before one fold
    (groups 512, 1024, 2048, one group to 38 of them), f32 / bf16 / fp16
    out."""
    gen = torch.Generator(device=cuda).manual_seed(tokens + out_f + in_p)
    wq, scales = _int8_case(gen, cuda, out_f, in_p, group)
    x = torch.randn((tokens, in_p), generator=gen, device=cuda)
    before = w8_matmul.launches
    got = w8_matmul(x, wq, scales, out_dtype=out_dtype)
    want = w8_matmul_reference(x, wq, scales, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert w8_matmul.launches == before + 1
    assert got.shape == (tokens, out_f) and got.dtype == out_dtype
    _assert_kernel_close(got, want, out_dtype)


def _decode_case(kernel, gen, device, shape):
    """(wrapper, plain version, weights) of K1 (int8 codes, f32 scales at
    the shape's group), K2, K4 or K3 (their bytes and bf16 scales; K3 at
    the group its name gives) at one shape."""
    out_f, in_p, group = shape
    if kernel == "w8":
        return w8_matmul, w8_matmul_reference, _int8_case(
            gen, device, out_f, in_p, group)
    return _lowbit_case(kernel, gen, device, out_f=out_f, in_p=in_p)


def _decode_everywhere(monkeypatch):
    """K1's and K4's wrappers take the decode GEMV at every token count up
    to 16 (their rules send some to the older GEMV)."""
    for name in ("w8_matmul", "w3_matmul"):
        monkeypatch.setattr(importlib.import_module(f"vptq_tpu_torch.ops.{name}"),
                            "takes_decode_gemv", lambda *a: True)


def _assert_smoke_close(got, want):
    """chip_smoke.py's bound: |err| <= RTOL·|plain| + ATOL_FRAC·max|plain|."""
    g, w = got.float(), want.float()
    limit = chip_smoke.RTOL * w.abs() + chip_smoke.ATOL_FRAC * w.abs().max()
    assert bool(torch.all((g - w).abs() <= limit)), (g - w).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "out_dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("tokens", [1, 2, 3, 8, 9, 16])
@pytest.mark.parametrize("kernel,shape", [
    *(("w8", s) for s in LLAMA_DECODE + QWEN_DECODE + ODD_DECODE),
    *(("w4", s) for s in LLAMA_DECODE + QWEN_DECODE + ODD_DECODE),
    *((k, s) for k in ("w3", "w2g64", "w2g128")
      for s in LLAMA_DECODE + ODD_DECODE),
    *((k, s) for k, shapes in DEEPSEEK_DECODE.items() for s in shapes),
])
def test_decode_gemv_matches_plain_version(cuda, monkeypatch, kernel, shape,
                                           tokens, out_dtype):
    """K1–K4 up to 16 tokens run the Hopper decode GEMV: both token tiles
    (N = 8 up to 8 tokens, 16 past them) at every shape of the main paths
    and at an out of 200; K1 at groups 512, 1024 and 2048, where the
    cluster's split cuts a group (summed unscaled across ranks); K4's
    three planes; K3 at groups 64 (two folds a stage) and 128; f32, bf16
    and fp16 out, at every token count, also those at which K1's and K4's
    wrappers route a shape to their older GEMV. One launch a call."""
    _decode_everywhere(monkeypatch)
    gen = torch.Generator(device=cuda).manual_seed(sum(shape) + tokens)
    fn, ref, weights = _decode_case(kernel, gen, cuda, shape)
    x = torch.randn((tokens, shape[1]), generator=gen, device=cuda)
    before = fn.launches
    got = fn(x, *weights, out_dtype=out_dtype)
    want = ref(x, *weights, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.shape == (tokens, shape[0]) and got.dtype == out_dtype
    _assert_smoke_close(got, want)
    _assert_kernel_close(got, want, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [1, 16])
@pytest.mark.parametrize("kernel", ["w8", "w4", "w3", "w2g64", "w2g128"])
def test_decode_gemv_is_bit_equal_and_runs_on_the_current_stream(
        cuda, monkeypatch, kernel, tokens):
    """Two launches on the same inputs give the same bits (the cluster
    reduces in rank order, no atomics), on a side stream as on the
    default one, at a shape of a cluster of 8 (K1: whose split cuts a
    scale group)."""
    _decode_everywhere(monkeypatch)
    gen = torch.Generator(device=cuda).manual_seed(tokens)
    shape = (200, 14336, 2048)
    fn, ref, weights = _decode_case(kernel, gen, cuda, shape)
    x = torch.randn((tokens, shape[1]), generator=gen, device=cuda)
    first = fn(x, *weights, out_dtype=torch.float32)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        second = fn(x, *weights, out_dtype=torch.float32)
    stream.synchronize()
    assert torch.equal(first, second)
    _assert_kernel_close(second, ref(x, *weights, out_dtype=torch.float32),
                         torch.float32)


def _int8_route_case(kernel, gen, device, group, tokens, in_p=1536):
    """K1 or K6a (expert 2 of 3) on bf16 x (so that the wrapper launches no
    cast) at a scale group that divides in_p: 24 groups of 64, 16 of 96, 3
    of 512. Returns (wrapper, plain version, args)."""
    x = torch.randn((tokens, in_p), generator=gen, device=device).to(
        torch.bfloat16)
    fn, ref = chip_smoke.kernel_fns(kernel)
    if kernel == "w8_matmul":
        return fn, ref, (x, *_int8_case(gen, device, 200, in_p, group))
    return fn, ref, (
        x, *_int8_case(gen, device, 200, in_p, group, n_experts=3),
        torch.tensor(2, dtype=torch.int32, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tokens", [3, 17, 40, 300])
@pytest.mark.parametrize("group", [64, 96, 512])
@pytest.mark.parametrize("kernel", ["w8_matmul", "w8_matmul_expert"])
def test_int8_groups_route_by_shape(cuda, kernel, group, tokens, out_dtype):
    """A scale group that is no multiple of the tile's 128-position stage
    (64, 96: the wrappers take any multiple of 32; no loader makes one)
    runs w8_gemm past 16 tokens, a group of whole stages the tile: each
    route matches the plain version, with one launch a call
    (test_int8_route_shows_in_the_kernel_names sees which kernel runs)."""
    gen = torch.Generator(device=cuda).manual_seed(group + tokens)
    fn, ref, args = _int8_route_case(kernel, gen, cuda, group, tokens)
    before = fn.launches
    got = fn(*args, out_dtype=out_dtype)
    want = ref(*args, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    _assert_kernel_close(got, want, out_dtype)


@pytest.mark.cuda
def test_int8_route_shows_in_the_kernel_names(cuda):
    """One profiler session (many short sessions in one process now and
    then record no device event at all) over K1 and K6a at groups 64, 96
    and 512 and T 3 and 40, K2 at T 3 and 40, K7 at T 3 and 40 and K8 at
    head sizes 64, 96 and 128: each call launches one kernel, the one its
    shape picks: up to 16 tokens K1's decode GEMV for a group of whole
    128-column stages where its rule takes it (from 3 tokens)
    and w8_gemv elsewhere, for another group or for K6a; past them
    the tile for a group of whole stages, w8_gemm for another group; K2's
    decode GEMV up to 16 tokens and its tile past them; K7's GEMV up to 16
    tokens and the tile's SS instance past them; K8's warp-specialised
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=cuda).manual_seed(0)
    calls, routes = [], []
    for kernel in ("w8_matmul", "w8_matmul_expert"):
        for group in (64, 96, 512):
            for tokens in (3, 40):
                fn, _, args = _int8_route_case(kernel, gen, cuda, group,
                                               tokens)
                calls.append(lambda f=fn, a=args: f(*a))
                whole = (kernel == "w8_matmul" and group % 128 == 0
                         and w8_takes_decode_gemv(tokens, 200, 1536))
                routes.append(
                    ("decode_gemv<w8::W8" if whole else "w8_gemv")
                    if tokens <= 16 else
                    "wg_tile" if group % 128 == 0 else "w8_gemm")
    for tokens in (3, 40):
        _, _, w4_args = _lowbit_case("w4", gen, cuda)
        x = torch.randn((tokens, 2048), generator=gen, device=cuda).to(
            torch.bfloat16)
        calls.append(lambda x=x, a=w4_args: w4_matmul(x, *a))
        routes.append("decode_gemv<w4::W4" if tokens <= 16 else
                      "wg_tile<w4::W4")
    w = (torch.randn((200, 1024), generator=gen, device=cuda) * 0.05).to(
        torch.bfloat16)
    for tokens in (3, 40):
        x = torch.randn((tokens, 1024), generator=gen, device=cuda).to(
            torch.bfloat16)
        calls.append(lambda x=x: bf16_matmul(x, w))
        routes.append("bf16_gemv" if tokens <= 16 else "wg_tile<bf16mm::BF16")
    for dim in (64, 96, 128):
        qkv = _flash_case(gen, cuda, 1, 300, 4, 2, dim)
        calls.append(lambda a=qkv, d=dim: flash_attention(*a, d ** -0.5))
        routes.append(f"fa::flash_wgmma<{dim}>")
    for call in calls:
        call()  # built and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for call in calls:
            call()
            torch.cuda.synchronize()
    events = sorted(
        (e for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda e: e.time_range.start)
    names = [e.name for e in events]
    assert len(names) == len(calls), names
    for name, route in zip(names, routes):
        assert route in name, (route, name)


@pytest.mark.cuda
def test_w2_kernel_refuses_widths_its_tile_does_not_take(cuda):
    """K3's tile reads 128 positions of each quarter a stage: a width
    that 512 does not divide is refused on the card (pack_int2 pads every
    layer to 1024), and the CPU's plain version still takes it."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    _, _, (wq, scales) = _lowbit_case("w2g64", gen, cuda, in_p=768)
    x = torch.randn((3, 768), generator=gen, device=cuda)
    with pytest.raises(ValueError, match="multiple of 512"):
        w2_matmul(x, wq, scales)
    got = w2_matmul(x.cpu(), wq.cpu(), scales.cpu())
    assert got.shape == (3, 200)


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [1, 16, 40, 130])
@pytest.mark.parametrize("kernel", ["w8", "w4", "w2g64", "w3", "bf16"])
def test_linear_kernels_take_fp16(cuda, kernel, tokens):
    """K1-K4 and K7 on fp16 x with fp16 out, as a model loaded in fp16
    calls them: x rounded to bf16, f32 sums, one rounding to fp16."""
    gen = torch.Generator(device=cuda).manual_seed(tokens)
    if kernel == "w8":
        fn, ref = w8_matmul, w8_matmul_reference
        weights = (
            torch.randint(-127, 128, (200, 2048), generator=gen, device=cuda,
                          dtype=torch.int8),
            torch.rand((4, 200), generator=gen, device=cuda) * 1e-2,
        )
    elif kernel == "bf16":
        fn, ref = bf16_matmul, bf16_matmul_reference
        weights = ((torch.randn((200, 2048), generator=gen, device=cuda)
                    * 0.05).to(torch.bfloat16),)
    else:
        fn, ref, weights = _lowbit_case(kernel, gen, cuda)
    x = torch.randn((tokens, 2048), generator=gen, device=cuda).half()
    before = fn.launches
    got = fn(x, *weights)
    want = ref(x, *weights)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.shape == (tokens, 200) and got.dtype == torch.float16
    _assert_kernel_close(got, want, torch.float16)


def _stacked_case(fmt, gen, device, n_experts=5, out_f=200, in_p=2048):
    """Stacked experts of random codes with an odd number of rows."""
    if fmt == "int8":
        wq = torch.randint(-127, 128, (n_experts, out_f, in_p), generator=gen,
                           device=device, dtype=torch.int8)
        scales = torch.rand((n_experts, in_p // 512, out_f), generator=gen,
                            device=device) * 1e-2
        return (w8_matmul_expert, w8_matmul_expert_reference,
                w8_matmul_pairs, w8_matmul_pairs_reference, wq, scales)
    wq = torch.randint(-128, 128, (n_experts, out_f, in_p // 2),
                       generator=gen, device=device, dtype=torch.int8)
    scales = (torch.rand((n_experts, in_p // 128, out_f), generator=gen,
                         device=device) * 1e-2).to(torch.bfloat16)
    return (w4_matmul_expert, w4_matmul_expert_reference,
            w4_matmul_pairs, w4_matmul_pairs_reference, wq, scales)


# both sum exact products in f32 per group: in f32 only the summation
# order differs; in bf16 and fp16, an ulp or so of the final rounding
# (2^-8 and 2^-11 relative)
KERNEL_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1e-3}


def _assert_kernel_close(got, want, out_dtype):
    rtol = KERNEL_RTOL[out_dtype]
    torch.testing.assert_close(
        got.float(), want.float(), rtol=rtol,
        atol=rtol * want.float().abs().max().item(),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tokens", [1, 3, 16, 17, 40, 65, 128, 130, 300, 512])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_expert_kernel_matches_plain_version(cuda, fmt, tokens, out_dtype):
    """K6a / K6b on every expert of a stack, the last included, with the
    id on the card; an id outside the stack is clamped into it. K6b runs
    its GEMV up to 16 tokens and K2's Hopper tile past them, at the token
    counts the MoE prefill sends (more than 64) too."""
    gen = torch.Generator(device=cuda).manual_seed(tokens)
    fn, ref, _, _, wq, scales = _stacked_case(fmt, gen, cuda)
    x = torch.randn((tokens, 2048), generator=gen, device=cuda)
    ids = torch.arange(5, dtype=torch.int32, device=cuda)
    before = fn.launches
    for e in range(5):
        got = fn(x, wq, scales, ids[e], out_dtype=out_dtype)
        want = ref(x, wq, scales, ids[e], out_dtype=out_dtype)
        assert got.shape == (tokens, 200) and got.dtype == out_dtype
        _assert_kernel_close(got, want, out_dtype)
    torch.cuda.synchronize()
    assert fn.launches == before + 5
    beyond = fn(x, wq, scales, torch.tensor(9, device=cuda),
                out_dtype=out_dtype)
    assert torch.equal(beyond, fn(x, wq, scales, ids[4], out_dtype=out_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_expert_kernel_matches_plain_version_at_a_long_chunk(cuda, fmt,
                                                             out_dtype):
    """K6a / K6b at Mixtral's long chunk (T 2048) through the tile, on
    every expert of a stack and the clamped id 9; int8 at group 2048 (two
    groups of 16 stages at in_p 4096), int4 at its group 128."""
    gen = torch.Generator(device=cuda).manual_seed(2048)
    n_experts, tokens, in_p = 3, 2048, 4096
    if fmt == "int8":
        fn, ref = w8_matmul_expert, w8_matmul_expert_reference
        wq, scales = _int8_case(gen, cuda, 200, in_p, 2048, n_experts)
    else:
        fn, ref, _, _, wq, scales = _stacked_case(
            fmt, gen, cuda, n_experts=n_experts, in_p=in_p)
    x = torch.randn((tokens, in_p), generator=gen, device=cuda)
    ids = torch.arange(n_experts, dtype=torch.int32, device=cuda)
    for e in range(n_experts):
        got = fn(x, wq, scales, ids[e], out_dtype=out_dtype)
        want = ref(x, wq, scales, ids[e], out_dtype=out_dtype)
        assert got.shape == (tokens, 200) and got.dtype == out_dtype
        _assert_kernel_close(got, want, out_dtype)
    beyond = fn(x, wq, scales, torch.tensor(9, device=cuda),
                out_dtype=out_dtype)
    last = fn(x, wq, scales, ids[-1], out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert torch.equal(beyond, last)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ids", [
    [4], [0, 4], [2, 2, 2, 2], [0, 1, 2, 3, 4], [4, 0, 3, 3, 1, 4, 0, 2] * 4,
    list(range(5)) * 26,
])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_pairs_kernel_matches_plain_version(cuda, fmt, ids, out_dtype):
    """K5a / K5b: one pair, repeated ids, all-distinct ids, the last
    expert, and more pairs (130) than a decode step of 64 tokens makes."""
    gen = torch.Generator(device=cuda).manual_seed(len(ids))
    _, _, fn, ref, wq, scales = _stacked_case(fmt, gen, cuda)
    x = torch.randn((len(ids), 2048), generator=gen, device=cuda)
    experts = torch.tensor(ids, device=cuda)
    before = fn.launches
    got = fn(x, wq, scales, experts, out_dtype=out_dtype)
    want = ref(x, wq, scales, experts, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.shape == (len(ids), 200) and got.dtype == out_dtype
    _assert_kernel_close(got, want, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [1, 8, 16, 17, 128, 512])
@pytest.mark.parametrize("kernel", ["w8", "w4"])
def test_kv_a_out_576_matches_plain_version(cuda, kernel, tokens):
    """K1 / K2 at Moonlight's kv_a_proj_with_mqa, out 576 (4.5 blocks of
    128 rows: the tile's last N block half full), in 2048: the decode GEMV
    up to 16 tokens (K1 at one token its w8_gemv), the tile past them; f32
    and bf16 out."""
    gen = torch.Generator(device=cuda).manual_seed(576 + tokens)
    fn, ref, weights = _decode_case(kernel, gen, cuda, (576, 2048, 2048))
    x = torch.randn((tokens, 2048), generator=gen, device=cuda)
    for out_dtype in (torch.float32, torch.bfloat16):
        before = fn.launches
        got = fn(x, *weights, out_dtype=out_dtype)
        want = ref(x, *weights, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert got.shape == (tokens, 576) and got.dtype == out_dtype
        _assert_smoke_close(got, want)
        _assert_kernel_close(got, want, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_moe_kernels_at_moonlight_experts(cuda, fmt):
    """K6 and K5 on a stack of Moonlight-16B-A3B's 64 experts (gate_up
    2816 x 2048; int8 in its group 2048, int4 in 128): K6 on the first,
    the last and the clamped id 70 at 1, 17 and 128 tokens; K5 on one
    token's top 6, 8 slots' (48 pairs) and 64 tokens' (384), ids drawn
    from a seed."""
    gen = torch.Generator(device=cuda).manual_seed(64)
    out_f, in_p, n_experts = 2816, 2048, 64
    if fmt == "int8":
        e_fn, e_ref = w8_matmul_expert, w8_matmul_expert_reference
        p_fn, p_ref = w8_matmul_pairs, w8_matmul_pairs_reference
        wq, scales = _int8_case(gen, cuda, out_f, in_p, 2048, n_experts)
    else:
        e_fn, e_ref, p_fn, p_ref, wq, scales = _stacked_case(
            fmt, gen, cuda, n_experts=n_experts, out_f=out_f, in_p=in_p)
    for tokens in (1, 17, 128):
        x = torch.randn((tokens, in_p), generator=gen, device=cuda)
        for e, read in ((0, 0), (63, 63), (70, 63)):
            got = e_fn(x, wq, scales, torch.tensor(e, device=cuda))
            want = e_ref(x, wq, scales, torch.tensor(read, device=cuda))
            _assert_kernel_close(got, want, torch.bfloat16)
    cpu = torch.Generator().manual_seed(6)
    for n_pairs in (6, 48, 384):
        ids = torch.cat([torch.randperm(n_experts, generator=cpu)[:6]
                         for _ in range(n_pairs // 6)]).to(cuda)
        x = torch.randn((n_pairs, in_p), generator=gen, device=cuda)
        before = p_fn.launches
        got = p_fn(x, wq, scales, ids)
        want = p_ref(x, wq, scales, ids)
        torch.cuda.synchronize()
        assert p_fn.launches == before + 1
        _assert_smoke_close(got, want)
        _assert_kernel_close(got, want, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pairs", [1, 2, 16])
@pytest.mark.parametrize("split", [0, 1, 2, 4, 8])
def test_pairs_kernel_matches_plain_version_at_every_split(cuda, split,
                                                           pairs, out_dtype):
    """K5b at each cluster size its decode GEMV takes (1, 2, 4, 8: in_p
    2048 is 8 stages of 128 positions a part) and at 0 (lowbit.cuh's
    GEMV), through the C entry its wrapper calls, on a stack of 5 experts
    of 200 rows (no multiple of a row block)."""
    from vptq_tpu_torch.ops.scaled_matmul import launch

    gen = torch.Generator(device=cuda).manual_seed(split * 100 + pairs)
    _, _, _, ref, wq, scales = _stacked_case("int4", gen, cuda)
    x = torch.randn((pairs, 2048), generator=gen, device=cuda)
    ids = torch.tensor([4, 0, 3, 3, 1, 4, 0, 2] * 2, dtype=torch.int32,
                       device=cuda)[:pairs]
    got = launch("w4_matmul_pairs", "vptq_w4_matmul_pairs", x, (wq, scales),
                 (5, split), 200, 2048, out_dtype, ids=ids)
    want = ref(x, wq, scales, ids, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.shape == (pairs, 200) and got.dtype == out_dtype
    _assert_kernel_close(got, want, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_pairs_kernel_matches_plain_version_on_the_last_of_a_large_stack(
        cuda, out_dtype):
    """K5b on a stack of 40 int4 slabs of Mixtral's gate_up (28672 x 4096):
    the last starts 39 · 58.7 MB = 2.29 GB in, past 2^31 bytes, so its
    offset must be computed in 64 bits; the pairs pick expert 39, expert 0
    and 45, past the stack, which reads expert 39."""
    gen = torch.Generator(device=cuda).manual_seed(40)
    n_experts, out_f, in_p = 40, 28672, 4096
    wq = torch.randint(-128, 128, (n_experts, out_f, in_p // 2),
                       generator=gen, device=cuda, dtype=torch.int8)
    scales = (torch.rand((n_experts, in_p // 128, out_f), generator=gen,
                         device=cuda) * 1e-2).to(torch.bfloat16)
    x = torch.randn((3, in_p), generator=gen, device=cuda)
    got = w4_matmul_pairs(x, wq, scales, torch.tensor([39, 0, 45],
                                                      device=cuda),
                          out_dtype=out_dtype)
    want = w4_matmul_pairs_reference(
        x, wq, scales, torch.tensor([39, 0, 39], device=cuda),
        out_dtype=out_dtype)
    torch.cuda.synchronize()
    _assert_kernel_close(got, want, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_pairs_kernel_clamps_an_id_past_the_stack(cuda, fmt):
    """An id past the stack (9 of 5) reads the last expert and a negative
    one the first, bit for bit, at one pair (K5b's decode GEMV at its
    plan's split) and at 16."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    _, _, fn, _, wq, scales = _stacked_case(fmt, gen, cuda)
    for pairs in (1, 16):
        x = torch.randn((pairs, 2048), generator=gen, device=cuda)
        bad = torch.tensor([9, -3] * 8, device=cuda)[:pairs]
        good = torch.tensor([4, 0] * 8, device=cuda)[:pairs]
        assert torch.equal(fn(x, wq, scales, bad), fn(x, wq, scales, good))


@pytest.mark.cuda
@pytest.mark.parametrize("pairs", [1, 2, 16])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_pairs_kernel_takes_fp16(cuda, fmt, pairs):
    """K5a / K5b on fp16 x with fp16 out, as a model loaded in fp16 calls
    them: the kernel reads x rounded to bf16 and its f32 sums are rounded
    once to fp16."""
    gen = torch.Generator(device=cuda).manual_seed(pairs)
    _, _, fn, ref, wq, scales = _stacked_case(fmt, gen, cuda)
    x = torch.randn((pairs, 2048), generator=gen, device=cuda).half()
    experts = torch.tensor([1, 4, 2, 0] * 4, device=cuda)[:pairs]
    got = fn(x, wq, scales, experts)
    want = ref(x, wq, scales, experts)
    torch.cuda.synchronize()
    assert got.shape == (pairs, 200) and got.dtype == torch.float16
    _assert_kernel_close(got, want, torch.float16)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_moe_kernels_run_on_the_current_stream(cuda, fmt):
    gen = torch.Generator(device=cuda).manual_seed(0)
    e_fn, e_ref, p_fn, p_ref, wq, scales = _stacked_case(fmt, gen, cuda)
    x = torch.randn((4, 2048), generator=gen, device=cuda)
    experts = torch.tensor([1, 4, 4, 0], device=cuda)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        got_e = e_fn(x, wq, scales, experts[1])
        got_p = p_fn(x, wq, scales, experts)
    stream.synchronize()
    _assert_kernel_close(got_e, e_ref(x, wq, scales, experts[1]),
                         torch.float32)
    _assert_kernel_close(got_p, p_ref(x, wq, scales, experts), torch.float32)


@pytest.mark.cuda
def test_moe_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    e_fn, _, p_fn, _, wq, scales = _stacked_case("int8", gen, cuda)
    x = torch.randn((2, 2048), generator=gen, device=cuda)
    with pytest.raises(ValueError, match="one device"):
        e_fn(x, wq, scales, torch.tensor(0))
    with pytest.raises(ValueError, match="one device"):
        p_fn(x, wq.cpu(), scales, torch.tensor([0, 1], device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        e_fn(x, wq.transpose(1, 2).contiguous().transpose(1, 2), scales,
             torch.tensor(0, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_mixtral_decode_reads_nothing_back(cuda, tmp_path, fmt):
    """A Mixtral decode step on the card: launch counts of the three
    kernels, and no synchronizing call (the expert ids stay on the card)."""
    from vptq_tpu_torch.models.llama import forward, init_cache
    from vptq_tpu_torch.models.loader import load_model

    write_synthetic_checkpoint(
        tmp_path,
        tiny_model_config(**TINY, tie_word_embeddings=False,
                          model_type="mixtral", num_local_experts=4,
                          num_experts_per_tok=2),
        vq_kwargs=VQ, seed=0,
    )
    model = load_model(str(tmp_path), runtime_format=fmt, device=cuda)
    cache = init_cache(model.cfg, 1, 256, torch.bfloat16, cuda)
    dense, (expert, pairs) = (
        chip_smoke.kernel_fns(chip_smoke.FORMAT_KERNEL[fmt])[0],
        [chip_smoke.kernel_fns(k)[0] for k in chip_smoke.MOE_KERNELS[fmt]],
    )
    prompt = torch.arange(70, device=cuda)[None]
    tok = torch.ones((1, 1), dtype=torch.int64, device=cuda)
    with torch.inference_mode():
        forward(model, prompt, cache, fresh_prefill=True)  # builds, warms up
        forward(model, tok, cache)
        torch.cuda.synchronize()
        counts = [f.launches for f in (dense, expert, pairs)]
        torch.cuda.set_sync_debug_mode("error")
        try:
            logits, _ = forward(model, tok, cache)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        forward(model, prompt, cache)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(logits).all())
    layers, experts = 2, 4
    assert [f.launches - n for f, n in zip((dense, expert, pairs), counts)] == [
        2 * layers * 2, 2 * experts * layers, 2 * layers]


def _flash_case(gen, device, batch, seq, heads, kv_heads, dim, factor=1.0):
    """q, k contiguous and v a view into a fused q|k|v row, in bf16."""
    widths = [heads * dim, kv_heads * dim, kv_heads * dim]
    qkv = torch.randn((batch, seq, sum(widths)), generator=gen, device=device)
    q, k, v = torch.split(qkv.to(torch.bfloat16), widths, dim=-1)
    q = (q * factor).reshape(batch, seq, heads, dim).contiguous()
    k = (k * factor).reshape(batch, seq, kv_heads, dim).contiguous()
    return q, k, v.reshape(batch, seq, kv_heads, dim)


def _assert_flash_close(got, want):
    # both round p to bf16 before p.v and the result to bf16 once; they
    # differ in summation order and exp2 against exp: one to two bf16 ulps
    # at the largest magnitude
    assert got.shape == want.shape and got.dtype == want.dtype
    assert bool(torch.isfinite(got.float()).all())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -7 * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("dim", [64, 96, 128])
@pytest.mark.parametrize("seq", [1, 63, 64, 65, 1024, 1100])
def test_flash_kernel_matches_plain_version(cuda, seq, dim, batch):
    gen = torch.Generator(device=cuda).manual_seed(seq + dim)
    q, k, v = _flash_case(gen, cuda, batch, seq, 8, 2, dim)
    assert seq == 1 or v.stride(1) == 12 * dim
    before = flash_attention.launches
    got = flash_attention(q, k, v, dim ** -0.5)
    want = flash_attention_reference(q, k, v, dim ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.shape == (batch, seq, 8 * dim)
    _assert_flash_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (4, 1), (6, 2)])
def test_flash_kernel_groups_strides_and_big_scores(cuda, heads, kv_heads):
    """MHA, MQA and GQA; every input a strided view; scores to about
    +-50; garbage past the prompt stays out of the real rows."""
    gen = torch.Generator(device=cuda).manual_seed(heads)
    dim, seq = 64, 200
    q, k, v = _flash_case(gen, cuda, 2, seq, heads, kv_heads, dim, 12 ** 0.5)
    wide = torch.zeros((2, seq, heads + 1, dim), dtype=torch.bfloat16,
                       device=cuda)
    q_view = wide[:, :, 1:]
    q_view.copy_(q)
    got = flash_attention(q_view, k, v, dim ** -0.5)
    want = flash_attention_reference(q, k, v, dim ** -0.5)
    _assert_flash_close(got, want)
    for t in (q, k, v):
        t[:, 150:] = 3e4
    padded = flash_attention(q, k, v, dim ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(padded[:, :150], got[:, :150])
    assert bool(torch.isfinite(padded.float()).all())


@pytest.mark.cuda
def test_flash_kernel_runs_on_the_current_stream_and_refuses(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = _flash_case(gen, cuda, 1, 300, 4, 2, 64)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        got = flash_attention(q, k, v, 0.125)
    stream.synchronize()
    _assert_flash_close(got, flash_attention_reference(q, k, v, 0.125))
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention(q.float(), k.float(), v.float(), 0.125)
    with pytest.raises(ValueError, match=r"head sizes \(64, 96, 128\)"):
        flash_attention(q[..., :32], k[..., :32], v[..., :32], 0.125)
    with pytest.raises(ValueError, match="one device"):
        flash_attention(q, k.cpu(), v, 0.125)
    with pytest.raises(ValueError, match="contiguously"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                        0.125)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tokens", [1, 3, 16, 17, 40, 130])
def test_bf16_kernel_matches_plain_version(cuda, tokens, out_dtype):
    gen = torch.Generator(device=cuda).manual_seed(tokens)
    w = (torch.randn((201, 1536), generator=gen, device=cuda) * 0.05).to(
        torch.bfloat16)
    x = torch.randn((tokens, 1536), generator=gen, device=cuda)
    before = bf16_matmul.launches
    got = bf16_matmul(x, w, out_dtype=out_dtype)
    want = bf16_matmul_reference(x, w, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert bf16_matmul.launches == before + 1
    assert got.shape == (tokens, 201) and got.dtype == out_dtype
    _assert_kernel_close(got, want, out_dtype)
    with pytest.raises(ValueError, match="% 512"):
        bf16_matmul(x[:, :768], w[:, :768].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "out_dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("out_f", [200, 384])
@pytest.mark.parametrize("tokens", [17, 100, 128, 129, 512, 2048])
def test_bf16_tile_matches_plain_version(cuda, tokens, out_f, out_dtype):
    """K7 past 16 tokens runs the Hopper tile in its SS form: ragged
    tokens, rows that fill no 128-row tile (200), 16 weight stages; bf16,
    f32 and fp16 out (fp16 x, the f32 sums rounded once)."""
    gen = torch.Generator(device=cuda).manual_seed(tokens + out_f)
    w = (torch.randn((out_f, 2048), generator=gen, device=cuda) * 0.05).to(
        torch.bfloat16)
    x = torch.randn((tokens, 2048), generator=gen, device=cuda)
    if out_dtype == torch.float16:
        x = x.half()
    before = bf16_matmul.launches
    got = bf16_matmul(x, w, out_dtype=out_dtype)
    want = bf16_matmul_reference(x, w, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert bf16_matmul.launches == before + 1
    assert got.shape == (tokens, out_f) and got.dtype == out_dtype
    _assert_kernel_close(got, want, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 4, 7])
@pytest.mark.parametrize("dim", [64, 96, 128])
@pytest.mark.parametrize(
    "seq", [1, 63, 64, 65, 127, 128, 129, 1100, 2500])
def test_flash_wgmma_matches_plain_version(cuda, seq, dim, group):
    """K8's warp-specialised kernel on two sequences: MHA and GQA groups 4
    and 7 (Qwen2.5's 28 / 4), ragged S around its 128-row tiles, a v that
    is a view into the fused q|k|v row, scores to about +-50."""
    gen = torch.Generator(device=cuda).manual_seed(seq * dim + group)
    q, k, v = _flash_case(gen, cuda, 2, seq, 2 * group, 2, dim, 12 ** 0.5)
    assert seq == 1 or v.stride(1) == (2 * group + 4) * dim
    before = flash_attention.launches
    got = flash_attention(q, k, v, dim ** -0.5)
    want = flash_attention_reference(q, k, v, dim ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.shape == (2, seq, 2 * group * dim)
    _assert_flash_close(got, want)


@pytest.mark.cuda
def test_long_fresh_prefill_goes_through_k8(cuda, checkpoint):
    """A 1024-token fresh prefill on the card: K8 once per layer, logits
    as through the plain versions; a chunk at an offset and a windowed
    model stay out of K8."""
    from vptq_tpu_torch.models.llama import forward, init_cache
    from vptq_tpu_torch.models.loader import load_model

    model = load_model(_wide(checkpoint), runtime_format="int8", device=cuda)
    tokens = torch.arange(1024, device=cuda)[None] % TINY["vocab_size"]

    def run():
        cache = init_cache(model.cfg, 1, 2048, torch.bfloat16, cuda)
        with torch.inference_mode():
            logits, _ = forward(model, tokens, cache, fresh_prefill=True)
            forward(model, tokens, cache)  # at offset 1024
        torch.cuda.synchronize()
        return logits

    before = flash_attention.launches
    got = run()
    assert flash_attention.launches == before + TINY["num_hidden_layers"]
    with chip_smoke.plain_versions("int8"):
        want = run()
    assert flash_attention.launches == before + TINY["num_hidden_layers"]
    diff = (got - want).abs().max().item()
    assert diff <= chip_smoke.LOGIT_TOL * want.abs().max().item()

    # TINY's head size 16 is one the kernel is not built for: the chunk
    # takes the cache attention, on the card as on the CPU
    tiny = load_model(checkpoint, runtime_format="int8", device=cuda)
    cache = init_cache(tiny.cfg, 1, 2048, torch.bfloat16, cuda)
    with torch.inference_mode():
        logits, _ = forward(tiny, tokens, cache, fresh_prefill=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + TINY["num_hidden_layers"]
    assert bool(torch.isfinite(logits).all())


def _wide(checkpoint) -> str:
    """TINY at head size 64, which K8 is built for, beside ``checkpoint``."""
    path = Path(checkpoint) / "wide"
    write_synthetic_checkpoint(
        path, tiny_model_config(**{**TINY, "hidden_size": 256, "head_dim": 64},
                                tie_word_embeddings=False),
        vq_kwargs=VQ, seed=0, std=0.05,
    )
    return str(path)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_long_prompts_in_f32_and_fp16_are_served(cuda, checkpoint, dtype):
    """A model loaded in f32 or fp16 serves an 1100-token prompt on the
    card: its fresh chunk takes the cache attention (K8 is built for
    bf16), its linears the int4 tile, and its logits are those of the
    plain versions."""
    from vptq_tpu_torch.models.llama import forward, init_cache
    from vptq_tpu_torch.models.loader import load_model

    model = load_model(_wide(checkpoint), runtime_format="int4", device=cuda,
                       dtype=dtype)
    tokens = torch.arange(1100, device=cuda)[None] % TINY["vocab_size"]

    def run():
        cache = init_cache(model.cfg, 1, 2048, dtype, cuda)
        with torch.inference_mode():
            logits, _ = forward(model, tokens, cache, dtype=dtype,
                                fresh_prefill=True)
        torch.cuda.synchronize()
        return logits

    flash, w4 = flash_attention.launches, w4_matmul.launches
    got = run()
    assert flash_attention.launches == flash
    assert w4_matmul.launches == w4 + 4 * TINY["num_hidden_layers"]
    assert bool(torch.isfinite(got).all())
    with chip_smoke.plain_versions("int4"):
        want = run()
    diff = (got.float() - want.float()).abs().max().item()
    assert diff <= chip_smoke.LOGIT_TOL * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tokens", [1, 3, 16, 17, 40])
@pytest.mark.parametrize("mode", sorted(W4_PROBE_MODES))
def test_w4_probe_kernel_matches_plain_version(cuda, mode, tokens, out_dtype):
    """Every unpack mode on the GEMV (T <= 16) and on the tile (T > 16),
    x in f32 (rounded to bf16 by every mode), an odd number of rows."""
    gen = torch.Generator(device=cuda).manual_seed(tokens)
    wq = torch.randint(-128, 128, (200, 1024), generator=gen, device=cuda,
                       dtype=torch.int8)
    scales = (torch.rand((16, 200), generator=gen, device=cuda) * 1e-2).to(
        torch.bfloat16)
    x = torch.randn((tokens, 2048), generator=gen, device=cuda)
    before = w4_probe_matmul.launches
    got = w4_probe_matmul(x, wq, scales, mode, out_dtype=out_dtype)
    want = w4_probe_matmul_reference(x, wq, scales, mode, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert w4_probe_matmul.launches == before + 1
    assert got.shape == (tokens, 200) and got.dtype == out_dtype
    _assert_kernel_close(got, want, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tokens", [1, 3, 8, 9, 40])
def test_i32x8_kernel_matches_plain_version(cuda, tokens, out_dtype):
    """Words drawn over all of int32 (plane 7 of a negative word too)."""
    gen = torch.Generator(device=cuda).manual_seed(tokens)
    wq = torch.randint(-2 ** 31, 2 ** 31 - 1, (200, 256), generator=gen,
                       device=cuda, dtype=torch.int32)
    scales = (torch.rand((16, 200), generator=gen, device=cuda) * 1e-2).to(
        torch.bfloat16)
    x = torch.randn((tokens, 2048), generator=gen, device=cuda)
    before = w4_i32x8_matmul.launches
    got = w4_i32x8_matmul(x, wq, scales, out_dtype=out_dtype)
    want = w4_i32x8_matmul_reference(x, wq, scales, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert w4_i32x8_matmul.launches == before + 1
    assert got.shape == (tokens, 200) and got.dtype == out_dtype
    _assert_kernel_close(got, want, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tokens", [1, 3, 8, 9, 40])
@pytest.mark.parametrize("mode", ["s8dot", "cvtonly"])
def test_raw_probe_kernel_matches_plain_version(cuda, mode, tokens,
                                                out_dtype):
    """s8dot sums exact integers on both sides, so the two agree bit for
    bit; cvtonly to the summation order."""
    gen = torch.Generator(device=cuda).manual_seed(tokens)
    wq = torch.randint(-128, 128, (200, 1024), generator=gen, device=cuda,
                       dtype=torch.int8)
    scales = (torch.rand((16, 200), generator=gen, device=cuda) * 1e-2).to(
        torch.bfloat16)
    x = torch.randn((tokens, 1024), generator=gen, device=cuda) * 40
    if mode == "s8dot":
        x = x.to(torch.int8)
    before = w4_raw_probe.launches
    got = w4_raw_probe(x, wq, scales, mode, out_dtype=out_dtype)
    want = w4_raw_probe_reference(x, wq, scales, mode, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert w4_raw_probe.launches == before + 1
    assert got.shape == (tokens, 200) and got.dtype == out_dtype
    if mode == "s8dot":
        assert torch.equal(got, want)
    else:
        _assert_kernel_close(got, want, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [1, 3, 9, 40])
@pytest.mark.parametrize("k", [200, 256])
@pytest.mark.parametrize("onehot_only", [False, True])
@pytest.mark.parametrize("v", [4, 8])
def test_vq_smallk_kernel_matches_plain_version(cuda, v, onehot_only, k,
                                                tokens):
    """Ids drawn from [0, 256): with k = 200 an id past the codebook must
    add 0; f32 out, so only the summation order differs."""
    gen = torch.Generator(device=cuda).manual_seed(tokens + k)
    ids = torch.randint(0, 256, (200, 1024 // v), generator=gen, device=cuda,
                        dtype=torch.uint8)
    cb = torch.randn((k, v), generator=gen, device=cuda) * 0.02
    x = torch.randn((tokens, 1024), generator=gen, device=cuda)
    before = vq_smallk_matmul.launches
    got = vq_smallk_matmul(x, ids, cb, v, onehot_only)
    want = vq_smallk_matmul_reference(x, ids, cb, v, onehot_only)
    torch.cuda.synchronize()
    assert vq_smallk_matmul.launches == before + 1
    assert got.shape == (tokens, 200) and got.dtype == torch.float32
    _assert_kernel_close(got, want, torch.float32)


@pytest.mark.cuda
def test_probe_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    wq = torch.zeros((8, 384), dtype=torch.int8, device=cuda)
    scales = torch.zeros((6, 8), dtype=torch.bfloat16, device=cuda)
    x = torch.zeros((1, 768), device=cuda)
    w4_probe_matmul(x, wq, scales, "prod")  # 768 = 3 groups of 256
    with pytest.raises(ValueError, match="multiple of 512"):
        w4_probe_matmul(x, wq, scales, "g256")
    with pytest.raises(ValueError, match="mode"):
        w4_probe_matmul(x, wq, scales, "fma32")
    with pytest.raises(ValueError, match="one device"):
        w4_probe_matmul(x, wq.cpu(), scales, "prod")
    with pytest.raises(ValueError, match="int8"):
        w4_raw_probe(x[:, :384], wq, scales, "s8dot")
    ids = torch.zeros((8, 64), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="codebook"):
        vq_smallk_matmul(torch.zeros((1, 512), device=cuda), ids,
                         torch.zeros((257, 8), device=cuda), 8)
    with pytest.raises(ValueError, match="multiple of 1024"):
        w4_i32x8_matmul(x, torch.zeros((8, 96), dtype=torch.int32,
                                       device=cuda), scales)


@pytest.mark.cuda
def test_probe_examples_run_their_checks_on_the_card(cuda):
    """The scripts' own checks through the ports' entry points."""
    assert w4_wall_candidates.check_fma16_exact(cuda) < 2e-2
    assert w4_unpack_ablation.check_shift28(cuda) < 2e-2
    err, limit = vq_smallk_probe.check(cuda)
    assert err < limit


# (runtime format, family) of the graphed decode tests: every format of
# the dense model, both MoE formats, and a sliding window that 300 steps
# pass
GRAPH_CASES = [
    ("int8", "llama"), ("int4", "llama"), ("int3", "llama"), ("int2", "llama"),
    ("int8", "mixtral"), ("int4", "mixtral"), ("int8", "mistral"),
]


def _graph_model(path, fmt, family, device):
    from vptq_tpu_torch.models.loader import load_model

    cfg = dict(TINY, tie_word_embeddings=False)
    if family == "mixtral":
        cfg.update(model_type="mixtral", num_local_experts=4,
                   num_experts_per_tok=2)
    elif family == "mistral":
        cfg.update(model_type="mistral", sliding_window=64)
    write_synthetic_checkpoint(path, tiny_model_config(**cfg), vq_kwargs=VQ,
                               seed=0)
    return load_model(str(path), runtime_format=fmt, device=device)


def _launches():
    from vptq_tpu_torch.serving.generate import _counted

    return {f.__name__: f.launches for f in _counted()}


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,family", GRAPH_CASES)
def test_graph_logits_are_bit_equal_to_eager_across_a_block(
        cuda, tmp_path, fmt, family):
    """300 greedy steps from a 10-token prompt at max_seq 512 (blocks 1
    and 2, so two graphs) through the generator's CUDA graphs and through
    the eager ``decode_loop`` from the same cache: every step's logits bit
    for bit, the same tokens, and the same launch counts (replays
    counted)."""
    from vptq_tpu_torch.models.llama import forward
    from vptq_tpu_torch.serving.generate import Generator, decode_loop

    model = _graph_model(tmp_path, fmt, family, cuda)
    gen = Generator(model, max_seq=512)
    prompt = torch.arange(1, 11, device=cuda)[None]
    steps = 300

    def prefill():
        gen.cache.reset(0)
        logits, _ = forward(model, prompt, gen.cache, fresh_prefill=True)
        gen.cache.reset(prompt.shape[1])
        return torch.argmax(logits[:, -1], dim=-1)

    with torch.inference_mode():
        first = prefill()
        before = _launches()
        gen.graphs.begin(first, 0.0, 0)
        got = [gen.graphs.step().clone() for _ in range(steps)]
        got_toks = gen.graphs.tokens[:steps, 0].clone()
        graph_launches = {k: n - before[k] for k, n in _launches().items()}
        assert gen.cache.max_len == prompt.shape[1] + steps
        prefill()
        before = _launches()
        want = []
        toks, _ = decode_loop(model, first, gen.cache, None, 0.0,
                              steps=steps, logits=want)
        eager_launches = {k: n - before[k] for k, n in _launches().items()}
    torch.cuda.synchronize()
    assert sorted(gen.graphs.captured) == [(256, False), (512, False)]
    assert torch.equal(got_toks, toks[:, 0])
    assert len(got) == len(want) == steps
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert graph_launches == eager_launches
    assert graph_launches[chip_smoke.FORMAT_KERNEL[fmt]] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,family", [("int8", "llama"),
                                        ("int4", "mixtral")])
def test_sampled_graph_tokens_equal_eager(cuda, tmp_path, fmt, family):
    """A sampled request on the card (graphs, each chunk's generator
    re-seeded with seed + 1 + chunk) and the same request eagerly: the
    first token from ``seed``, each chunk through ``decode_loop``. 250
    prompt tokens and 40 new ones cross the first block boundary."""
    from vptq_tpu_torch.models.llama import forward
    from vptq_tpu_torch.serving.generate import (
        Generator,
        _temperature,
        decode_loop,
        sample_next,
    )

    model = _graph_model(tmp_path, fmt, family, cuda)
    gen = Generator(model, max_seq=512)
    prompt = [int(t) for t in torch.arange(250) % TINY["vocab_size"]]
    temperature, seed, new, chunk = 0.8, 3, 40, 7
    got = gen.generate(prompt, max_new_tokens=new, temperature=temperature,
                       seed=seed, chunk_size=chunk)

    def draws(s):
        return torch.Generator(device=cuda).manual_seed(s)

    with torch.inference_mode():
        gen.cache.reset(0)
        padded = torch.zeros((1, 512), dtype=torch.int64)
        padded[0, :250] = torch.tensor(prompt)
        logits, _ = forward(model, padded.to(cuda), gen.cache,
                            fresh_prefill=True)
        gen.cache.reset(250)
        tok = sample_next(logits[:, 249], draws(seed),
                          _temperature(temperature, cuda))
        want = [int(tok[0])]
        for i, done in enumerate(range(0, new - 1, chunk)):
            toks, _ = decode_loop(model, tok, gen.cache, draws(seed + 1 + i),
                                  temperature, steps=min(chunk, new - 1 - done))
            want += toks[:, 0].tolist()
            tok = toks[-1]
    assert len(got) == new and got == want
    assert sorted(gen.graphs.captured) == [(256, True), (512, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,family", GRAPH_CASES)
def test_batched_graphs_are_bit_equal_to_the_eager_step(cuda, tmp_path, fmt,
                                                        family):
    """The scheduler's batched step over 4 slots of different lengths,
    greedy and sampled slots side by side, 40 steps from a longest slot of
    250 (blocks 1 and 2): graphs (their second run, all replays) against
    the eager step, logits and tokens bit for bit."""
    from vptq_tpu_torch.serving.scheduler import Scheduler

    model = _graph_model(tmp_path, fmt, family, cuda)
    sched = Scheduler(model, max_batch=4, max_seq=512, chunk=40)
    assert chip_smoke.batched_graph_against_eager(
        sched, [250, 3, 100, 240], steps=40) == [1, 2]
    assert sorted(sched.decode.captured) == [(256,), (512,)]


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,family", [("int4", "llama"),
                                        ("int4", "mixtral")])
def test_scheduler_serves_through_batched_graphs(cuda, tmp_path, fmt, family):
    """Six requests, greedy and sampled, through 4 slots on the card: each
    returns its budget, the decode chunks replay graphs, the kernels of the
    path ran, and nothing was read back inside a chunk but its tokens."""
    from vptq_tpu_torch.serving.scheduler import Scheduler

    model = _graph_model(tmp_path, fmt, family, cuda)
    sched = Scheduler(model, max_batch=4, max_seq=512, chunk=8,
                      prompt_buckets=(64, 256))
    before = _launches()
    vocab = TINY["vocab_size"]
    ids = [sched.submit([t % vocab for t in range(1, 1 + n)],
                        max_new_tokens=20 + n % 7,
                        temperature=0.8 if n % 2 else 0.0, seed=n)
           for n in (3, 40, 90, 200, 7, 300)]
    out = sched.run()
    ran = {k: n - before[k] for k, n in _launches().items() if n > before[k]}
    assert [len(out[i]) for i in ids] == [20 + n % 7
                                          for n in (3, 40, 90, 200, 7, 300)]
    assert all(0 <= t < TINY["vocab_size"] for i in ids for t in out[i])
    assert sched.decode.captured and sched.stats["chunks"] > 0
    assert chip_smoke.FORMAT_KERNEL[fmt] in ran
    if family == "mixtral":
        assert {"w4_matmul_pairs", "w4_matmul_expert"} <= set(ran)


_CAPTURE_FAILS = r"""
import sys
import torch
from vptq_tpu_torch.models import llama
from vptq_tpu_torch.models.loader import load_model
from vptq_tpu_torch.serving.generate import Generator

model = load_model(sys.argv[1], runtime_format="int8", device="cuda")
gen = Generator(model, max_seq=256)
print("prefill and eager step:", gen.generate([1, 2, 3], max_new_tokens=1))
norm = llama.rms_norm


def reads_back(x, w, eps):
    float(x.abs().max())  # a device read: legal eagerly, not in a capture
    return norm(x, w, eps)


llama.rms_norm = reads_back
try:
    gen.generate([1, 2, 3], max_new_tokens=4)
except RuntimeError as e:
    print("raised", type(e).__name__, str(e).splitlines()[0])
    print("card answers", torch.ones(4, device="cuda").sum().item())
    sys.exit(0)
sys.exit("a failed capture did not raise")
"""


@pytest.mark.cuda
def test_a_capture_that_fails_raises(cuda, checkpoint):
    """A step that reads the device back cannot be captured: the
    generator raises (no eager fallback). In a process of its own, so
    that the failed capture touches no other test."""
    out = subprocess.run(
        [sys.executable, "-c", _CAPTURE_FAILS, checkpoint], cwd=ROOT,
        capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "raised" in out.stdout and "card answers 4.0" in out.stdout


# --------------------------------------------------------------------
# Runtime checkpoints and the mixed formats
# --------------------------------------------------------------------

_IMPORT_TOOLS = r"""
import sys
from vptq_tpu_torch.tools import export_runtime
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "ml_dtypes", "safetensors", "vptq_tpu",
                           "transformers", "tokenizers", "datasets")
)
print(export_runtime.__name__, bad)
"""


def test_runtime_checkpoint_tools_import_no_jax():
    """The reader and writer keep their own copy of the JAX package's file
    format: importing them pulls in no JAX, ml_dtypes or safetensors."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_TOOLS], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout.split(maxsplit=1)
    assert out == ["vptq_tpu_torch.tools.export_runtime", "[]\n"]


def test_export_runtime_cli_exits_nonzero_without_a_card(monkeypatch,
                                                         checkpoint, tmp_path):
    from vptq_tpu_torch.tools import export_runtime

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        export_runtime.main(["-m", checkpoint, "-o", str(tmp_path / "rt")])
    assert exc.value.code not in (0, None)
    assert "--device cpu" in str(exc.value.code)
    assert not (tmp_path / "rt").exists()


def test_from_pretrained_refuses_tensor_parallelism(checkpoint):
    with pytest.raises(NotImplementedError, match="M16"):
        AutoModelForCausalLM.from_pretrained(checkpoint, device="cpu", tp=2)
    engine = AutoModelForCausalLM.from_pretrained(
        checkpoint, device="cpu", tp=1, dtype=torch.float32, max_seq=32)
    assert len(engine.generate([1, 2, 3], max_new_tokens=2)) == 2


def test_side_shapes_of_llama31_8b():
    """The int8 side matrices of the mixed formats at Llama-3.1-8B width:
    128 columns everywhere but down's 14336 inputs (1/48: 384, 1/32:
    512)."""
    want = {"int2-mixed": 384, "int3-mixed": 512}
    for fmt, down in want.items():
        assert [s[1:] for s in chip_smoke.side_shapes(
            chip_smoke.LLAMA31_8B, fmt)] == [
            (6144, 128), (4096, 128), (28672, 128), (4096, down)]


def test_expected_launches_of_a_mixed_request():
    """A mixed format's linear runs its base kernel and K1 once each: 4 of
    each per layer and forward call."""
    buckets = [128, 512, 2048]
    dense = tiny_model_config(num_hidden_layers=3, head_dim=128)
    for fmt, (base, side) in chip_smoke.MIXED_KERNELS.items():
        got = chip_smoke.expected_launches(dense, fmt, 1536, 32, buckets)
        assert got.pop(base) == got.pop(side) == 4 * 3 * 32
        assert got.pop("flash_attention") == 3 and set(got.values()) == {0}


def test_plain_versions_swap_every_kernel_of_a_mixed_layer():
    from vptq_tpu_torch.layers import runtime

    with chip_smoke.plain_versions("int2-mixed"):
        assert runtime.w2_matmul is w2_matmul_reference
        assert runtime.w8_matmul is w8_matmul_reference
    assert runtime.w8_matmul is w8_matmul and runtime.w2_matmul is w2_matmul


def test_step_routes_hold_a_mixed_model_to_its_routes():
    """A mixed model's decode step: each linear's base, then its side; at
    one token K1's side calls on w8_gemv and K4 on lowbit::gemv (the tiny
    model's weights are small); a kernel of the path missing fails."""
    from vptq_tpu_torch.models.llama import ModelConfig
    from vptq_tpu_torch.utils.synth import mixed_model

    cfg = ModelConfig(**dict(TINY, tie_word_embeddings=False))
    model = mixed_model(cfg, "int3-mixed", "cpu")
    calls = chip_smoke.decode_calls(model, "int3-mixed")
    assert [k for k, _, _ in calls] == ["w3_matmul", "w8_matmul"] * 8
    assert [c[1:] for c in calls[:4]] == [(128, 2048), (128, 128),
                                          (64, 2048), (64, 128)]
    gemv = KERNEL_NAMES["w3_matmul"][0]
    side = _W8.format(k="gemv", sel="Whole", t="1, ")
    step = [_Event(gemv, 1.0), _Event(side, 1.0)] * 4
    assert chip_smoke.step_routes(step, model, "int3-mixed", "step") == {
        "w3_matmul": ["lowbit W3"], "w8_matmul": ["w8_gem Whole"]}
    with pytest.raises(AssertionError, match="routes say"):
        chip_smoke.step_routes(step[::2], model, "int3-mixed", "step")


def test_same_buffers_and_disk_room_fail_loudly(monkeypatch, tmp_path):
    from vptq_tpu_torch.models.llama import ModelConfig
    from vptq_tpu_torch.utils.synth import mixed_model

    cfg = ModelConfig(**dict(TINY, tie_word_embeddings=False))
    a = mixed_model(cfg, "int2-mixed", "cpu")
    b = mixed_model(cfg, "int2-mixed", "cpu")
    assert chip_smoke.same_buffers(a, b, "x") == chip_smoke.buffer_bytes(a)
    b.blocks[1].mlp.down_proj.int8.scales[0, 3] += 1e-7
    with pytest.raises(AssertionError, match="down_proj.int8.scales"):
        chip_smoke.same_buffers(a, b, "x")
    usage = shutil.disk_usage(tmp_path)
    monkeypatch.setattr(shutil, "disk_usage",
                        lambda p: usage._replace(free=2 << 30))
    chip_smoke.disk_room(tmp_path, "x", 1 << 30)
    with pytest.raises(AssertionError, match="GB free"):
        chip_smoke.disk_room(tmp_path, "x", 3 << 30)


@pytest.mark.parametrize("fmt", list(chip_smoke.MIXED_KERNELS))
def test_chip_smoke_mixed_phase_on_cpu(fmt):
    """The mixed formats' phase at a tiny size: a model of random codes
    written and read back byte-equal, served with the plain versions."""
    cfg = dict(TINY, tie_word_embeddings=False,
               rope_scaling=tuple(sorted(LLAMA3_SCALING.items())))
    e2e = chip_smoke.phase_mixed("cpu", cfg, fmt, prompt_lens=(5, 20, 40),
                                 new_tokens=4, max_seq=64)
    assert e2e["kernels"] == list(chip_smoke.MIXED_KERNELS[fmt])
    assert [r["prompt"] for r in e2e["requests"]] == [5, 20, 40]
    assert set(e2e["launches"].values()) == {0}  # the CPU launches nothing
    assert e2e["prefill_logits_max_abs_diff"] == 0.0
    assert e2e["decode_logits_max_abs_diff"] == 0.0
    made = e2e["runtime_checkpoint"]
    assert 0 < made["bytes_equal_gb"] <= made["file_gb"]


@pytest.mark.parametrize("family,fmt", [
    ("llama", "int8"), ("llama", "int4"), ("mixtral", "int4"),
])
def test_chip_smoke_round_trip_on_cpu(family, fmt):
    """The depth-cut round trip at a tiny size: one of two layers loaded,
    written, read back byte-equal, the same greedy tokens."""
    cfg = dict(TINY, tie_word_embeddings=False)
    if family == "mixtral":
        cfg.update(model_type="mixtral", num_local_experts=4,
                   num_experts_per_tok=2)
    path, _ = chip_smoke.write_checkpoint(cfg, VQ)
    try:
        got = chip_smoke.phase_round_trip("cpu", path, fmt,
                                          TINY["vocab_size"], layers=1)
    finally:
        shutil.rmtree(path, ignore_errors=True)
    assert got["layers"] == 1 and got["tokens_identical"]
    assert got["bytes_equal_gb"] > 0


# the int8 side matrices of the mixed formats at Llama-3.1-8B width (out,
# in_p): group 128, one to four 128-position stages
K1_SIDES = [(6144, 128), (4096, 128), (28672, 128), (4096, 384),
            (4096, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tokens", [1, 2, 3, 8, 16, 17, 128, 512, 2048])
@pytest.mark.parametrize("out_f,in_p", K1_SIDES)
def test_k1_at_the_mixed_side_shapes(cuda, out_f, in_p, tokens, out_dtype):
    """K1 on a mixed layer's int8 side: w8_gemv (1-2 tokens), the decode
    GEMV with one to four stages (3-16), the Hopper tile whose K loop is
    one to four stages, no longer than its ring of x slabs (past 16)."""
    gen = torch.Generator(device=cuda).manual_seed(tokens + out_f + in_p)
    wq, scales = _int8_case(gen, cuda, out_f, in_p, 128)
    x = torch.randn((tokens, in_p), generator=gen, device=cuda)
    before = w8_matmul.launches
    got = w8_matmul(x, wq, scales, out_dtype=out_dtype)
    want = w8_matmul_reference(x, wq, scales, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert w8_matmul.launches == before + 1
    assert got.shape == (tokens, out_f) and got.dtype == out_dtype
    _assert_kernel_close(got, want, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [1, 3, 16, 17, 130])
@pytest.mark.parametrize("fmt", list(chip_smoke.MIXED_KERNELS))
def test_mixed_layer_runs_its_kernels(cuda, fmt, tokens):
    """A mixed layer on the card launches its base kernel and K1 once
    each, and agrees with the same layer through their plain versions
    (each part within chip_smoke's bound of its own magnitude)."""
    from vptq_tpu_torch.utils.synth import _mixed_linear

    gen = torch.Generator(device=cuda).manual_seed(tokens)
    lin = _mixed_linear(fmt, 4096, 1024, gen, 0.02)
    x = torch.randn((tokens, 4096), generator=gen, device=cuda).to(
        torch.bfloat16)
    fns = [chip_smoke.kernel_fns(k)[0]
           for k in chip_smoke.MIXED_KERNELS[fmt]]
    before = [f.launches for f in fns]
    got = lin(x)
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == [n + 1 for n in before]
    with chip_smoke.plain_versions(fmt):
        want = lin(x)
        parts = lin.base(x).float().abs() + lin.int8(
            x.index_select(-1, lin.col_idx)).float().abs()
    assert got.dtype == want.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs()
    limit = (chip_smoke.RTOL * parts
             + chip_smoke.ATOL_FRAC * want.float().abs().max())
    assert bool(torch.all(err <= limit)), err.max()


def test_mixed_sensitivity_runs_the_plain_versions_on_cpu(capsys):
    """The spread sweep at a tiny width on the CPU: the plain versions on
    both sides (kernels vs plain 0), the one-ulp embedding's move > 0."""
    mixed_sensitivity.main(["--device", "cpu", "--tiny", "--std", "0.02"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("# cpu") and lines[-1] == lines[0]
    assert [ln.split(":")[0] for ln in lines[1:3]] == [
        "int2-mixed std 0.02", "int3-mixed std 0.02"]
    for ln in lines[1:3]:
        kernels, moved = (float(w.split()[0]) for w in
                          ln.split("plain ")[1].split(", one-ulp embedding "))
        assert kernels == 0.0 and 0 < moved < 1


def _correlated_hessian(in_f, n, seed):
    """X^T X of inputs with a rank in_f / 4 structure plus noise (the
    inputs of tests/test_gptq.py)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, in_f // 4)).astype(np.float32)
    proj = rng.standard_normal((in_f // 4, in_f)).astype(np.float32)
    x = z @ proj + 0.1 * rng.standard_normal((n, in_f)).astype(np.float32)
    return torch.from_numpy(x.T @ x)


# the share of codes that may part from the CPU's under a correlated H
# (tests/test_torch_gptq.py's share bounds against JAX); a code that moves
# feeds another error to its row, so how far a neighbour moves is no bound
GPTQ_SHARE = {2: 5e-3, 3: 5e-3, 4: 5e-3, 8: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("hess", ["none", "identity", "correlated"])
@pytest.mark.parametrize("bits,group", [(2, 64), (3, 128), (4, 128),
                                        (8, 256)])
def test_gptq_on_the_card_matches_the_cpu(cuda, bits, group, hess):
    """``gptq_quantize`` on CUDA tensors against the same call on the CPU:
    byte-equal without a Hessian and with the identity; under a
    correlated one (512 columns) within the share bound, the H-weighted
    output error ratio within 1% of the CPU's."""
    from vptq_tpu_torch.quant.gptq import (
        dequant_groups,
        gptq_quantize,
        group_spans,
        output_error_ratio,
    )

    gen = torch.Generator().manual_seed(bits)
    w = torch.randn((128, 512), generator=gen) * 0.02
    h = {"none": None, "identity": torch.eye(512),
         "correlated": _correlated_hessian(512, 2048, bits)}[hess]
    q, s = gptq_quantize(w.to(cuda), None if h is None else h.to(cuda),
                         bits=bits, group=group)
    q, s = q.cpu(), s.cpu()
    q_cpu, s_cpu = gptq_quantize(w, h, bits=bits, group=group)
    if h is None or hess == "identity":
        assert torch.equal(q, q_cpu) and torch.equal(s, s_cpu)
        return
    assert (q != q_cpu).float().mean().item() <= GPTQ_SHARE[bits]
    spans = group_spans(512, group)
    offset = 0.5 if bits == 2 else 0.0
    err, err_cpu = (
        output_error_ratio(w, dequant_groups(a, b, spans, offset), h)
        for a, b in ((q, s), (q_cpu, s_cpu)))
    assert abs(err - err_cpu) <= 1e-2 * err_cpu


@pytest.mark.cuda
def test_gptq_on_the_card_ignores_tf32(cuda):
    """The caller's TF32 setting changes no code: the Hessian products, the
    feedback and the error ratios run in true f32."""
    from vptq_tpu_torch.quant.gptq import gptq_quantize, output_error_ratio

    gen = torch.Generator().manual_seed(0)
    w = (torch.randn((256, 1024), generator=gen) * 0.02).to(cuda)
    h = _correlated_hessian(1024, 4096, 0).to(cuda)
    want = gptq_quantize(w, h, bits=4, group=128)
    want_err = output_error_ratio(w, w * 1.01, h)
    matmul = torch.backends.cuda.matmul
    old = matmul.fp32_precision
    torch.set_float32_matmul_precision("high")
    matmul.fp32_precision = "tf32"  # over a backend setting made before
    try:
        # TF32 is on for the caller's own products
        a = h[:512, :512] / h.abs().max()
        assert ((a @ a).double() - a.double() @ a.double()).abs().max() > (
            1e-4 * (a.double() @ a.double()).abs().max())
        got = gptq_quantize(w, h, bits=4, group=128)
        got_err = output_error_ratio(w, w * 1.01, h)
    finally:
        matmul.fp32_precision = old
        torch.set_float32_matmul_precision("highest")  # torch's default
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got_err == want_err


@pytest.mark.cuda
@pytest.mark.parametrize("bits,group", [(2, 64), (3, 128), (8, 128)])
def test_gptq_replay_equals_the_eager_loop(cuda, monkeypatch, bits, group):
    """The column loop replayed from its CUDA graph gives the codes and
    scales of the loop run op by op on the card, in a call of its own and
    in calls that keep their steps (``steps``)."""
    from vptq_tpu_torch.quant import gptq

    gen = torch.Generator().manual_seed(bits)
    w = (torch.randn((192, 512), generator=gen) * 0.02).to(cuda)
    h = _correlated_hessian(512, 2048, bits).to(cuda)
    alone = gptq.gptq_quantize(w, h, bits=bits, group=group)
    steps = {}
    shared = [gptq.gptq_quantize(w, h, bits=bits, group=group, steps=steps)
              for _ in range(2)]
    monkeypatch.setattr(gptq, "CUDA_GRAPHS", False)
    want = gptq.gptq_quantize(w, h, bits=bits, group=group)
    for q, s in (alone, *shared):
        assert torch.equal(q, want[0]) and torch.equal(s, want[1])
