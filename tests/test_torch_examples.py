"""The port's quickstart and multichip demo (``vptq_tpu_torch/examples``)
against the JAX package's scripts on the CPU.

* quickstart: the synthetic checkpoint is the JAX script's, byte for
  byte (its writer's call); greedy, the port's 32 tokens equal JAX's
  ``Generator`` on it (int8, in f32: in bf16 XLA's jitted forward keeps
  some intermediates in f32 and parts from the port on a near tie at
  token 27, as ``tests/test_torch_cli.py`` pins; JAX's Pallas kernels in
  interpret mode, which round x to bf16 as K1's plain version does) for
  the byte tokenizer's ids of the prompt, which equal the HF directory's;
  sampled at 0.8 the tokens repeat for one ``--seed`` and differ for
  another.
* multichip_demo: its TP, CP and PP lines equal the JAX script's on
  conftest's 8 CPU devices (the port's steps 2–4 on 4 gloo ranks, step 5
  in the process), and its plan's placement, budget per device and
  budget table are JAX's for the same memory (16 GiB).
"""

import importlib.util
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import safetensors.numpy

from vptq_tpu import native
from vptq_tpu.models import load_model as j_load_model
from vptq_tpu.serving import Generator as JGenerator
from vptq_tpu.utils import synth_checkpoint as jsc
from vptq_tpu_torch.examples import multichip_demo, quickstart
from vptq_tpu_torch.utils.synth_tokenizer import (
    ByteTokenizer,
    write_byte_tokenizer,
)

ROOT = Path(__file__).resolve().parents[1]


def _jax_quickstart_checkpoint(path):
    """The JAX quickstart's own call of its writer."""
    jsc.write_synthetic_checkpoint(
        path,
        jsc.tiny_model_config(
            vocab_size=512, hidden_size=256, intermediate_size=512,
            num_hidden_layers=4, num_attention_heads=8,
            num_key_value_heads=4, head_dim=32,
        ),
        vq_kwargs=dict(
            vector_len=8, num_centroids=4096, num_res_centroids=256,
            enable_norm=True, is_indice_packed=True,
        ),
    )


@pytest.fixture
def jax_pallas(monkeypatch):
    monkeypatch.setattr(native, "_lib", lambda: None)
    monkeypatch.setattr(sys.modules["vptq_tpu.ops.quant_matmul"], "_IMPL",
                        "pallas")
    monkeypatch.setenv("VPTQ_TPU_PALLAS_INTERPRET", "1")
    yield
    jax.clear_caches()


def test_quickstart_greedy_tokens_are_jax(tmp_path, capsys, jax_pallas):
    port = quickstart.write_quickstart_checkpoint(tmp_path / "port")
    _jax_quickstart_checkpoint(tmp_path / "jax")
    want = safetensors.numpy.load_file(tmp_path / "jax" / "model.safetensors")
    got = safetensors.numpy.load_file(port / "model.safetensors")
    assert sorted(got) == sorted(want)
    assert all(got[k].tobytes() == want[k].tobytes() for k in want)

    tokens = quickstart.main([str(port), "--device", "cpu", "--temperature",
                              "0", "--tokenizer", "byte", "--dtype",
                              "float32"])
    assert capsys.readouterr().out.startswith("generated:")
    from transformers import AutoTokenizer

    write_byte_tokenizer(tmp_path / "tok")
    ids = AutoTokenizer.from_pretrained(tmp_path / "tok")(
        quickstart.PROMPT, return_tensors=None)["input_ids"]
    assert ids == ByteTokenizer()(quickstart.PROMPT)["input_ids"]
    jgen = JGenerator(j_load_model(str(tmp_path / "jax"), dtype=jnp.float32,
                                   runtime_format="int8"), max_seq=512,
                      dtype=jnp.float32)
    assert tokens == jgen.generate(ids, max_new_tokens=32, temperature=0.0)
    assert len(tokens) == quickstart.NEW_TOKENS


def test_quickstart_samples_from_its_seed(tmp_path, capsys):
    port = str(quickstart.write_quickstart_checkpoint(tmp_path))
    argv = [port, "--device", "cpu", "--tokenizer", "byte"]
    first = quickstart.main(argv)
    assert quickstart.main(argv) == first
    assert quickstart.main([*argv, "--seed", "1"]) != first
    capsys.readouterr()


def _lines(out: str) -> dict:
    keys = ("TP tokens:", "CP prefill + TP decode next token:",
            "PP microbatch next tokens:", "demo OK")
    return {k: ln for ln in out.splitlines() for k in keys
            if ln.startswith(k)}


def _plan_numbers(out: str) -> tuple:
    placement = re.search(r"\(pp=(\d+) x tp=(\d+)\)", out).groups()
    fits = re.search(r"fits: ([\d.]+) GiB/", out).group(1)
    table = [ln for ln in out.splitlines() if ln.lstrip().startswith(
        ("format", "codebook", "int", "bf16"))]
    return placement, fits, table


def test_multichip_demo_prints_jax_tokens(capsys, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "jax_multichip_demo", ROOT / "examples" / "multichip_demo.py")
    jdemo = importlib.util.module_from_spec(spec)
    # the script sets up 8 CPU devices, which conftest has already made
    assert len(jax.devices()) >= 8
    with monkeypatch.context() as mp:
        mp.setattr(jax.config, "update", lambda *args: None)
        spec.loader.exec_module(jdemo)
    jdemo.main()
    want = capsys.readouterr().out
    steps = multichip_demo.main(["--device", "cpu", "--hbm-gb", "16"])
    got = capsys.readouterr().out
    assert _lines(got) == _lines(want) and len(_lines(want)) == 4
    assert f"TP tokens: {steps['tp']}" in got
    assert _plan_numbers(got) == _plan_numbers(want)
