"""The port's fidelity gauntlet (``vptq_tpu_torch/examples/
fidelity_gauntlet.py``) against ``scripts/fidelity_gauntlet.py``'s
``main`` on the CPU, at the smallest geometry where JAX runs every row
(``--hidden 256 --layers 1``; the default seed 23).

JAX runs with its Pallas kernels in interpret mode (as the port's plain
versions, they round x to bf16; its XLA path keeps x in f32, which moves
the int8 row's KL by 5%) and its numpy encoders. Each row's
``bits_per_weight_7b`` is JAX's exactly; its unrounded logit KL (both
scripts' KL functions wrapped to record it) within ``RTOL`` of JAX's: the
bf16, int8 and RTN rows run the same codes and levels and differ only in
the order of their f32 sums (measured: at most 3.7e-5 relative, int4-rtn),
the calibrated rows in a stated share of GPTQ's codes as well
(``tests/test_torch_gptq.py``: ≤ 0.1% of the codes; measured: at most
6.5e-5 relative, int4-mixed). The JSON keys and the generator's description are JAX's.
"""

import functools
import importlib.util
import json
import sys
from pathlib import Path

import jax
import pytest

from vptq_tpu import native
from vptq_tpu_torch.examples import fidelity_gauntlet as tfg

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--hidden", "256", "--layers", "1"]
# |port - JAX| <= RTOL * JAX, per row
RTOL = {"exact": 2e-4, "calibrated": 1e-3}
CALIBRATED = ("int4-gptq", "int4-mixed", "int3-mixed", "int2-mixed")


def _recording(kl, into: list):
    def record(p, q):
        into.append(kl(p, q))
        return into[-1]
    return record


@functools.lru_cache(maxsize=None)
def _runs(out_dir: str):
    """(JAX's output, its unrounded KLs, the port's, its KLs), one KL a
    row in ladder order."""
    spec = importlib.util.spec_from_file_location(
        "jax_fidelity_gauntlet", ROOT / "scripts" / "fidelity_gauntlet.py")
    jfg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jfg)
    jkl, tkl = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "_lib", lambda: None)
        mp.setattr(sys.modules["vptq_tpu.ops.quant_matmul"], "_IMPL",
                   "pallas")
        mp.setenv("VPTQ_TPU_PALLAS_INTERPRET", "1")
        mp.setattr(jfg, "_kl", _recording(jfg._kl, jkl))
        try:
            assert jfg.main([*ARGS, "-o", f"{out_dir}/jax.json"]) == 0
        finally:
            jax.clear_caches()
        mp.setattr(tfg, "kl", _recording(tfg.kl, tkl))
        tout = tfg.main([*ARGS, "-o", f"{out_dir}/port.json",
                         "--device", "cpu"])
    with open(f"{out_dir}/jax.json") as f:
        jout = json.load(f)
    return jout, jkl, tout, tkl


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _runs(str(tmp_path_factory.mktemp("gauntlet")))


@pytest.mark.parametrize("row", [name for name, _, _ in tfg.LADDER])
def test_row_is_jax(runs, row):
    jout, jkl, tout, tkl = runs
    names = [r["format"] for r in jout["rows"]]
    assert names == [r["format"] for r in tout["rows"]]
    i = names.index(row)
    want, got = jout["rows"][i], tout["rows"][i]
    assert list(got) == list(want)
    assert got["bits_per_weight_7b"] == want["bits_per_weight_7b"]
    tol = RTOL["calibrated" if row in CALIBRATED else "exact"]
    gap = abs(tkl[i] - jkl[i]) / jkl[i]
    assert gap <= tol, (row, tkl[i], jkl[i], gap)


def test_output_is_jax(runs):
    """The generator's description and the keys are JAX's; the default
    output is not the JAX script's FIDELITY.json."""
    jout, _, tout, _ = runs
    assert list(tout) == list(jout)
    assert tout["generator"] == jout["generator"]
    assert tfg.DEFAULT_OUTPUT != "FIDELITY.json"
