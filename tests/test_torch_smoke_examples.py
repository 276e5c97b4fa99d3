"""The smoke's phases of the ported examples and of a codebook model under
a mesh, rehearsed on the CPU at a tiny size (the plain versions run, so
no kernel is launched): the gauntlet (every rung's KL through the plain
versions twice: gap 0), the sweeps (the plans only), quickstart, the
multichip demo on 4 gloo ranks, and a codebook model over 2 gloo ranks
against one device. This file imports no JAX."""

from pathlib import Path

from torch_port import TINY, VQ

import chip_smoke


def test_chip_smoke_gauntlet_on_cpu(capsys):
    out = chip_smoke.phase_gauntlet("cpu", "cpu", hidden=64, layers=1)
    assert list(out["rows"]) == [
        "bf16", "int8", "int4-rtn", "int4-gptq", "int4-mixed", "int3-rtn",
        "int3-mixed", "int2-rtn", "int2-mixed"]
    assert all(r["gap"] == 0 for r in out["rows"].values())
    assert set(out["launches"].values()) == {0}
    assert capsys.readouterr().out.count("gauntlet [cpu] ") == 9


def test_chip_smoke_sweeps_on_cpu(capsys):
    out = chip_smoke.phase_sweeps("cpu", "cpu")
    assert len(out["best"]) == 15 and set(out["launches"].values()) == {0}
    assert "route split=" in capsys.readouterr().out


def test_chip_smoke_quickstart_and_demo_on_cpu(monkeypatch, capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = chip_smoke.phase_quickstart("cpu")
    assert len(out["tokens"]) == 32
    out = chip_smoke.phase_demo("cpu")
    assert out["steps"]["pp"][0] == out["steps"]["tp"][0]
    assert "demo OK" in capsys.readouterr().out


def test_chip_smoke_tp_codebook_on_cpu(monkeypatch, capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(chip_smoke, "CODEBOOK_TP_PROMPT", 40)
    cfg = dict(TINY, tie_word_embeddings=False)
    path, _ = chip_smoke.write_checkpoint(cfg, VQ)
    try:
        out = chip_smoke.phase_tp_codebook("cpu", path, 256, "cpu", layers=2)
    finally:
        import shutil

        shutil.rmtree(path, ignore_errors=True)
    assert [r["tokens_equal"] for r in out["ranks"]] == [True, True]
    assert all(r["gap"] <= chip_smoke.LOGIT_TOL for r in out["ranks"])
    assert "tp codebook [cpu" in capsys.readouterr().out
    assert not Path(path).exists()
