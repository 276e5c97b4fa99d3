"""Fidelity gauntlet: the runtime-format ladder on heavy-tailed weights.

The port of ``scripts/fidelity_gauntlet.py``. It writes a synthetic
checkpoint whose exact weights have Student-t(4) centroid marginals and
lognormal per-channel scales with ``max(4, in / 128)`` channels boosted
4–10× (``utils/synth.py`` ``heavy_tailed=True``), loads it as the exact
codebook model (f32, unfused), and runs each rung of the ladder against
it: bf16, int8, int4 (RTN and GPTQ), int4-mixed, int3 and int3-mixed,
int2 and int2-mixed, the calibrated rungs sharing one batch of 1024
synthetic tokens (seq 256, seed 7). Each row: the format, its bits per
weight at Llama-2-7B's block shapes (``utils/memory.py``
``linear_runtime_bytes``), the logit KL against the exact model over the
same (4, 64) tokens (``default_rng(11)``; logits in f32, the KL in f64),
``dppl_equiv_pct`` = 100·(exp(KL) − 1) and the row's wall seconds. The
rows are printed as they come and written, with the generator's
description, to ``--output``::

    python -m vptq_tpu_torch.examples.fidelity_gauntlet
        [-o fidelity_torch.json] [--hidden 512] [--layers 4] [--seed 23]
        [--device cpu]

The int8, int4, int3 and int2 rungs run K1, K2, K4 and K3 (the mixed
ones their base kernel and K1 on the side). Without a CUDA device it
exits non-zero unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time

import numpy as np
import torch

from vptq_tpu_torch.models.llama import forward, init_cache
from vptq_tpu_torch.models.loader import entry_device, load_model
from vptq_tpu_torch.quant.calibrate import synthetic_calibration_tokens
from vptq_tpu_torch.utils.memory import linear_runtime_bytes
from vptq_tpu_torch.utils.synth_checkpoint import (
    tiny_model_config,
    write_synthetic_checkpoint,
)

__all__ = [
    "DEFAULT_OUTPUT", "LADDER", "bits_at_7b", "gauntlet", "kl", "main",
]

# (row, load keywords, the format its bits are counted in); "calibrated"
# stands for the shared calibration batch. int4-mixed's bits are the
# measured default's mix of sites (3/8 int8, 5/8 int4).
LADDER = (
    ("bf16", dict(runtime_format="bf16"), "bf16"),
    ("int8", dict(runtime_format="int8"), "int8"),
    ("int4-rtn", dict(runtime_format="int4"), "int4"),
    ("int4-gptq", dict(runtime_format="int4", calibration="calibrated"),
     "int4"),
    ("int4-mixed", dict(runtime_format="int4-mixed",
                        calibration="calibrated"), None),
    ("int3-rtn", dict(runtime_format="int3"), "int3"),
    ("int3-mixed", dict(runtime_format="int3-mixed",
                        calibration="calibrated"), "int3-mixed"),
    ("int2-rtn", dict(runtime_format="int2"), "int2"),
    ("int2-mixed", dict(runtime_format="int2-mixed",
                        calibration="calibrated"), "int2-mixed"),
)
# not the JAX script's FIDELITY.json, a file of the JAX package's rounds
DEFAULT_OUTPUT = "fidelity_torch.json"
VOCAB = 1024
KL_TOKENS = (4, 64)
CALIBRATION = dict(n_tokens=1024, seq_len=256, seed=7)


def kl(p_logits: np.ndarray, q_logits: np.ndarray) -> float:
    """Mean over positions of KL(p || q) of two logit arrays (f64)."""
    def log_softmax(x):
        x = x - x.max(axis=-1, keepdims=True)
        return x - np.log(np.exp(x).sum(axis=-1, keepdims=True))

    lp, lq = log_softmax(p_logits), log_softmax(q_logits)
    return float(np.mean(np.sum(np.exp(lp) * (lp - lq), axis=-1)))


def bits_at_7b(fmt: str) -> float:
    """Bits per weight of ``fmt`` over Llama-2-7B's block shapes."""
    shapes = ((12288, 4096), (4096, 4096), (22016, 4096), (4096, 11008))
    total = sum(linear_runtime_bytes(o, i, fmt) * 8 for o, i in shapes)
    return total / sum(o * i for o, i in shapes)


def _bits(name: str, key) -> float:
    if key == "bf16":
        return 16.0
    if key is not None:
        return round(bits_at_7b(key), 2)
    return round(0.375 * bits_at_7b("int8") + 0.625 * bits_at_7b("int4"), 2)


def _logits(model, tokens: torch.Tensor) -> np.ndarray:
    cache = init_cache(model.cfg, tokens.shape[0], tokens.shape[1] + 8,
                       torch.float32, tokens.device)
    with torch.no_grad():
        logits, _ = forward(model, tokens, cache, dtype=torch.float32)
    return logits.double().cpu().numpy()


def write_checkpoint(path, hidden: int, layers: int, seed: int):
    """The gauntlet's heavy-tailed checkpoint at ``path``; its config."""
    mc = tiny_model_config(
        vocab_size=VOCAB, hidden_size=hidden, intermediate_size=2 * hidden,
        num_hidden_layers=layers, num_attention_heads=8,
        num_key_value_heads=4, head_dim=hidden // 8,
    )
    write_synthetic_checkpoint(
        path, mc,
        vq_kwargs=dict(vector_len=8, num_centroids=4096, num_res_centroids=64,
                       enable_norm=True, is_indice_packed=True),
        seed=seed, heavy_tailed=True,
    )
    return mc


def gauntlet(hidden: int, layers: int, seed: int, device, plain=None):
    """Run the ladder on ``device``; returns (the output object, and with
    ``plain`` — a function of a row's runtime format giving a context in
    which the model runs its kernels' plain versions — each row's KL and
    its KL computed again inside that context, by row name)."""
    d = tempfile.mkdtemp(prefix="fidelity_")
    try:
        mc = write_checkpoint(d, hidden, layers, seed)
        exact = load_model(d, runtime_format="codebook",
                           dtype=torch.float32, fuse=False, device=device)
        rng = np.random.default_rng(11)
        tokens = torch.from_numpy(
            rng.integers(0, mc.vocab_size, KL_TOKENS).astype(np.int64)
        ).to(device)
        l_exact = _logits(exact, tokens)
        del exact
        calib = synthetic_calibration_tokens(mc.vocab_size, **CALIBRATION)
        rows, plain_kl = [], {}
        for name, kwargs, bits_key in LADDER:
            kwargs = dict(kwargs)
            if kwargs.get("calibration") == "calibrated":
                kwargs["calibration"] = calib
            t0 = time.time()
            model = load_model(d, device=device, **kwargs)
            kl_row = kl(l_exact, _logits(model, tokens))
            row = {
                "format": name,
                "bits_per_weight_7b": _bits(name, bits_key),
                "logit_kl": round(kl_row, 5),
                "dppl_equiv_pct": round(100.0 * (np.exp(kl_row) - 1.0), 2),
                "wall_s": round(time.time() - t0, 1),
            }
            rows.append(row)
            print(json.dumps(row), flush=True)
            if plain is not None:
                with plain(kwargs["runtime_format"]):
                    plain_kl[name] = (kl_row,
                                      kl(l_exact, _logits(model, tokens)))
            del model
    finally:
        shutil.rmtree(d, ignore_errors=True)
    out = {
        "generator": {
            "weights": "student-t(df=4) centroid marginals x "
            "lognormal(sigma=0.5) per-channel scales, ~0.8% channels "
            "boosted 4-10x (utils/synth.py heavy_tailed=True)",
            "geometry": {"hidden": hidden, "layers": layers,
                         "vocab": mc.vocab_size},
            "eval": "logit KL vs the EXACT codebook model over 256 "
            f"positions, {torch.device(device).type.upper()} f32; "
            "dppl_equiv_pct = 100*(exp(KL)-1) (raw PPL on random tokens "
            "is ~vocab-uniform for all formats — no signal)",
            "calibration_tokens": CALIBRATION["n_tokens"],
            "seed": seed,
        },
        "rows": rows,
    }
    return out, plain_kl


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("-o", "--output", default=DEFAULT_OUTPUT)
    parser.add_argument("--hidden", type=int, default=512)
    parser.add_argument("--layers", type=int, default=4)
    parser.add_argument("--seed", type=int, default=23)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = entry_device(args.device)
    out, _ = gauntlet(args.hidden, args.layers, args.seed, device)
    with open(args.output, "w") as f:
        json.dump(out, f, indent=1)
    print(f"# wrote {args.output}")
    return out


if __name__ == "__main__":
    main()
