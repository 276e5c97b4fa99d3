"""P1 / P2 ``w4_probe_matmul`` on the card: a ``%globaltimer`` timeline of
its blocks, and its plans.

Builds a second copy of ``csrc/w4_probe_matmul.cu`` whose ring GEMV
stamps ``%globaltimer`` and ``%smid`` at its hooks (``RG_STAMP_IF``, empty
in the port's own build): 0 the block's start, 1 x and the scales
staged, 2 the first weight stage landed, 3 the last stage used, 4 y
stored. For each mode at each of the probe scripts' Llama-2-7B decode
shapes (``chip_smoke.PROBE_SHAPES``; ``--shapes`` picks some) and token
count (``--tokens``, default 1) it prints the port's kernel's time (CUDA
events, 1 GiB flush, median) and bound, and one launch's timeline at the
host's plan (``ops/w4_probe_matmul.py`` ``probe_plan``): the span from the
first block's start to the last one's end, the medians of each phase,
the blocks an SM held and its live blocks on average, the SMs' end
spread, and the loop's rate (a block's weight bytes over its loop, times
the live blocks of the card). ``--plans`` also times every (token tile,
split) the kernel takes at each case.

    python -m vptq_tpu_torch.examples.probe_timeline [--modes prod,t8]
        [--shapes gate_up,down] [--tokens 1,8,16] [--plans] [--out FILE]

It needs the card: without CUDA it exits non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

import torch

from vptq_tpu_torch.examples.kernel_bench import (
    card_line,
    flush_buffer,
    time_ms,
)
from vptq_tpu_torch.ops import _build
from vptq_tpu_torch.ops import scaled_matmul as sm
from vptq_tpu_torch.ops.w4_probe_matmul import (
    F32_X_MODES,
    W4_PROBE_MODES,
    probe_plan,
    probe_rows,
    w4_probe_matmul,
    w4_probe_matmul_reference,
)

__all__ = ["main"]

# what the stamped copy adds before its source: the stamps' buffer and
# the hook that writes them (thread 0 of a block: consumer warp 0)
_STAMPS = r'''
__device__ unsigned long long* g_tl;
#define RG_STAMP_IF(cond, i)                                                 \
  do {                                                                       \
    if (g_tl && threadIdx.x == 0 && (cond)) {                                \
      unsigned long long t_;                                                 \
      unsigned s_;                                                           \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                 \
      asm volatile("mov.u32 %0, %%smid;" : "=r"(s_));                        \
      const size_t b_ =                                                      \
          ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +        \
          blockIdx.x;                                                        \
      g_tl[b_ * 8 + (i)] = t_;                                               \
      g_tl[b_ * 8 + 7] = s_;                                                 \
    }                                                                        \
  } while (0)
extern "C" int set_tl(void* p) {
  return (int)cudaMemcpyToSymbol(g_tl, &p, sizeof(p));
}
'''
_STAMPED = "w4_probe_matmul_stamped"
VP, INT = ctypes.c_void_p, ctypes.c_int
_ARGS = [VP] * 4 + [INT] * 7 + [VP]
SHAPES = {"gate_up": (22016, 4096), "down": (4096, 12288),
          "qkv": (12288, 4096), "o": (4096, 4096)}


def build_stamped():
    """The stamped copy's library: the port's source after the stamps'
    prelude, built as the port builds its own (with its own statics)."""
    src_dir = _build.BUILD_DIR / "timeline"
    src_dir.mkdir(parents=True, exist_ok=True)
    src = src_dir / f"{_STAMPED}.cu"
    src.write_text(_STAMPS + (_build.SRC_DIR / "w4_probe_matmul.cu")
                   .read_text())
    lib = src_dir / f"lib{_STAMPED}.so"
    subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xcompiler",
         "-fno-gnu-unique", "-I", str(_build.SRC_DIR), "-o", str(lib),
         str(src)],
        check=True, capture_output=True, text=True)
    out = ctypes.CDLL(str(lib))
    out.set_tl.argtypes, out.set_tl.restype = [VP], INT
    return out


def _entry(lib):
    fn = lib.vptq_w4_probe_matmul
    fn.argtypes, fn.restype = _ARGS, INT
    return fn


def _call(fn, x, wq, sc, mode, tile, split):
    """One launch through the C entry at (tile, split), bf16 out."""
    out_f, in_p = wq.shape[0], wq.shape[1] * 2
    y = torch.empty((x.shape[0], out_f), dtype=torch.bfloat16,
                    device=x.device)
    err = fn(x.data_ptr(), wq.data_ptr(), sc.data_ptr(), y.data_ptr(),
             x.shape[0], out_f, in_p, W4_PROBE_MODES[mode], split, tile, 0,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return y


def timeline(lib, x, wq, sc, mode, tile, split, flush) -> dict:
    """One launch of the stamped copy: its blocks' phases."""
    out_f, in_p = wq.shape[0], wq.shape[1] * 2
    tokens = x.shape[0]
    rows = probe_rows(tile)
    n_blocks = split * -(-out_f // rows) * -(-tokens // tile)
    buf = torch.zeros(n_blocks * 8, dtype=torch.int64, device=x.device)
    flush.zero_()
    torch.cuda.synchronize()
    if lib.set_tl(VP(buf.data_ptr())):
        raise RuntimeError("set_tl failed")
    _call(_entry(lib), x, wq, sc, mode, tile, split)
    torch.cuda.synchronize()
    lib.set_tl(VP(0))
    t = buf.view(n_blocks, 8).cpu().tolist()
    base = min(r[0] for r in t)
    blocks = [[(r[i] - base) / 1e3 for i in range(5)] + [r[7]] for r in t]
    end = max(r[4] for r in blocks)
    per_sm = {}
    for r in blocks:
        per_sm.setdefault(r[5], []).append(r)
    sm_end = sorted(max(b[4] for b in v) for v in per_sm.values())
    counts = sorted(len(v) for v in per_sm.values())
    busy = sum(r[4] - r[0] for r in blocks)
    # a block's weight bytes: its rows' stages of 128 bytes
    stages = in_p // 2 // 128 // split
    rate = statistics.median(rows * stages * 128 / max(r[3] - r[2], 1e-3)
                             for r in blocks)
    mean_live = busy / end / len(per_sm)

    def med(i, j):
        return round(statistics.median(r[j] - r[i] for r in blocks), 3)

    return dict(
        blocks=n_blocks, span_us=round(end, 3), block_us=med(0, 4),
        staged_us=med(0, 1), first_stage_us=med(1, 2), loop_us=med(2, 3),
        epilogue_us=med(3, 4), sms=len(per_sm),
        blocks_an_sm=[counts[0], counts[-1]],
        live_blocks_an_sm=round(mean_live, 3),
        sm_end_us=[round(sm_end[0], 3), round(statistics.median(sm_end), 3),
                   round(sm_end[-1], 3)],
        loop_tb_s=round(rate * 1e-6 * mean_live * len(per_sm), 3),
    )


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--modes", default=",".join(W4_PROBE_MODES))
    parser.add_argument("--shapes", default=",".join(SHAPES))
    parser.add_argument("--tokens", default="1")
    parser.add_argument("--plans", action="store_true",
                        help="also time every (token tile, split) at each "
                             "case")
    parser.add_argument("--out", default="")
    parser.add_argument("--iters", type=int, default=30)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_timeline needs a CUDA device")
    device = torch.device("cuda")
    print(card_line(device), flush=True)
    lib = build_stamped()
    real = _entry(_build.load("w4_probe_matmul",
                              {"vptq_w4_probe_matmul": (_ARGS, INT)}))
    n_sm = sm.sm_count(device)
    flush = flush_buffer(device)
    gen = torch.Generator(device=device).manual_seed(0)
    rows_out = []
    for shape in args.shapes.split(","):
        out_f, in_p = SHAPES[shape]
        wq = torch.randint(-120, 120, (out_f, in_p // 2), generator=gen,
                           device=device, dtype=torch.int8)
        sc = (0.005 * (1 + torch.rand((in_p // 128, out_f), generator=gen,
                                      device=device))).to(torch.bfloat16)
        for tokens in (int(t) for t in args.tokens.split(",")):
            xb = torch.randn((tokens, in_p), generator=gen,
                             device=device).to(torch.bfloat16)
            for mode in args.modes.split(","):
                x = xb.float() if mode in F32_X_MODES else xb
                got = w4_probe_matmul(x, wq, sc, mode)
                want = w4_probe_matmul_reference(x, wq, sc, mode)
                err = (got.float() - want.float()).abs()
                if not bool((err <= 1e-2 * want.float().abs()
                             + 1e-3 * want.float().abs().max()).all()):
                    raise AssertionError(f"{mode} {shape} T={tokens}: "
                                         f"max |err| {err.max().item()}")
                tile, split = probe_plan(out_f, in_p, tokens, n_sm, mode)
                if not torch.equal(
                        _call(_entry(lib), x, wq, sc, mode, tile, split),
                        _call(real, x, wq, sc, mode, tile, split)):
                    raise AssertionError("the stamped copy computes another y")
                reads = (x, wq, sc[::2] if mode == "g256" else sc)
                nbytes = (sum(a.numel() * a.element_size() for a in reads)
                          + tokens * out_f * 2)
                row = dict(
                    mode=mode, shape=shape, T=tokens, tile=tile, split=split,
                    ms=time_ms(lambda: w4_probe_matmul(x, wq, sc, mode),
                               device, args.iters, flush),
                    bound_ms=nbytes / 3.35e12 * 1e3,
                    timeline=timeline(lib, x, wq, sc, mode, tile, split,
                                      flush),
                )
                if args.plans:
                    plans = {}
                    for t in (8, 16):
                        for s in sm.DECODE_SPLITS:
                            groups = in_p // 2 // (
                                256 if mode == "g256" else 128)
                            if s > groups:
                                continue
                            try:
                                plans[f"t{t}s{s}"] = time_ms(
                                    lambda t=t, s=s: _call(
                                        real, x, wq, sc, mode, t, s),
                                    device, args.iters, flush)
                            except RuntimeError:
                                plans[f"t{t}s{s}"] = None  # no block fits
                    row["plans"] = plans
                rows_out.append(row)
                print(json.dumps(row), flush=True)
        del wq, sc
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows_out, f, indent=1)
    print(card_line(device), flush=True)


if __name__ == "__main__":
    sys.exit(main())
