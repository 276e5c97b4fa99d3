"""K5a ``w8_matmul_pairs`` on the card: a ``%globaltimer`` timeline of
its blocks, and its plans.

Builds a second copy of ``csrc/w8_matmul_pairs.cu`` whose grouped decode
GEMV (``csrc/decode_gemv.cuh`` ``decode_gemv_grouped``) stamps
``%globaltimer`` and ``%smid`` at its hooks (``DG_STAMP_IF``, empty in the
port's own build): 0 the block's start, 1 its expert known, 2 the first
pass's x staged, 3 the first weight stage landed, 4 the last stage used,
5 y stored. For each case (Mixtral-8x7B's expert shapes at P = 2 and 16
over 8 experts, Moonlight-16B-A3B's at P = 6, 48 and 384 over 64; ids
the top-k of P / k tokens, drawn from a seed) it prints the port's
kernel's time (CUDA events, 1 GiB flush, median; up to two pairs its
route by P runs w8.cuh's GEMV) and bound, the grouped kernel's time at
its plan, and that launch's timeline: the span from the first block's start to the last one's end,
the medians of each phase, the blocks that found no expert, the blocks
an SM held and its live blocks on average, the SMs' end spread, and the
loop's rate (a block's weight bytes over its loop, times the live
blocks of the card). ``--plans`` also times every (columns, rows, split)
the kernel takes at each case, and w8.cuh's GEMV, beside the host's plan
(``ops/scaled_matmul.py`` ``pairs_plan``).

    python -m vptq_tpu_torch.examples.pairs_timeline [--plans] [--out FILE]

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
from vptq_tpu_torch.ops.w8_matmul_pairs import (
    w8_matmul_pairs,
    w8_matmul_pairs_reference,
)

__all__ = ["main"]

# what the stamped copy adds before its source: the stamps' buffer and
# the hook that writes them (thread 0 of a block: consumer warp 0)
_STAMPS = r'''
__device__ unsigned long long* g_tl;
#define DG_STAMP_IF(cond, i)                                                 \
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
_STAMPED = "w8_matmul_pairs_stamped"
VP, INT = ctypes.c_void_p, ctypes.c_int
# (label, E, top-k, [(shape, out, in_p, int8 group)], pair counts)
CASES = (
    ("Mixtral-8x7B", 8, 2,
     [("gate_up", 28672, 4096, 2048), ("down", 4096, 14336, 2048)], (2, 16)),
    ("Moonlight-16B-A3B", 64, 6,
     [("gate_up", 2816, 2048, 2048), ("down", 2048, 1536, 512)],
     (6, 48, 384)),
)


def build_stamped():
    """The stamped copy's library: the port's source after the stamps'
    prelude, built as the port builds its own (with its own statics)."""
    src_dir = _build.BUILD_DIR / "timeline"
    src_dir.mkdir(parents=True, exist_ok=True)
    src = src_dir / f"{_STAMPED}.cu"
    src.write_text(_STAMPS + (_build.SRC_DIR / "w8_matmul_pairs.cu")
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
    fn = lib.vptq_w8_matmul_pairs
    fn.argtypes, fn.restype = [VP] * 5 + [INT] * 9 + [VP], INT
    return fn


def _call(fn, x, wq, sc, ids, cols, rows, split):
    n_experts, out_f, in_p = wq.shape
    y = torch.empty((x.shape[0], out_f), dtype=torch.bfloat16,
                    device=x.device)
    err = fn(x.data_ptr(), wq.data_ptr(), sc.data_ptr(), ids.data_ptr(),
             y.data_ptr(), x.shape[0], out_f, in_p, in_p // sc.shape[1],
             n_experts, cols, rows, split, 0,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return y


def grouped_plan(out_f, in_p, pairs, n_experts, n_sm) -> tuple:
    """The grouped kernel's plan, also where the host's route by P sends
    the pairs to w8.cuh's GEMV (the plan as it would be past the route)."""
    keep = sm.PAIRS_GEMV_MAX
    sm.PAIRS_GEMV_MAX = 0
    sm.pairs_plan.cache_clear()
    try:
        return sm.pairs_plan(out_f, in_p, pairs, n_experts, n_sm)
    finally:
        sm.PAIRS_GEMV_MAX = keep
        sm.pairs_plan.cache_clear()


def timeline(lib, x, wq, sc, ids, cols, rows, split, flush) -> dict:
    """One launch of the stamped copy: its blocks' phases."""
    n_experts, out_f, in_p = wq.shape
    n_blocks = split * -(-out_f // rows) * min(x.shape[0], n_experts)
    buf = torch.zeros(n_blocks * 8, dtype=torch.int64, device=x.device)
    fn = _entry(lib)
    flush.zero_()
    torch.cuda.synchronize()
    if lib.set_tl(VP(buf.data_ptr())):
        raise RuntimeError("set_tl failed")
    _call(fn, x, wq, sc, ids, cols, rows, split)
    torch.cuda.synchronize()
    lib.set_tl(VP(0))
    t = buf.view(n_blocks, 8).cpu().tolist()
    base = min(r[0] for r in t)
    # each block's passes: its slot's expert (the slot-th distinct id) and
    # that expert's count of pairs
    counts_of = torch.bincount(ids.long().clamp(0, n_experts - 1).cpu(),
                               minlength=n_experts)
    present = counts_of.nonzero().flatten().tolist()
    per_slot = split * -(-out_f // rows)
    live = [[(r[i] - base) / 1e3 for i in range(6)]
            + [r[7], -(-int(counts_of[present[b // per_slot]]) // cols)]
            for b, r in enumerate(t) if r[5]]
    end = max(r[5] for r in live)
    per_sm = {}
    for r in live:
        per_sm.setdefault(r[6], []).append(r)
    sm_end = sorted(max(b[5] for b in v) for v in per_sm.values())
    counts = sorted(len(v) for v in per_sm.values())
    busy = sum(r[5] - r[0] for r in live)
    stages = -(-(in_p // 128) // split)
    # the weight bytes over the loop of each block, its passes' all
    rate = statistics.median(rows * stages * 128 * r[7] / (r[4] - r[3])
                             for r in live)
    mean_live = busy / end / len(per_sm)

    def med(i, j):
        return round(statistics.median(r[j] - r[i] for r in live), 3)

    return dict(
        blocks=n_blocks, empty_slots=n_blocks - len(live),
        span_us=round(end, 3), block_us=med(0, 5), prologue_us=med(0, 1),
        x_staged_us=med(1, 2), first_stage_us=med(1, 3), loop_us=med(3, 4),
        epilogue_us=med(4, 5), sms=len(per_sm),
        blocks_an_sm=[counts[0], counts[-1]],
        live_blocks_an_sm=round(mean_live, 3),
        sm_end_us=[round(sm_end[0], 3), round(statistics.median(sm_end), 3),
                   round(sm_end[-1], 3)],
        passes=max(r[7] for r in live),
        loop_tb_s=round(rate * 1e-6 * mean_live * len(per_sm), 3),
    )


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--plans", action="store_true",
                        help="also time every (columns, rows, split) at "
                             "each case")
    parser.add_argument("--out", default="")
    parser.add_argument("--iters", type=int, default=30)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("pairs_timeline needs a CUDA device")
    device = torch.device("cuda")
    print(card_line(device), flush=True)
    lib = build_stamped()
    real = _entry(_build.load("w8_matmul_pairs", {
        "vptq_w8_matmul_pairs": ([VP] * 5 + [INT] * 9 + [VP], INT)}))
    n_sm = sm.sm_count(device)
    flush = flush_buffer(device)
    gen = torch.Generator(device=device).manual_seed(0)
    cpu = torch.Generator().manual_seed(0)
    rows_out = []
    for label, n_experts, top, shapes, pair_counts in CASES:
        for shape, out_f, in_p, group in shapes:
            wq = torch.randint(-128, 128, (n_experts, out_f, in_p),
                               generator=gen, device=device,
                               dtype=torch.int8)
            sc = torch.rand((n_experts, in_p // group, out_f), generator=gen,
                            device=device) * 1e-2
            for pairs in pair_counts:
                ids = torch.cat([
                    torch.randperm(n_experts, generator=cpu)[:top]
                    for _ in range(-(-pairs // top))])[:pairs]
                distinct = len(set(ids.tolist()))
                ids = ids.to(device=device, dtype=torch.int32)
                x = torch.randn((pairs, in_p), generator=gen,
                                device=device).to(torch.bfloat16)
                got = w8_matmul_pairs(x, wq, sc, ids)
                want = w8_matmul_pairs_reference(x, wq, sc, ids)
                err = (got.float() - want.float()).abs()
                if not bool((err <= 1e-2 * want.float().abs()
                             + 1e-3 * want.float().abs().max()).all()):
                    raise AssertionError(f"{label} {shape} P={pairs}: "
                                         f"max |err| {err.max().item()}")
                routed = sm.pairs_plan(out_f, in_p, pairs, n_experts,
                                       n_sm)[2] == 0
                cols, rows, split = grouped_plan(out_f, in_p, pairs,
                                                 n_experts, n_sm)
                stamped = _call(_entry(lib), x, wq, sc, ids, cols, rows,
                                split)
                if not torch.equal(stamped, _call(real, x, wq, sc, ids, cols,
                                                  rows, split)):
                    raise AssertionError("the stamped copy computes another y")
                nbytes = (distinct * (out_f * in_p + sc[0].numel() * 4)
                          + pairs * (in_p * 2 + 4 + out_f * 2))
                row = dict(
                    model=label, shape=shape, P=pairs, E=n_experts,
                    distinct=distinct, cols=cols, rows=rows, split=split,
                    route="w8_gemv" if routed else "grouped",
                    ms=time_ms(lambda: w8_matmul_pairs(x, wq, sc, ids),
                               device, args.iters, flush),
                    grouped_ms=time_ms(
                        lambda: _call(real, x, wq, sc, ids, cols, rows,
                                      split), device, args.iters, flush),
                    bound_ms=nbytes / (3.35e12) * 1e3,
                    timeline=timeline(lib, x, wq, sc, ids, cols, rows,
                                      split, flush),
                )
                if args.plans:
                    # w8.cuh's GEMV, one pair a grid row (split 0), beside
                    plans = {"w8_gemv": time_ms(
                        lambda: _call(real, x, wq, sc, ids, cols, 32, 0),
                        device, args.iters, flush)}
                    for c in sorted({cols, min(pairs, sm.PAIRS_MAX_COLS)}):
                        for r in (32, 64):
                            for s in sm.DECODE_SPLITS:
                                if s > in_p // 128:
                                    continue
                                plans[f"c{c}r{r}s{s}"] = time_ms(
                                    lambda c=c, r=r, s=s: _call(
                                        real, x, wq, sc, ids, c, r, s),
                                    device, args.iters, flush)
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
