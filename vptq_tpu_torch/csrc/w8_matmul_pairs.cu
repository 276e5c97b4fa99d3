// K5a w8_matmul_pairs on Hopper (sm_90a):
// y[p] = x[p] @ (scales[e_p] ⊙ wq[e_p])^T with e_p = ids[p], for all P
// (token, expert) pairs of a MoE decode step in one launch.
//
// Replaces vptq_tpu/ops/pallas_gemm.py:_w8p_kernel (entry
// w8_matmul_pairs). The TPU kernel broadcasts each row of x onto 8
// sublanes and slices row 0 back, a constraint of its compiler and no
// part of the function; the TPU grid visits one pair at a time.
//
//   x      (P, in_p)              bf16
//   wq     (E, out, in_p)         int8
//   scales (E, in_p/group, out)   f32, group a multiple of 128
//   ids    (P,)                   int32, device memory
//   y      (P, out)               bf16 / f32
//
// What bounds it on an H100: the bytes of the distinct experts the pairs
// pick, each read once (Mixtral-8x7B at P = 16, 8 slots' top 2: some 5.4
// of 8 experts' gate_up and down, 0.28 ms a layer at 3.35 TB/s). A
// kernel that runs one pair a block reads one slab a pair: P slabs
// against min(P, E) distinct ones (6x at 64 tokens of Moonlight's top 6),
// and L2 (50 MB) holds none of them (a Mixtral gate_up slab is 117 MB).
//
// Design: decode_gemv.cuh's decode GEMV with the selection sel::Grouped
// (decode_gemv_grouped, policy w8::W8): a grid of (split, row blocks,
// min(P, E) slots); the blocks of slot s find the s-th distinct expert of
// the ids on the card (a bitmap, popcounts, ballots: no host read, no
// extra launch, the grid fixed by P, E and the shapes, so that the
// decode graphs capture it) and stream its rows once through the
// asynchronous cp.async ring for all of its pairs, which are mma.sync's
// N columns (`cols` a pass), each column's row of y written to its
// pair's row. The host plans cols, the rows of a block and the cluster's
// split (ops/scaled_matmul.py pairs_plan). At P <= 2 (one token's top 2:
// every expert one pair, no byte to save) the plan's split 0 routes to
// w8.cuh's GEMV on a grid of (row tiles, pairs) (sel::Pairs), 15% faster
// there on an H100 (PERF.md).

#include "w8.cuh"

// Arguments as vptq_w8_matmul_expert; T is the number of pairs; cols:
// the columns of a pass (1 to 16); rows: a block's (32 or 64); split: the
// cluster's blocks, 0 for w8.cuh's GEMV on a grid of (row tiles, pairs).
extern "C" int vptq_w8_matmul_pairs(const void* x, const void* wq,
                                    const void* scales, const void* ids,
                                    void* y, int T, int out, int in_p,
                                    int group, int n_experts, int cols,
                                    int rows, int split, int out_dtype,
                                    void* stream) {
  // the route by P alone: split 0 (P <= 2 in the host's plan) runs
  // w8.cuh's GEMV, one pair a grid row, which the grouped kernel does not
  // beat where every expert has one pair
  if (split == 0)
    return w8::launch<sel::Pairs>(x, wq, scales, ids, y, T, out, in_p, group,
                                  n_experts, out_dtype, stream);
  if (group < dgemv::kStage || group % dgemv::kStage)
    return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* w = static_cast<const uint8_t*>(wq);
  const auto* sc = static_cast<const float*>(scales);
  const lowbit::Ids id = {static_cast<const int*>(ids), n_experts};
  const int gs = group / dgemv::kStage;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0:
      return (int)dgemv::launch_grouped<w8::W8, sel::Grouped>(
          xb, w, sc, static_cast<__nv_bfloat16*>(y), T, out, in_p, gs, cols,
          rows, split, id, s);
    case 1:
      return (int)dgemv::launch_grouped<w8::W8, sel::Grouped>(
          xb, w, sc, static_cast<float*>(y), T, out, in_p, gs, cols, rows,
          split, id, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
