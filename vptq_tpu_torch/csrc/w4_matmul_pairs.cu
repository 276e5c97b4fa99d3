// K5b w4_matmul_pairs on Hopper (sm_90a):
// y[p] = x[p] @ (scales[e_p]^T ⊙ unpack_int4(wq[e_p]))^T with
// e_p = ids[p], for all P (token, expert) pairs of a MoE decode step in
// one launch.
//
// Replaces vptq_tpu/ops/pallas_gemm.py:_w4p_kernel (entry
// w4_matmul_pairs). The TPU kernel's 8-sublane broadcast of each row is a
// constraint of its compiler and no part of the function.
//
//   x      (P, in_p)             bf16
//   wq     (E, out, in_p / 2)    int8, split-half nibbles (w4.cuh)
//   scales (E, in_p / 128, out)  bf16
//   ids    (P,)                  int32, device memory
//   y      (P, out)              bf16 / f32
//
// What bounds it on an H100: the bytes of the distinct experts the pairs
// pick, each read once (Mixtral-8x7B, P = 2: two slabs of gate_up and of
// down, 181.6 MB a layer, 0.054 ms at 3.35 TB/s); pairs that pick the
// same expert read its slab again.
//
// Design: K2's Hopper decode GEMV (decode_gemv.cuh) with the policy
// sel::Pairs on a grid of (split, row blocks, P): each block reads ids[p]
// first, moves to that expert's slab and to row p of x and y, and streams
// the slab through the GEMV's asynchronous weight ring, one token a block,
// its cluster of `split` blocks splitting the positions. The split comes
// from ops/scaled_matmul.py decode_split, planned for all P pairs' blocks;
// 0 (no split fits) runs lowbit.cuh's GEMV at T = 1 on a grid of (row
// tiles, pairs).

#include "w4.cuh"

// Arguments as vptq_w4_matmul_expert; T is the number of pairs; split:
// the decode GEMV's cluster size (0: lowbit.cuh's gemv).
extern "C" int vptq_w4_matmul_pairs(const void* x, const void* wq,
                                    const void* scales, const void* ids,
                                    void* y, int T, int out, int in_p,
                                    int n_experts, int split, int out_dtype,
                                    void* stream) {
  return w4::launch<sel::Pairs>(x, wq, scales, ids, y, T, out, in_p,
                                n_experts, out_dtype, stream, split);
}
