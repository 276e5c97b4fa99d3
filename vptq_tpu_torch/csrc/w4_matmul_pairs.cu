// K5b w4_matmul_pairs on Hopper (sm_90a):
// y[p] = x[p] @ (scales[e_p]^T ⊙ unpack_int4(wq[e_p]))^T with
// e_p = ids[p], for all P (token, expert) pairs of a MoE decode step in
// one launch.
//
// Replaces vptq_tpu/ops/pallas_gemm.py:_w4p_kernel (entry
// w4_matmul_pairs). Pair p is blockIdx.y of a grid of (row tiles, pairs);
// each block runs K2's T = 1 GEMV on row p of x against the slab of
// expert ids[p], read from device memory in the block (lowbit.cuh, policy
// sel::Pairs). The TPU kernel's 8-sublane broadcast of each row is a
// constraint of its compiler and no part of the function.
//
//   x      (P, in_p)             bf16
//   wq     (E, out, in_p / 2)    int8, split-half nibbles (w4.cuh)
//   scales (E, in_p / 128, out)  bf16
//   ids    (P,)                  int32, device memory
//   y      (P, out)              bf16 / f32
//
// What bounds it on an H100: the bytes of the distinct experts the pairs
// pick, each read once; pairs that pick the same expert read its slab
// again.

#include "w4.cuh"

// Arguments as vptq_w4_matmul_expert; T is the number of pairs.
extern "C" int vptq_w4_matmul_pairs(const void* x, const void* wq,
                                    const void* scales, const void* ids,
                                    void* y, int T, int out, int in_p,
                                    int n_experts, int out_dtype,
                                    void* stream) {
  return w4::launch<sel::Pairs>(x, wq, scales, ids, y, T, out, in_p,
                                n_experts, out_dtype, stream);
}
