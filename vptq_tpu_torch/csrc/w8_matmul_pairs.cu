// K5a w8_matmul_pairs on Hopper (sm_90a):
// y[p] = x[p] @ (scales[e_p] ⊙ wq[e_p])^T with e_p = ids[p], for all P
// (token, expert) pairs of a MoE decode step in one launch.
//
// Replaces vptq_tpu/ops/pallas_gemm.py:_w8p_kernel (entry
// w8_matmul_pairs). The TPU kernel broadcasts each row of x onto 8
// sublanes and slices row 0 back, a constraint of its compiler and no
// part of the function; here pair p is blockIdx.y of a grid of (row
// tiles, pairs), and each block runs K1's T = 1 GEMV on row p of x
// against the slab of expert ids[p], read from device memory in the
// block (w8.cuh, policy sel::Pairs).
//
//   x      (P, in_p)              bf16
//   wq     (E, out, in_p)         int8
//   scales (E, in_p/group, out)   f32
//   ids    (P,)                   int32, device memory
//   y      (P, out)               bf16 / f32
//
// What bounds it on an H100: the bytes of the distinct experts the pairs
// pick, each read once. Pairs that pick the same expert read its slab
// again (from L2 when they run close together): P slabs in the worst
// case, against min(P, E) distinct ones.

#include "w8.cuh"

// Arguments as vptq_w8_matmul_expert; T is the number of pairs.
extern "C" int vptq_w8_matmul_pairs(const void* x, const void* wq,
                                    const void* scales, const void* ids,
                                    void* y, int T, int out, int in_p,
                                    int group, int n_experts, int out_dtype,
                                    void* stream) {
  return w8::launch<sel::Pairs>(x, wq, scales, ids, y, T, out, in_p, group,
                                n_experts, out_dtype, stream);
}
