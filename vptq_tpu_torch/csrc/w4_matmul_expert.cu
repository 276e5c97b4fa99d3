// K6b w4_matmul_expert on Hopper (sm_90a):
// y = x @ (scales[e]^T ⊙ unpack_int4(wq[e]))^T for the one expert
// e = ids[0] of a stack, e read from device memory inside the kernel.
//
// Replaces vptq_tpu/ops/pallas_gemm.py:_w4e_kernel (entry
// w4_matmul_expert), which gets e by scalar prefetch. It carries the MoE
// prefill in the int4 format: every expert on every token, 2·E launches
// per layer.
//
//   x      (T, in_p)             bf16, any T
//   wq     (E, out, in_p / 2)    int8, split-half nibbles (w4.cuh)
//   scales (E, in_p / 128, out)  bf16
//   ids    (1,)                  int32, device memory
//   y      (T, out)              bf16 / f32
//
// What bounds it on an H100: the bytes of ONE expert's slab at T <= 16
// (58.7 MB of Mixtral's gate_up plus 1.8 MB of scales, 0.018 ms at
// 3.35 TB/s), the bf16 tensor-core FLOPs at prefill. No copy of the slab
// is made: the offset e·out·in_p/2 (scales: e·out·in_p/128) is added, in
// 64 bits, to K2's own loops (lowbit.cuh, policy sel::Expert).

#include "w4.cuh"

// Arguments as vptq_w4_matmul, plus ids and n_experts.
extern "C" int vptq_w4_matmul_expert(const void* x, const void* wq,
                                     const void* scales, const void* ids,
                                     void* y, int T, int out, int in_p,
                                     int n_experts, int out_dtype,
                                     void* stream) {
  return w4::launch<sel::Expert>(x, wq, scales, ids, y, T, out, in_p,
                                 n_experts, out_dtype, stream);
}
