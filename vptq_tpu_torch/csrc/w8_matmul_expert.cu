// K6a w8_matmul_expert on Hopper (sm_90a): y = x @ (scales[e] ⊙ wq[e])^T
// for the one expert e = ids[0] of a stack, e read from device memory
// inside the kernel.
//
// Replaces vptq_tpu/ops/pallas_gemm.py:_w8e_kernel (entry
// w8_matmul_expert), which gets e by scalar prefetch. It carries the MoE
// prefill: every expert on every token, 2·E launches per layer.
//
//   x      (T, in_p)              bf16, any T (the TPU kernel's caller
//                                 chunks at 512 tokens and pads T to 16
//                                 for VMEM; rows are independent here)
//   wq     (E, out, in_p)         int8
//   scales (E, in_p/group, out)   f32
//   ids    (1,)                   int32, device memory
//   y      (T, out)               bf16 / f32
//
// What bounds it on an H100: the bytes of ONE expert's slab at T <= 16
// (117 MB of Mixtral's gate_up, 0.035 ms at 3.35 TB/s), the bf16
// tensor-core FLOPs at prefill (2·T·out·in_p). The other E − 1 experts
// are never read, and no copy of the slab is made: the offset e·out·in_p
// is added, in 64 bits, to K1's own loops (w8.cuh, policy sel::Expert).

#include "w8.cuh"

// Arguments as vptq_w8_matmul, plus ids and n_experts.
extern "C" int vptq_w8_matmul_expert(const void* x, const void* wq,
                                     const void* scales, const void* ids,
                                     void* y, int T, int out, int in_p,
                                     int group, int n_experts, int out_dtype,
                                     void* stream) {
  return w8::launch<sel::Expert>(x, wq, scales, ids, y, T, out, in_p, group,
                                 n_experts, out_dtype, stream);
}
