// K1 w8_matmul on Hopper (sm_90a): y = x @ (scales ⊙ wq)^T.
//
// Replaces vptq_tpu/ops/pallas_gemm.py:_w8_kernel (entry w8_matmul).
// The loops, their design and what bounds them are in w8.cuh; this is
// their entry for one whole weight: T <= 16 runs the Hopper decode GEMV of
// decode_gemv.cuh with the policy w8::W8 (a scale group of whole
// 128-column stages, the loaders' 512 to 2048), or w8.cuh's w8_gemv for
// another group; more tokens the Hopper tile of lowbit_tile.cuh with the
// same policy, or w8_gemm for another group.
//
//   x      (T, in_p)      bf16, row-major
//   wq     (out, in_p)    int8, row-major
//   scales (in_p/group, out) f32
//   y      (T, out)       bf16 / f32

#include "w8.cuh"

// out_dtype: 0 = bf16, 1 = f32. split: the decode GEMV's cluster size at
// T <= 16 (ops/scaled_matmul.py decode_split; 0: w8_gemv). Returns the
// CUDA error code of the launch (0 on success). Requires in_p % group ==
// 0, group % 32 == 0, 16-byte aligned x and wq, all tensors contiguous on
// the current device.
extern "C" int vptq_w8_matmul(const void* x, const void* wq,
                              const void* scales, void* y, int T, int out,
                              int in_p, int group, int split, int out_dtype,
                              void* stream) {
  return w8::launch<sel::Whole>(x, wq, scales, nullptr, y, T, out, in_p,
                                group, 0, out_dtype, stream, split);
}
