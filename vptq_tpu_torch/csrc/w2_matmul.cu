// K3 w2_matmul on Hopper (sm_90a): y = x @ ((unpack_int2(wq) + 0.5) ⊙ s)^T.
//
// Replaces vptq_tpu/ops/pallas_gemm.py:_w2_kernel (entry w2_matmul).
//
//   x      (T, in_p)          bf16
//   wq     (out, in_p / 4)    int8: bits 2q..2q+1 of byte k hold the
//                             two's-complement code c ∈ [−2, 1] of column
//                             q·in_p/4 + k (ops/packing.py pack_int2)
//   scales (out, in_p / G)    bf16, G = 64 or 128
//   y      (T, out)           bf16 / f32
//
// What bounds it on an H100: at decode the weight bytes, a quarter byte
// per weight plus 1/32 byte of scale at G = 64 (61.3 MB per
// Llama-3.1-8B layer, 0.018 ms at 3.35 TB/s); at T = 512 the bf16
// tensor-core FLOPs (0.226 ms per layer at 989 TFLOP/s).
//
// Design: the skeleton in lowbit.cuh with four parts of in_p/4 columns.
// The level c + 0.5 is built exactly per weight: flipping the high bit
// of every 2-bit field maps c to c + 2 ∈ [0, 3], which is shifted into
// the mantissa of 2^22 (half-unit steps) and 2^22 + 1.5 subtracted. The
// TPU kernel instead ran the integer codes through the MXU and added
// 0.5·s·Σx per group from precomputed group sums of x; on Hopper the
// exact half-integer level costs nothing extra, and the result is the
// same function up to summation order. Scales change every 64 columns
// at G = 64: the gemv reduces over 4-lane sets, the gemm applies the
// scale every 2 slabs.

#include "lowbit.cuh"

namespace {

// The name W2 tags this format's kernels in a profiler trace
// (w2_matmul.trace_tags).
struct W2 {
  static constexpr int kPlanes = 1;
  static constexpr int kParts = 4;
  __device__ static void prep(uint32_t (&w)[1][4]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) w[0][q] ^= 0xAAAAAAAAu;  // c -> c + 2
  }
  // level of quarter p at byte j of the 16: c + 0.5
  __device__ static float level(const uint32_t (&w)[1][4], int p, int j) {
    const uint32_t v = (w[0][j >> 2] >> (8 * (j & 3) + 2 * p)) & 0x3u;
    return __int_as_float(0x4A800000u | (v << 1)) - 4194305.5f;
  }
};

}  // namespace

// Returns the CUDA error of the launch (0 on success). Requires group 64
// or 128, in_p % (4·group) == 0, 16-byte aligned x and wq, all tensors
// contiguous on the current device.
extern "C" int vptq_w2_matmul(const void* x, const void* wq,
                              const void* scales, void* y, int T, int out,
                              int in_p, int group, int out_dtype,
                              void* stream) {
  const int L = in_p / 4;
  const auto* w = static_cast<const uint8_t*>(wq);
  lowbit::Planes pl = {{w, nullptr, nullptr}, {L, 0, 0}, {0, 0, 0}};
  lowbit::Scales sc = {static_cast<const __nv_bfloat16*>(scales),
                       in_p / group, 1};
  if (group == 64)
    return lowbit::launch<W2, 64>(x, pl, sc, y, T, out, in_p, out_dtype,
                                  stream);
  if (group == 128)
    return lowbit::launch<W2, 128>(x, pl, sc, y, T, out, in_p, out_dtype,
                                   stream);
  return (int)cudaErrorInvalidValue;
}
