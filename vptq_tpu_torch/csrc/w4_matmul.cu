// K2 w4_matmul on Hopper (sm_90a): y = x @ (scales^T ⊙ unpack_int4(wq))^T.
//
// Replaces vptq_tpu/ops/pallas_gemm.py:_w4_kernel (entry w4_matmul).
//
//   x      (T, in_p)        bf16
//   wq     (out, in_p / 2)  int8: byte k holds column k in its low nibble
//                           and column in_p/2 + k in its high nibble,
//                           both signed (ops/packing.py pack_int4)
//   scales (in_p / 128, out) bf16, one per (128-column group, row)
//   y      (T, out)         bf16 / f32
//
// What bounds it on an H100: at decode the weight bytes, half a byte per
// weight plus 1/64 byte of scale (112.5 MB per Llama-3.1-8B layer,
// 0.034 ms at 3.35 TB/s); at T = 512 the bf16 tensor-core FLOPs
// (2·T·out·in_p, 0.226 ms per layer at 989 TFLOP/s).
//
// Design: the skeleton in lowbit.cuh with two parts of in_p/2 columns.
// A nibble becomes its exact f32 level with one shift-and-mask into the
// mantissa of 2^23 (after flipping the sign bits of all eight nibbles of
// a word at once) and one subtract, so unpacking costs no conversion
// instruction. The TPU kernel's trick of folding 2^-28 into the low-half
// scales (one shift per low nibble on its vector unit) is not needed.

#include "lowbit.cuh"

namespace {

// The name W4 tags this format's kernels in a profiler trace
// (w4_matmul.trace_tags).
struct W4 {
  static constexpr int kPlanes = 1;
  static constexpr int kParts = 2;
  __device__ static void prep(uint32_t (&w)[1][4]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) w[0][q] ^= 0x88888888u;  // n -> n + 8
  }
  // level of part p (0: low nibble, 1: high) at byte j of the 16
  __device__ static float level(const uint32_t (&w)[1][4], int p, int j) {
    const uint32_t v = (w[0][j >> 2] >> (8 * (j & 3) + 4 * p)) & 0xFu;
    return lowbit::magic(v) - 8388616.0f;  // 2^23 + 8
  }
};

}  // namespace

// Returns the CUDA error of the launch (0 on success). Requires
// in_p % 256 == 0, 16-byte aligned x and wq, all tensors contiguous on
// the current device.
extern "C" int vptq_w4_matmul(const void* x, const void* wq,
                              const void* scales, void* y, int T, int out,
                              int in_p, int out_dtype, void* stream) {
  const int L = in_p / 2;
  const auto* w = static_cast<const uint8_t*>(wq);
  lowbit::Planes pl = {{w, nullptr, nullptr}, {L, 0, 0}, {0, 0, 0}};
  lowbit::Scales sc = {static_cast<const __nv_bfloat16*>(scales), 1, out};
  return lowbit::launch<W4, 128>(x, pl, sc, y, T, out, in_p, out_dtype,
                                 stream);
}
