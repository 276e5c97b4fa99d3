// The int4 format of the low-bit skeleton (lowbit.cuh), shared by K2
// w4_matmul (w4_matmul.cu), K6b w4_matmul_expert (w4_matmul_expert.cu)
// and K5b w4_matmul_pairs (w4_matmul_pairs.cu).
//
//   wq     (out, in_p / 2)  int8: byte k holds column k in its low nibble
//                           and column in_p/2 + k in its high nibble,
//                           both signed (ops/packing.py pack_int4);
//                           (E, out, in_p / 2) when stacked
//   scales (in_p / 128, out) bf16, one per (128-column group, row);
//                           (E, in_p / 128, out) when stacked
//
// Two parts of in_p/2 columns. A nibble becomes its exact f32 level with
// one shift-and-mask into the mantissa of 2^23 (after flipping the sign
// bits of all eight nibbles of a word at once) and one subtract, so
// unpacking needs no integer-to-float conversion. The TPU kernels' trick of
// folding 2^-28 into the low-half scales (one shift per low nibble on
// their vector unit) is not needed; the result equals the plain unpack.

#pragma once

#include "lowbit.cuh"

namespace w4 {

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

// Returns the CUDA error of the launch (0 on success). Requires
// in_p % 256 == 0, 16-byte aligned x and wq, all tensors contiguous on
// the current device; with ids, n_experts slabs in wq and scales.
template <class Sel>
int launch(const void* x, const void* wq, const void* scales, const void* ids,
           void* y, int T, int out, int in_p, int n_experts, int out_dtype,
           void* stream) {
  const int L = in_p / 2;
  const auto* w = static_cast<const uint8_t*>(wq);
  lowbit::Planes pl = {{w, nullptr, nullptr}, {L, 0, 0}, {0, 0, 0}};
  lowbit::Scales sc = {static_cast<const __nv_bfloat16*>(scales), 1, out};
  lowbit::Ids sel_ids = {static_cast<const int*>(ids), n_experts};
  return lowbit::launch<W4, 128, Sel>(x, pl, sc, y, T, out, in_p, out_dtype,
                                      stream, sel_ids);
}

}  // namespace w4
