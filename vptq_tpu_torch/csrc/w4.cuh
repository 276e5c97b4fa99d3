// The int4 format of the low-bit skeleton (lowbit.cuh), of the prefill
// tile (lowbit_tile.cuh) and of the decode GEMV (decode_gemv.cuh), and its
// launch, shared by K2 w4_matmul (w4_matmul.cu), K6b
// w4_matmul_expert (w4_matmul_expert.cu) and K5b w4_matmul_pairs
// (w4_matmul_pairs.cu).
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

#include "decode_gemv.cuh"
#include "lowbit_tile.cuh"

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
  // the prefill tile (lowbit_tile.cuh): both parts read the one plane;
  // t holds the bytes of two positions in bits 0-7 and 16-23, and part
  // p's pair is 128 + (nibble ^ 8) in each bf16 half, so that subtracting
  // 136 leaves the signed nibble
  static constexpr int kTileSlots = 1;
  static constexpr uint32_t kTileBias = 0x43084308u;  // bf16 (136, 136)
  __device__ static int tile_plane(int, int) { return 0; }
  __device__ static uint32_t tile_code(const uint32_t (&t)[1], int p) {
    return ((t[0] >> (4 * p)) & 0x000F000Fu) ^ 0x43084308u;
  }
};

// the one plane and the scales of a weight of in_p columns and out rows
inline lowbit::Planes planes(const void* wq, int in_p) {
  const auto* w = static_cast<const uint8_t*>(wq);
  return {{w, nullptr, nullptr}, {in_p / 2, 0, 0}, {0, 0, 0}};
}

inline lowbit::Scales scales_of(const void* scales, int out) {
  return {static_cast<const __nv_bfloat16*>(scales), 1, out};
}

// Returns the CUDA error of the launch (0 on success). Requires
// in_p % 256 == 0, 16-byte aligned x and wq, all tensors contiguous on
// the current device; with ids, n_experts slabs in wq and scales. The
// whole weight (K2) up to 16 tokens and the T pairs (K5b) of one token
// each run the Hopper decode GEMV of decode_gemv.cuh (split: its cluster
// size, ops/scaled_matmul.py decode_split, which counts the pairs' blocks;
// 0: lowbit::gemv, pairs at T = 1); one expert (K6b) runs lowbit::gemv;
// the whole weight and one expert run the Hopper tile of lowbit_tile.cuh
// past 16 tokens.
template <class Sel>
int launch(const void* x, const void* wq, const void* scales, const void* ids,
           void* y, int T, int out, int in_p, int n_experts, int out_dtype,
           void* stream, int split = 0) {
  const lowbit::Ids sel_ids = {static_cast<const int*>(ids), n_experts};
  if constexpr (std::is_same_v<Sel, sel::Whole>)
    if (T <= lowbit::tile::kDecodeMax && split > 0)
      return lowbit::with_out_type(out_dtype, [&](auto* tag) {
        using OutT = std::remove_pointer_t<decltype(tag)>;
        return dgemv::launch<W4, Sel>(
            static_cast<const __nv_bfloat16*>(x), planes(wq, in_p),
            scales_of(scales, out), static_cast<OutT*>(y), T, out, in_p / 2,
            1, split, static_cast<cudaStream_t>(stream));
      });
  if constexpr (Sel::kPairs) {
    if (split > 0)
      return lowbit::with_out_type(out_dtype, [&](auto* tag) {
        using OutT = std::remove_pointer_t<decltype(tag)>;
        return dgemv::launch<W4, Sel>(
            static_cast<const __nv_bfloat16*>(x), planes(wq, in_p),
            scales_of(scales, out), static_cast<OutT*>(y), 1, out, in_p / 2,
            1, split, static_cast<cudaStream_t>(stream), sel_ids, T);
      });
    return lowbit::launch<W4, 128, Sel>(x, planes(wq, in_p),
                                        scales_of(scales, out), y, T, out,
                                        in_p, out_dtype, stream, sel_ids);
  } else
    return lowbit::tile::launch<W4, 128, Sel>(
        x, planes(wq, in_p), scales_of(scales, out), y, T, out, in_p,
        out_dtype, stream, sel_ids);
}

}  // namespace w4
