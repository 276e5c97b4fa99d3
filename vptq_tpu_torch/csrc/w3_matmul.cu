// K4 w3_matmul on Hopper (sm_90a): y = x @ (unpack_int3(wq2, wq1) ⊙ s)^T.
//
// Replaces vptq_tpu/ops/pallas_gemm.py:_w3_kernel (entry w3_matmul).
//
//   x      (T, in_p)          bf16
//   wq2    (out, in_p / 4)    int8: bits 2q..2q+1 of byte k hold the low
//                             two bits of column q·in_p/4 + k
//   wq1    (out, in_p / 8)    int8: bit m of byte k holds the sign bit of
//                             column m·in_p/8 + k (ops/packing.py pack_int3)
//   scales (out, in_p / 128)  bf16
//   y      (T, out)           bf16 / f32
//
// What bounds it on an H100: at decode the weight bytes, 3/8 byte per
// weight plus 1/64 byte of scale (85.2 MB per Llama-3.1-8B layer,
// 0.025 ms at 3.35 TB/s); at T = 512 the bf16 tensor-core FLOPs
// (0.226 ms per layer at 989 TFLOP/s).
//
// Design: the skeleton in lowbit.cuh with eight parts (octants) of
// L = in_p/8 columns. Position k reads three 16-byte runs: wq2 at k
// (quarters = even octants 0, 2, 4, 6), wq2 at k + L (odd octants) and
// wq1 at k (the eight sign bits), so every byte is read once. The level
// two − 4·sign is built as the 3-bit offset code two | (!sign << 2) in the
// mantissa of 2^23, minus 2^23 + 4: exact, with no conversion
// instruction. The TPU kernel split the value into two families of
// sub-dots (two against the quarter, −sign against the octant with 4·s)
// for its vector unit; here one exact level per weight computes the
// same function up to summation order.

#include "lowbit.cuh"

namespace {

// The name W3 tags this format's kernels in a profiler trace
// (w3_matmul.trace_tags).
struct W3 {
  static constexpr int kPlanes = 3;  // wq2 at k, wq2 at k + L, wq1 at k
  static constexpr int kParts = 8;
  __device__ static void prep(uint32_t (&w)[3][4]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) w[2][q] = ~w[2][q];  // sign -> !sign
  }
  // level of octant p at byte j of the 16
  __device__ static float level(const uint32_t (&w)[3][4], int p, int j) {
    const int sh = 8 * (j & 3);
    const uint32_t two = (w[p & 1][j >> 2] >> (sh + 2 * (p >> 1))) & 0x3u;
    const uint32_t ns = (w[2][j >> 2] >> (sh + p)) & 0x1u;
    return lowbit::magic(two | (ns << 2)) - 8388612.0f;  // 2^23 + 4
  }
};

}  // namespace

// Returns the CUDA error of the launch (0 on success). Requires
// in_p % 1024 == 0, 16-byte aligned x, wq2 and wq1, all tensors
// contiguous on the current device.
extern "C" int vptq_w3_matmul(const void* x, const void* wq2,
                              const void* wq1, const void* scales, void* y,
                              int T, int out, int in_p, int out_dtype,
                              void* stream) {
  const int L = in_p / 8;
  const auto* w2 = static_cast<const uint8_t*>(wq2);
  const auto* w1 = static_cast<const uint8_t*>(wq1);
  lowbit::Planes pl = {{w2, w2, w1}, {2 * L, 2 * L, L}, {0, L, 0}};
  lowbit::Scales sc = {static_cast<const __nv_bfloat16*>(scales),
                       in_p / 128, 1};
  return lowbit::launch<W3, 128>(x, pl, sc, y, T, out, in_p, out_dtype,
                                 stream);
}
