// The int4 unpack probe P1c on Hopper (sm_90a): eight unsigned nibble
// planes per int32 word.
//
// Replaces examples/w4_wall_candidates.py:_i32x8_kernel (entry run_variant,
// mode "i32x8").
//
//   x      (T, in)         bf16
//   wq     (out, in / 8)   int32; word m of a row lies in superblock
//                          m / 128 of 1024 natural columns, and its bits
//                          4p … 4p+3 hold the level of natural column
//                          1024·(m / 128) + 128·p + m % 128, as 0 … 15
//                          (no +8 correction: a probe of the unpack)
//   scales (in / 128, out) bf16, one per (128-column group, row); plane p
//                          of superblock u is group 8u + p
//   y      (T, out)        bf16 / f32
//
// y[t, o] = Σ_c x[t, c] · level(o, c) · scales[c / 128, o], x rounded to
// bf16, products summed in f32.
//
// What bounds it on an H100: at decode the weight bytes (half a byte per
// weight, as K2). Design (probe_gemv.cuh's frame): one 16-byte load gives a
// lane 4 words, i.e. 4 columns of each of the 8 planes; a warp's 32 lanes
// cover one superblock of one row. A plane is one shift, one mask and one
// integer-to-float convert per nibble; each lane multiplies its 4-column
// partial of a plane by the plane's scale, so no shuffle runs before the
// end. A lop3 / prmt magic-number unpack straight into bf16 pairs is the
// Hopper idiom to try next.

#include "probe_gemv.cuh"

namespace i32x8 {

template <int TP, int kRows, typename OutT>
__global__ void __launch_bounds__(probe::kThreads)
    i32x8_gemv(const __nv_bfloat16* __restrict__ x,
               const uint32_t* __restrict__ w,
               const __nv_bfloat16* __restrict__ s, OutT* __restrict__ y,
               int T, int out, int in) {
  const int lane = threadIdx.x & 31;
  int row0, t0;
  probe::origin<kRows, TP>(row0, t0);
  const int words = in / 8;

  float tot[kRows][TP];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int t = 0; t < TP; ++t) tot[r][t] = 0.f;

  for (int sup = 0; sup < in / 1024; ++sup) {
    uint4 wv[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      wv[r] = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < out)
        wv[r] = __ldg(reinterpret_cast<const uint4*>(
            w + (size_t)(row0 + r) * words + sup * 128 + lane * 4));
    }
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int col = sup * 1024 + p * 128 + lane * 4;
      float xv[TP][4];
#pragma unroll
      for (int t = 0; t < TP; ++t) {
        uint2 u = make_uint2(0u, 0u);
        if (t0 + t < T)
          u = __ldg(reinterpret_cast<const uint2*>(
              x + (size_t)(t0 + t) * in + col));
        xv[t][0] = probe::bf16_lo(u.x);
        xv[t][1] = probe::bf16_hi(u.x);
        xv[t][2] = probe::bf16_lo(u.y);
        xv[t][3] = probe::bf16_hi(u.y);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float sr =
            row0 + r < out
                ? __bfloat162float(
                      s[(size_t)(sup * 8 + p) * out + row0 + r])
                : 0.f;
        float lv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          lv[i] = (float)((probe::word(wv[r], i) >> (4 * p)) & 15u);
#pragma unroll
        for (int t = 0; t < TP; ++t) {
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) part += lv[i] * xv[t][i];
          tot[r][t] += part * sr;
        }
      }
    }
  }
  probe::store<kRows, TP>(tot, y, row0, t0, T, out,
                          [](int, float v) { return v; });
}

template <typename OutT>
struct Launch {
  template <int TP>
  struct At {
    static cudaError_t run(int T, const __nv_bfloat16* x, const uint32_t* w,
                           const __nv_bfloat16* s, OutT* y, int out, int in,
                           cudaStream_t stream) {
      constexpr int kRows = TP <= 2 ? 4 : 2;
      i32x8_gemv<TP, kRows, OutT>
          <<<probe::grid<kRows, TP>(out, T), probe::kThreads, 0, stream>>>(
              x, w, s, y, T, out, in);
      return cudaGetLastError();
    }
  };
};

}  // namespace i32x8

// Returns the CUDA error of the launch (0 on success). Requires
// in % 1024 == 0, 16-byte aligned x and wq, all tensors contiguous on the
// current device; out_dtype 0 = bf16, 1 = f32.
extern "C" int vptq_w4_i32x8_matmul(const void* x, const void* wq,
                                    const void* scales, void* y, int T,
                                    int out, int in, int out_dtype,
                                    void* stream) {
  if (in % 1024) return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* w = static_cast<const uint32_t*>(wq);
  const auto* s = static_cast<const __nv_bfloat16*>(scales);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0:
      return (int)probe::by_tokens<i32x8::Launch<__nv_bfloat16>::At>(
          T, xb, w, s, static_cast<__nv_bfloat16*>(y), out, in, st);
    case 1:
      return (int)probe::by_tokens<i32x8::Launch<float>::At>(
          T, xb, w, s, static_cast<float*>(y), out, in, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
