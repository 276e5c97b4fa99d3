// The int4 throughput probes P1d (s8dot) and P1e (cvtonly) on Hopper
// (sm_90a): the packed bytes used as they lie, wrong on purpose, to see
// what a GEMV over them costs without any unpack.
//
// Replaces examples/w4_wall_candidates.py:_s8dot_kernel and
// _cvtonly_kernel (entry run_variant, modes "s8dot" and "cvtonly").
//
//   x      (T, n)          s8dot: int8; cvtonly: bf16. n = in / 2: the
//                          callers pass columns [0, in/2) of the
//                          activations
//   wq     (out, n)        int8, the packed bytes
//   scales (in / 128, out) bf16; only row 0 is read
//   y      (T, out)        bf16 / f32
//
//   s8dot    y[t, o] = f32(Σ_k x[t, k] · wq[o, k], exact in int32)
//                      · scales[0, o]
//   cvtonly  y[t, o] = (Σ_k x[t, k] · f32(wq[o, k]), in f32) · scales[0, o]
//
// What bounds it on an H100: the weight bytes (one byte per two columns,
// as K2). Design (probe_gemv.cuh's frame): each lane takes 16 bytes of a
// row at a time; s8dot sums them with four __dp4a (the integer path, four
// int8 products a instruction, no conversion), cvtonly converts each byte
// to f32 once and multiplies it in: the no-bit-logic ceiling of an unpack.

#include "probe_gemv.cuh"

namespace raw_probe {

template <bool kS8, int TP, int kRows, typename OutT>
__global__ void __launch_bounds__(probe::kThreads)
    raw_gemv(const void* __restrict__ xv, const uint8_t* __restrict__ w,
             const __nv_bfloat16* __restrict__ s, OutT* __restrict__ y,
             int T, int out, int n) {
  using Acc = typename std::conditional<kS8, int, float>::type;
  const int lane = threadIdx.x & 31;
  int row0, t0;
  probe::origin<kRows, TP>(row0, t0);

  Acc tot[kRows][TP];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int t = 0; t < TP; ++t) tot[r][t] = 0;

  for (int k = lane * 16; k < n; k += 32 * 16) {
    uint4 wv[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      wv[r] = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < out)
        wv[r] = __ldg(reinterpret_cast<const uint4*>(
            w + (size_t)(row0 + r) * n + k));
    }
#pragma unroll
    for (int t = 0; t < TP; ++t) {
      const bool t_ok = t0 + t < T;
      if constexpr (kS8) {
        const auto* x = static_cast<const int8_t*>(xv);
        uint4 a = make_uint4(0u, 0u, 0u, 0u);
        if (t_ok)
          a = __ldg(reinterpret_cast<const uint4*>(
              x + (size_t)(t0 + t) * n + k));
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            tot[r][t] = __dp4a((int)probe::word(a, i),
                               (int)probe::word(wv[r], i), tot[r][t]);
      } else {
        const auto* x = static_cast<const __nv_bfloat16*>(xv);
        uint4 a = make_uint4(0u, 0u, 0u, 0u), b = a;
        if (t_ok) {
          const auto* p = reinterpret_cast<const uint4*>(
              x + (size_t)(t0 + t) * n + k);
          a = __ldg(p);
          b = __ldg(p + 1);
        }
        float xf[16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          xf[2 * i] = probe::bf16_lo(probe::word(a, i));
          xf[2 * i + 1] = probe::bf16_hi(probe::word(a, i));
          xf[8 + 2 * i] = probe::bf16_lo(probe::word(b, i));
          xf[8 + 2 * i + 1] = probe::bf16_hi(probe::word(b, i));
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int j = 0; j < 16; ++j)
            tot[r][t] +=
                (float)probe::sbyte(probe::word(wv[r], j >> 2), j & 3) * xf[j];
      }
    }
  }
  probe::store<kRows, TP>(tot, y, row0, t0, T, out, [&](int r, Acc v) {
    return (float)v * __bfloat162float(s[row0 + r]);
  });
}

template <bool kS8, typename OutT>
struct Launch {
  template <int TP>
  struct At {
    static cudaError_t run(int T, const void* x, const uint8_t* w,
                           const __nv_bfloat16* s, OutT* y, int out, int n,
                           cudaStream_t stream) {
      constexpr int kRows = TP <= 2 ? 4 : 2;
      raw_gemv<kS8, TP, kRows, OutT>
          <<<probe::grid<kRows, TP>(out, T), probe::kThreads, 0, stream>>>(
              x, w, s, y, T, out, n);
      return cudaGetLastError();
    }
  };
};

template <bool kS8>
int launch(const void* x, const void* wq, const void* scales, void* y, int T,
           int out, int n, int out_dtype, cudaStream_t stream) {
  const auto* w = static_cast<const uint8_t*>(wq);
  const auto* s = static_cast<const __nv_bfloat16*>(scales);
  switch (out_dtype) {
    case 0:
      return (int)probe::by_tokens<Launch<kS8, __nv_bfloat16>::template At>(
          T, x, w, s, static_cast<__nv_bfloat16*>(y), out, n, stream);
    case 1:
      return (int)probe::by_tokens<Launch<kS8, float>::template At>(
          T, x, w, s, static_cast<float*>(y), out, n, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace raw_probe

// Returns the CUDA error of the launch (0 on success). n: bytes per row of
// wq and values per row of x, a multiple of 16; 16-byte aligned x and wq,
// all tensors contiguous on the current device; mode 0 = s8dot (x int8),
// 1 = cvtonly (x bf16); out_dtype 0 = bf16, 1 = f32.
extern "C" int vptq_w4_raw_probe(const void* x, const void* wq,
                                 const void* scales, void* y, int T, int out,
                                 int n, int mode, int out_dtype,
                                 void* stream) {
  if (n % 16) return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return raw_probe::launch<true>(x, wq, scales, y, T, out, n, out_dtype,
                                     st);
    case 1:
      return raw_probe::launch<false>(x, wq, scales, y, T, out, n, out_dtype,
                                      st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
