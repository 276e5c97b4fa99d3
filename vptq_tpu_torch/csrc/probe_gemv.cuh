// The frame of the raw probe GEMVs P1d / P1e w4_raw_probe.cu (P1c and P3
// run on ring_gemv.cuh's asynchronous ring).
//
// A block is 8 warps; each warp owns kRows rows of y for a tile of TP
// tokens, and its lanes stream each row with 16-byte loads, 32 lanes side
// by side. The grid is (row blocks, token tiles): a launch takes any T,
// and a token tile past the first reads the weights again (from L2). At
// the end each (row, token) total is summed across the warp and lane t
// writes token t.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace probe {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float bf16_lo(uint32_t p) {
  return __int_as_float(p << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t p) {
  return __int_as_float(p & 0xFFFF0000u);
}

// byte j of a word, sign-extended
__device__ __forceinline__ int sbyte(uint32_t w, int j) {
  return (int)(w << (24 - 8 * j)) >> 24;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <typename A>
__device__ __forceinline__ A warp_sum(A v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename OutT>
__device__ __forceinline__ OutT cvt_out(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 cvt_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float cvt_out<float>(float v) {
  return v;
}

// The first row of this warp and the first token of this block's tile.
template <int kRows, int TP>
__device__ __forceinline__ void origin(int& row0, int& t0) {
  row0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows;
  t0 = blockIdx.y * TP;
}

// y[t0 + t, row0 + r] = finish(r, warp sum of tot[r][t]), by lane t.
template <int kRows, int TP, typename A, typename OutT, typename F>
__device__ __forceinline__ void store(A (&tot)[kRows][TP], OutT* y, int row0,
                                      int t0, int T, int out, F finish) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int t = 0; t < TP; ++t) {
      const A v = warp_sum(tot[r][t]);
      if (lane == t && t0 + t < T && row0 + r < out)
        y[(size_t)(t0 + t) * out + row0 + r] = cvt_out<OutT>(finish(r, v));
    }
}

template <int kRows, int TP>
dim3 grid(int out, int T) {
  return dim3((out + kWarps * kRows - 1) / (kWarps * kRows),
              (T + TP - 1) / TP);
}

// Launch K<TP> with TP the smallest of 1, 2, 4, 8 that holds T, or 8 and
// as many token tiles as T needs.
template <template <int> class K, typename... Args>
cudaError_t by_tokens(int T, Args... args) {
  if (T <= 1) return K<1>::run(T, args...);
  if (T <= 2) return K<2>::run(T, args...);
  if (T <= 4) return K<4>::run(T, args...);
  return K<8>::run(T, args...);
}

}  // namespace probe
