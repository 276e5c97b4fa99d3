// Skeleton of the low-bit dequant-matmuls K2 w4_matmul, K3 w2_matmul and
// K4 w3_matmul on Hopper (sm_90a): y = x @ (s ⊙ L)^T, where L holds each
// weight's exact small level (int4 −8…7, int2 c+0.5 ∈ {±0.5, ±1.5}, int3
// two − 4·sign ∈ [−4, 3]) and s one bf16 scale per (row, group of G
// natural columns). Each format is a policy (w4_matmul.cu, w2_matmul.cu,
// w3_matmul.cu) that says how its bytes unpack; this header holds the
// loops. A second policy (expert_select.cuh) says which weight a launch
// reads: the whole one, or, for the MoE kernels K6b w4_matmul_expert and
// K5b w4_matmul_pairs, one expert of a stacked (E, out, ...) weight
// picked by an id the block reads from device memory.
//
// The arithmetic is the TPU kernels': x is rounded to bf16, every level is
// exact in f32 and bf16, the products of one group are summed in f32, the
// group's scale multiplies that f32 partial, and the scaled partials are
// summed in f32. No scale is ever folded into a bf16 weight.
//
// Split layouts. The packed formats keep the columns of one byte far
// apart: a row of in_p columns is P parts of L = in_p / P columns, and
// "position" k ∈ [0, L) of a row holds one field of each part, for the
// natural columns p·L + k, p < P. One 16-byte load per plane therefore
// feeds 16 positions of all P parts, and the kernels index x per part.
// Because L is a multiple of G, a 16-position run lies inside one group of
// each part, and group edges line up across parts.
//
//   x      (T, in_p) bf16, row-major
//   planes kPlanes byte planes; position k of row o of plane i is byte
//          base[i] + o·row_bytes[i] + off[i] + k
//   scales bf16, scale of row o and group g at s[o·row_stride + g·group_stride]
//   ids    int32 in device memory, with a stacked weight: expert e's slab
//          of plane i starts e·out·row_bytes[i] bytes after base[i], its
//          scales e·out·(in_p / G) after s
//   y      (T, out) bf16 / f32
//
// One kernel, gemv (T <= 16; a pairs launch runs it at T = 1 on a grid of
// (row tiles, pairs), row p of x against expert ids[p]): each warp owns
// kRows rows; lane l streams positions 16l … 16l+15 of a 512-position
// chunk with one 16-byte load per plane and row, while x for that chunk
// (all P parts) is staged in shared memory, never x whole (at the down
// shape and T = 16 it is 458 KB). Per part the lane's 16 products are
// summed in f32; the G/16 lanes of one group add their sums with shuffles,
// the first of them multiplies the group's scale in, and the rows' totals
// are summed across the warp at the end. Past 16 tokens K2, K3, K4 and
// K6b take lowbit_tile.cuh's Hopper tile, and most launches up to 16
// decode_gemv.cuh's GEMV; a launch of this header past 16 tokens is
// refused.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "expert_select.cuh"

namespace lowbit {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxPlanes = 3;
constexpr int kChunk = 512;  // gemv positions per block step (32 lanes x 16)

struct Planes {
  const uint8_t* base[kMaxPlanes];
  int row_bytes[kMaxPlanes];
  int off[kMaxPlanes];
};

// ids of a stacked weight: null for sel::Whole
struct Ids {
  const int* ids;
  int n_experts;
};

__device__ __forceinline__ float scale_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float scale_f32(float v) { return v; }

// the scale of row o and group g at s[o·row_stride + g·group_stride]: bf16
// for the low-bit formats (Scales), f32 for int8 (ScalesOf<float>, which
// the prefill tile of lowbit_tile.cuh and the decode GEMV of
// decode_gemv.cuh read; the decode GEMV reads ScalesOf<bf16> in both
// layouts, (groups, out) for int4 and (out, groups) for int3 and int2)
template <typename T>
struct ScalesOf {
  const T* s;
  int row_stride;
  int group_stride;
  __device__ __forceinline__ float at(int o, int g) const {
    return scale_f32(s[(size_t)o * row_stride + (size_t)g * group_stride]);
  }
};
using Scales = ScalesOf<__nv_bfloat16>;

// the scale of part p's group g of row o (every part's scales alike)
template <class P, class S>
__device__ __forceinline__ float scale_of(const S& sc, int o, int g, int) {
  return sc.at(o, g);
}

// f32 with the integer v in its low mantissa bits: 2^23 + v
__device__ __forceinline__ float magic(uint32_t v) {
  return __int_as_float(0x4B000000u | v);
}

__device__ __forceinline__ float bf16_lo(uint32_t p) {
  return __int_as_float(p << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t p) {
  return __int_as_float(p & 0xFFFF0000u);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 8 consecutive values of x
__device__ __forceinline__ uint4 load_x8(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
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

template <class P>
__device__ __forceinline__ void load_planes(uint32_t (&w)[P::kPlanes][4],
                                            const Planes& pl, int row,
                                            int pos, bool ok) {
#pragma unroll
  for (int i = 0; i < P::kPlanes; ++i) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (ok)
      v = __ldg(reinterpret_cast<const uint4*>(
          pl.base[i] + (size_t)row * pl.row_bytes[i] + pl.off[i] + pos));
    w[i][0] = v.x;
    w[i][1] = v.y;
    w[i][2] = v.z;
    w[i][3] = v.w;
  }
  P::prep(w);
}

// Move the planes and scales to the slab of the expert that pair p picks.
template <class P, int G>
__device__ __forceinline__ void select_expert(Planes& pl, Scales& sc,
                                              const Ids& ids, int p, int out,
                                              int in_p) {
  const size_t e = sel::expert_of(ids.ids, ids.n_experts, p);
#pragma unroll
  for (int i = 0; i < P::kPlanes; ++i) pl.base[i] += e * out * pl.row_bytes[i];
  sc.s += e * out * (in_p / G);
}

// --------------------------------------------------------------------
// decode: T <= 16

template <class P, class Sel, int TP, int kRows, int G, typename OutT>
__global__ void __launch_bounds__(kThreads)
    gemv(const __nv_bfloat16* __restrict__ x, Planes pl, Scales sc, Ids ids,
         OutT* __restrict__ y, int T, int out, int in_p, int L) {
  constexpr int kParts = P::kParts;
  constexpr int kSet = G / 16;  // lanes that share one group
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int pair = sel::pair_of<Sel>();
  if (Sel::kIds) select_expert<P, G>(pl, sc, ids, pair, out, in_p);
  if (Sel::kPairs) {
    x += (size_t)pair * in_p;
    y += (size_t)pair * out;
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = (blockIdx.x * kWarps + warp) * kRows;

  bool row_ok[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) row_ok[r] = row0 + r < out;

  float tot[kRows][TP];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int t = 0; t < TP; ++t) tot[r][t] = 0.f;

  constexpr int kVec = kChunk / 8;  // uint4 of bf16 per (token, part)
  for (int c0 = 0; c0 < L; c0 += kChunk) {
    __syncthreads();
    for (int i = threadIdx.x; i < TP * kParts * kVec; i += kThreads) {
      const int c = i % kVec;
      const int tp = i / kVec;
      const int p = tp % kParts;
      const int t = tp / kParts;
      const int pos = c0 + c * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t < T && pos < L)
        v = load_x8(x + (size_t)t * in_p + (size_t)p * L + pos);
      reinterpret_cast<uint4*>(xs)[i] = v;
    }
    __syncthreads();

    const int k = c0 + lane * 16;
    const bool k_ok = k < L;
    uint32_t w[kRows][P::kPlanes][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      load_planes<P>(w[r], pl, row0 + r, k, k_ok && row_ok[r]);

#pragma unroll
    for (int p = 0; p < kParts; ++p) {
      float lv[kRows][16];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < 16; ++j) lv[r][j] = P::level(w[r], p, j);

      float part[kRows][TP];
#pragma unroll
      for (int t = 0; t < TP; ++t) {
        const uint4* xp = reinterpret_cast<const uint4*>(
            xs + ((size_t)t * kParts + p) * kChunk + lane * 16);
        const uint4 xa = xp[0];
        const uint4 xb = xp[1];
        const uint32_t xw[8] = {xa.x, xa.y, xa.z, xa.w,
                                xb.x, xb.y, xb.z, xb.w};
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float acc = 0.f;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            acc += lv[r][2 * q] * bf16_lo(xw[q]);
            acc += lv[r][2 * q + 1] * bf16_hi(xw[q]);
          }
          part[r][t] = acc;
        }
      }

      const int g = (p * L + k) / G;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float s =
            (k_ok && row_ok[r]) ? scale_of<P>(sc, row0 + r, g, p) : 0.f;
#pragma unroll
        for (int t = 0; t < TP; ++t) {
          float v = part[r][t];
#pragma unroll
          for (int off = 1; off < kSet; off <<= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
          if ((lane & (kSet - 1)) == 0) tot[r][t] += v * s;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int t = 0; t < TP; ++t) {
      float v = tot[r][t];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == t && t < T && row_ok[r])
        y[(size_t)t * out + row0 + r] = cvt_out<OutT>(v);
    }
}

// the tensor-core product the Hopper GEMVs of decode_gemv.cuh and
// ring_gemv.cuh take: d += a · b, m16n8k16, bf16 in, f32 out
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// --------------------------------------------------------------------
// launch

// pairs: the grid's second dimension (1 unless the launch is a pairs launch)
template <class P, class Sel, int TP, int G, typename OutT>
cudaError_t launch_gemv(const __nv_bfloat16* x, const Planes& pl,
                        const Scales& sc, const Ids& ids, OutT* y, int T,
                        int pairs, int out, int in_p, int L,
                        cudaStream_t stream) {
  // fewer rows per warp where the 3-plane format and many tokens would
  // spill registers
  constexpr int kRows =
      TP <= 2 ? (P::kPlanes == 1 ? 4 : 2) : (TP <= 8 && P::kPlanes == 1 ? 2 : 1);
  auto kernel = gemv<P, Sel, TP, kRows, G, OutT>;
  const size_t smem =
      (size_t)TP * P::kParts * kChunk * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int rows_per_block = kWarps * kRows;
  dim3 grid((out + rows_per_block - 1) / rows_per_block, pairs);
  kernel<<<grid, kThreads, smem, stream>>>(x, pl, sc, ids, y, T, out, in_p, L);
  return cudaGetLastError();
}

// T <= 16 tokens: the gemv instantiated for the next power of two
template <class P, class Sel, int G, typename OutT>
cudaError_t launch_decode(const __nv_bfloat16* xb, const Planes& pl, const Scales& sc,
                          const Ids& ids, OutT* yo, int T, int out, int in_p,
                          int L, cudaStream_t stream) {
  if (T <= 1) return launch_gemv<P, Sel, 1, G, OutT>(xb, pl, sc, ids, yo, T, 1, out, in_p, L, stream);
  if (T <= 2) return launch_gemv<P, Sel, 2, G, OutT>(xb, pl, sc, ids, yo, T, 1, out, in_p, L, stream);
  if (T <= 4) return launch_gemv<P, Sel, 4, G, OutT>(xb, pl, sc, ids, yo, T, 1, out, in_p, L, stream);
  if (T <= 8) return launch_gemv<P, Sel, 8, G, OutT>(xb, pl, sc, ids, yo, T, 1, out, in_p, L, stream);
  return launch_gemv<P, Sel, 16, G, OutT>(xb, pl, sc, ids, yo, T, 1, out, in_p, L, stream);
}

template <class P, class Sel, int G, typename OutT>
cudaError_t launch_typed(const void* x, const Planes& pl, const Scales& sc,
                         const Ids& ids, void* y, int T, int out, int in_p,
                         cudaStream_t stream) {
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* yo = static_cast<OutT*>(y);
  const int L = in_p / P::kParts;
  if (L % G || L % 16) return cudaErrorInvalidValue;
  if constexpr (Sel::kPairs) {
    // T pairs, each one row of x through its own expert
    if (T > 65535) return cudaErrorInvalidValue;
    return launch_gemv<P, Sel, 1, G, OutT>(xb, pl, sc, ids, yo, 1, T, out, in_p, L, stream);
  } else {
    if (T > 16) return cudaErrorInvalidValue;
    return launch_decode<P, Sel, G, OutT>(xb, pl, sc, ids, yo, T, out, in_p, L, stream);
  }
}

// f(OutT* null) for out_dtype 0 = bf16, 1 = f32: the output type of a
// launch, as a CUDA error code
template <class F>
int with_out_type(int out_dtype, F&& f) {
  switch (out_dtype) {
    case 0:
      return (int)f(static_cast<__nv_bfloat16*>(nullptr));
    case 1:
      return (int)f(static_cast<float*>(nullptr));
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// out_dtype: 0 = bf16, 1 = f32; x bf16
template <class P, int G, class Sel = sel::Whole>
int launch(const void* x, const Planes& pl, const Scales& sc, void* y, int T,
           int out, int in_p, int out_dtype, void* stream,
           const Ids& ids = Ids{nullptr, 0}) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_out_type(out_dtype, [&](auto* tag) {
    using OutT = std::remove_pointer_t<decltype(tag)>;
    return launch_typed<P, Sel, G, OutT>(x, pl, sc, ids, y, T, out, in_p, s);
  });
}

}  // namespace lowbit
