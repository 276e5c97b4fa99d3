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
// Two kernels, picked by T:
//  * gemv (T <= 16; a pairs launch runs it at T = 1 on a grid of (row
//    tiles, pairs), row p of x against expert ids[p]): each warp owns kRows rows; lane l streams positions
//    16l … 16l+15 of a 512-position chunk with one 16-byte load per plane
//    and row, while x for that chunk (all P parts) is staged in shared
//    memory, never x whole (at the down shape and T = 16 it is 458 KB).
//    Per part the lane's 16 products are summed in f32; the G/16 lanes of
//    one group add their sums with shuffles, the first of them multiplies
//    the group's scale in, and the rows' totals are summed across the warp
//    at the end.
//  * gemm (T > 16): 64 x 128 output tiles, 8 warps, bf16 mma.sync
//    m16n8k16 with f32 accumulators (K1's tile). A block walks positions
//    one group (G) at a time: each thread loads its 16 bytes of each plane
//    for the group's G/32 slabs into registers once, then for each part
//    unpacks them into exact bf16 levels in shared memory beside the x
//    slab of that part and runs the MMAs; at the part's group edge the
//    accumulators are scaled per column and added to the totals.
// wgmma / TMA pipelining is later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

struct Scales {
  const __nv_bfloat16* s;
  int row_stride;
  int group_stride;
  __device__ __forceinline__ float at(int o, int g) const {
    return __bfloat162float(s[(size_t)o * row_stride + (size_t)g * group_stride]);
  }
};

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
        v = *reinterpret_cast<const uint4*>(x + (size_t)t * in_p +
                                            (size_t)p * L + pos);
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
        const float s = (k_ok && row_ok[r]) ? sc.at(row0 + r, g) : 0.f;
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

// --------------------------------------------------------------------
// prefill: T > 16

constexpr int BM = 64;       // tokens per block tile
constexpr int BN = 128;      // output rows per block tile
constexpr int BK = 32;       // positions (columns of one part) per slab
constexpr int LDS = BK + 8;  // padded smem row (bf16): conflict-free frags

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <class P, class Sel, int G, typename OutT>
__global__ void __launch_bounds__(kThreads)
    gemm(const __nv_bfloat16* __restrict__ x, Planes pl, Scales sc, Ids ids,
         OutT* __restrict__ y, int T, int out, int in_p, int L) {
  static_assert(!Sel::kPairs, "a pairs launch runs the T = 1 gemv");
  constexpr int kParts = P::kParts;
  constexpr int kSlabs = G / BK;  // slabs per group
  __shared__ __align__(16) __nv_bfloat16 xs[BM][LDS];
  __shared__ __align__(16) __nv_bfloat16 ws[BN][LDS];
  if (Sel::kIds) select_expert<P, G>(pl, sc, ids, 0, out, in_p);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // 2 warps along tokens (32 each)
  const int wn = warp & 3;   // 4 warps along out rows (32 each)
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // x staging: one 16 B load per thread per slab; w: 16 positions of one
  // row per thread per slab
  const int xr = tid >> 2, xc = (tid & 3) * 8;
  const int wr = tid >> 1, wc = (tid & 1) * 16;
  const bool x_ok = m0 + xr < T;
  const bool w_ok = n0 + wr < out;
  const __nv_bfloat16* xp = x + (size_t)(x_ok ? m0 + xr : 0) * in_p + xc;

  float acc[2][4][4];
  float tot[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = tot[i][j][e] = 0.f;

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  // slabs run group by group, part by part within a group, slab by slab
  // within a part; x column of slab (gpos, p, s) is p*L + gpos + s*BK
  uint4 xreg = x_ok ? *reinterpret_cast<const uint4*>(xp) : zero;

  for (int gpos = 0; gpos < L; gpos += G) {
    uint32_t w[kSlabs][P::kPlanes][4];
#pragma unroll
    for (int s = 0; s < kSlabs; ++s)
      load_planes<P>(w[s], pl, n0 + wr, gpos + s * BK + wc, w_ok);

#pragma unroll
    for (int p = 0; p < kParts; ++p) {
#pragma unroll
      for (int s = 0; s < kSlabs; ++s) {
        *reinterpret_cast<uint4*>(&xs[xr][xc]) = xreg;
        {
          uint32_t h[8];
#pragma unroll
          for (int q = 0; q < 8; ++q)
            h[q] = pack_bf16x2(P::level(w[s], p, 2 * q),
                               P::level(w[s], p, 2 * q + 1));
          *reinterpret_cast<uint4*>(&ws[wr][wc]) =
              make_uint4(h[0], h[1], h[2], h[3]);
          *reinterpret_cast<uint4*>(&ws[wr][wc + 8]) =
              make_uint4(h[4], h[5], h[6], h[7]);
        }
        __syncthreads();
        {
          // prefetch the next slab's x
          int next = -1;
          if (s + 1 < kSlabs)
            next = p * L + gpos + (s + 1) * BK;
          else if (p + 1 < kParts)
            next = (p + 1) * L + gpos;
          else if (gpos + G < L)
            next = gpos + G;
          if (next >= 0 && x_ok)
            xreg = *reinterpret_cast<const uint4*>(xp + next);
        }
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          uint32_t a[2][4];
          uint32_t b[4][2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = wm * 32 + i * 16 + gid;
            a[i][0] = lds32(&xs[r][kk + tig * 2]);
            a[i][1] = lds32(&xs[r + 8][kk + tig * 2]);
            a[i][2] = lds32(&xs[r][kk + tig * 2 + 8]);
            a[i][3] = lds32(&xs[r + 8][kk + tig * 2 + 8]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = wn * 32 + j * 8 + gid;
            b[j][0] = lds32(&ws[n][kk + tig * 2]);
            b[j][1] = lds32(&ws[n][kk + tig * 2 + 8]);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
        }
        __syncthreads();
      }

      // group edge of part p: scale each column's f32 partial
      const int g = (p * L + gpos) / G;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn * 32 + j * 8 + tig * 2;
        const float s0 = col < out ? sc.at(col, g) : 0.f;
        const float s1 = col + 1 < out ? sc.at(col + 1, g) : 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          tot[i][j][0] += acc[i][j][0] * s0;
          tot[i][j][1] += acc[i][j][1] * s1;
          tot[i][j][2] += acc[i][j][2] * s0;
          tot[i][j][3] += acc[i][j][3] * s1;
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + wm * 32 + i * 16 + gid;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn * 32 + j * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = row + 8 * h;
        if (rr >= T) continue;
        if (col < out)
          y[(size_t)rr * out + col] = cvt_out<OutT>(tot[i][j][2 * h]);
        if (col + 1 < out)
          y[(size_t)rr * out + col + 1] = cvt_out<OutT>(tot[i][j][2 * h + 1]);
      }
    }
  }
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
    if (T <= 1) return launch_gemv<P, Sel, 1, G, OutT>(xb, pl, sc, ids, yo, T, 1, out, in_p, L, stream);
    if (T <= 2) return launch_gemv<P, Sel, 2, G, OutT>(xb, pl, sc, ids, yo, T, 1, out, in_p, L, stream);
    if (T <= 4) return launch_gemv<P, Sel, 4, G, OutT>(xb, pl, sc, ids, yo, T, 1, out, in_p, L, stream);
    if (T <= 8) return launch_gemv<P, Sel, 8, G, OutT>(xb, pl, sc, ids, yo, T, 1, out, in_p, L, stream);
    if (T <= 16) return launch_gemv<P, Sel, 16, G, OutT>(xb, pl, sc, ids, yo, T, 1, out, in_p, L, stream);
    dim3 grid((out + BN - 1) / BN, (T + BM - 1) / BM);
    gemm<P, Sel, G, OutT><<<grid, kThreads, 0, stream>>>(xb, pl, sc, ids, yo,
                                                         T, out, in_p, L);
    return cudaGetLastError();
  }
}

// out_dtype: 0 = bf16, 1 = f32
template <class P, int G, class Sel = sel::Whole>
int launch(const void* x, const Planes& pl, const Scales& sc, void* y, int T,
           int out, int in_p, int out_dtype, void* stream,
           const Ids& ids = Ids{nullptr, 0}) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0:
      return (int)launch_typed<P, Sel, G, __nv_bfloat16>(x, pl, sc, ids, y, T, out, in_p, s);
    case 1:
      return (int)launch_typed<P, Sel, G, float>(x, pl, sc, ids, y, T, out, in_p, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace lowbit
