// The int8 dequant-matmuls on Hopper (sm_90a): y = x @ (scales ⊙ wq)^T.
// K1 w8_matmul (w8_matmul.cu), K6a w8_matmul_expert (w8_matmul_expert.cu)
// and K5a w8_matmul_pairs (w8_matmul_pairs.cu) are these loops entered
// with another policy of expert_select.cuh: the whole weight, one expert
// of a stack for all rows of x, or one expert per row of x.
//
// The arithmetic is the TPU kernels' (vptq_tpu/ops/pallas_gemm.py
// _w8_kernel, _w8e_kernel, _w8p_kernel): x is rounded to bf16, int8 ->
// bf16/f32 is exact, the products of each in-group are summed in f32,
// each group's f32 partial is multiplied by scales[g, o] and the scaled
// partials are summed in f32; the result is cast to the output type.
//
//   x      (T, in_p)      bf16, row-major
//   wq     (out, in_p)    int8, row-major; (E, out, in_p) with ids
//   scales (in_p/group, out) f32; (E, in_p/group, out) with ids
//   ids    int32 in device memory: one (Expert) or one per row (Pairs)
//   y      (T, out)       bf16 / f32
//
// What bounds it on an H100: at decode (T <= 16) the bytes of wq, one
// per weight, read once (6.98 GB per token at Llama-3.1-8B width); at
// prefill the tensor-core FLOPs (2*T*out*in_p). The TPU kernel walked
// in_p on a sequential grid axis with an f32 accumulator in VMEM; here
// blocks run in no order, so a loop inside each block walks in_p.
//
// Two kernels, picked by T (a pairs launch runs the first at T = 1 on a
// grid of (row tiles, pairs)):
//  * w8_gemv (T <= 16): each warp owns kRows weight rows and streams
//    them with 16-byte loads, four loads per row in flight; x for the
//    current scale group is staged in shared memory as bf16 and shared
//    by the block's warps; int8 -> f32 is a byte permute and one add
//    (no I2F), so the loop stays under the memory rate. Per-lane
//    partials are reduced with warp shuffles at each group boundary,
//    where the scale is applied.
//  * w8_gemm (T > 16): 64 x 128 output tiles, 8 warps, bf16 mma.sync
//    m16n8k16 with f32 accumulators. The int8 tile is widened to bf16
//    while it is written to shared memory; the next tile's global loads
//    are in flight during the current tile's MMAs. At each group
//    boundary the group accumulators are scaled per column (the mma C
//    layout fixes each register's column) and added to the totals.
// wgmma/TMA pipelining is later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "expert_select.cuh"

namespace w8 {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// --------------------------------------------------------------------
// helpers

// Signed byte j of word w, as f32, where u = w ^ 0x80808080: the byte
// (offset by 128) is placed in the mantissa of 2^23 and the offset
// subtracted. Exact for every int8.
__device__ __forceinline__ float i8_to_f32(uint32_t u, int j) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | j)) -
         8388736.0f;
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

// --------------------------------------------------------------------
// decode: T <= 16

constexpr int kRows = 2;      // weight rows per warp
constexpr int kSpan = 512;    // columns a warp covers with one 16 B load
constexpr int kUnroll = 4;    // spans in flight per row

template <class Sel, int TP, typename OutT>
__global__ void __launch_bounds__(kThreads)
    w8_gemv(const __nv_bfloat16* __restrict__ x,
            const int8_t* __restrict__ wq, const float* __restrict__ scales,
            OutT* __restrict__ y, const int* __restrict__ ids, int n_experts,
            int T, int out, int in_p, int group) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = (blockIdx.x * kWarps + warp) * kRows;
  const int n_groups = in_p / group;
  // this block's expert slab and, in a pairs launch, its row of x and y
  const int pair = sel::pair_of<Sel>();
  if (Sel::kIds) {
    const size_t e = sel::expert_of(ids, n_experts, pair);
    wq += e * out * in_p;
    scales += e * out * n_groups;
  }
  if (Sel::kPairs) {
    x += (size_t)pair * in_p;
    y += (size_t)pair * out;
  }
  const int vec_per_row = group / 8;  // uint4 of bf16 per x row

  bool row_ok[kRows];
  const int8_t* wrow[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    row_ok[r] = row0 + r < out;
    wrow[r] = wq + (size_t)(row_ok[r] ? row0 + r : 0) * in_p;
  }
  // lane t keeps the running total of token t for each of its rows
  float tot[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) tot[r] = 0.f;

  for (int g = 0; g < n_groups; ++g) {
    const size_t g0 = (size_t)g * group;
    __syncthreads();
    for (int i = threadIdx.x; i < TP * vec_per_row; i += kThreads) {
      const int t = i / vec_per_row;
      const int c = i - t * vec_per_row;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t < T)
        v = *reinterpret_cast<const uint4*>(x + (size_t)t * in_p + g0 +
                                            (size_t)c * 8);
      reinterpret_cast<uint4*>(xs)[i] = v;
    }
    __syncthreads();

    float part[kRows][TP];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int t = 0; t < TP; ++t) part[r][t] = 0.f;

    for (int c0 = 0; c0 < group; c0 += kUnroll * kSpan) {
      uint4 wv[kUnroll][kRows];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + u * kSpan + lane * 16;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          wv[u][r] = make_uint4(0u, 0u, 0u, 0u);
          if (c < group && row_ok[r])
            wv[u][r] = __ldg(reinterpret_cast<const uint4*>(wrow[r] + g0 + c));
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + u * kSpan + lane * 16;
        if (c >= group) break;
        float wf[kRows][16];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const uint32_t w4[4] = {wv[u][r].x ^ 0x80808080u,
                                  wv[u][r].y ^ 0x80808080u,
                                  wv[u][r].z ^ 0x80808080u,
                                  wv[u][r].w ^ 0x80808080u};
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int j = 0; j < 4; ++j) wf[r][q * 4 + j] = i8_to_f32(w4[q], j);
        }
#pragma unroll
        for (int t = 0; t < TP; ++t) {
          const uint4* xp = reinterpret_cast<const uint4*>(xs + t * group + c);
          const uint4 xa = xp[0];
          const uint4 xb = xp[1];
          const uint32_t xw[8] = {xa.x, xa.y, xa.z, xa.w,
                                  xb.x, xb.y, xb.z, xb.w};
#pragma unroll
          for (int p = 0; p < 8; ++p) {
            const float x0 = bf16_lo(xw[p]);
            const float x1 = bf16_hi(xw[p]);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              part[r][t] += wf[r][2 * p] * x0;
              part[r][t] += wf[r][2 * p + 1] * x1;
            }
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float s = row_ok[r] ? scales[(size_t)g * out + row0 + r] : 0.f;
#pragma unroll
      for (int t = 0; t < TP; ++t) {
        float v = part[r][t];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == t) tot[r] += v * s;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (row_ok[r] && lane < T)
      y[(size_t)lane * out + row0 + r] = cvt_out<OutT>(tot[r]);
}

// --------------------------------------------------------------------
// prefill: T > 16

constexpr int BM = 64;        // tokens per block tile
constexpr int BN = 128;       // output rows per block tile
constexpr int BK = 32;        // in-columns per step
constexpr int LDS = BK + 8;   // padded smem row (bf16): conflict-free frags

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

template <class Sel, typename OutT>
__global__ void __launch_bounds__(kThreads)
    w8_gemm(const __nv_bfloat16* __restrict__ x,
            const int8_t* __restrict__ wq, const float* __restrict__ scales,
            OutT* __restrict__ y, const int* __restrict__ ids, int n_experts,
            int T, int out, int in_p, int group) {
  static_assert(!Sel::kPairs, "a pairs launch runs the T = 1 GEMV");
  __shared__ __align__(16) __nv_bfloat16 xs[BM][LDS];
  __shared__ __align__(16) __nv_bfloat16 ws[BN][LDS];
  if (Sel::kIds) {
    const size_t e = sel::expert_of(ids, n_experts, 0);
    wq += e * out * in_p;
    scales += e * out * (in_p / group);
  }

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // 2 warps along tokens (32 each)
  const int wn = warp & 3;   // 4 warps along out rows (32 each)
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // global -> register staging: one 16 B load of x and one of wq per
  // thread per step
  const int xr = tid >> 2, xc = (tid & 3) * 8;
  const int wr = tid >> 1, wc = (tid & 1) * 16;
  const bool x_ok = m0 + xr < T;
  const bool w_ok = n0 + wr < out;
  const __nv_bfloat16* xp = x + (size_t)(x_ok ? m0 + xr : 0) * in_p + xc;
  const int8_t* wp = wq + (size_t)(w_ok ? n0 + wr : 0) * in_p + wc;

  float acc[2][4][4];
  float tot[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = tot[i][j][e] = 0.f;

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 xreg = x_ok ? *reinterpret_cast<const uint4*>(xp) : zero;
  uint4 wreg = w_ok ? __ldg(reinterpret_cast<const uint4*>(wp)) : zero;

  const int nk = in_p / BK;
  const int k_per_group = group / BK;
  for (int kt = 0; kt < nk; ++kt) {
    *reinterpret_cast<uint4*>(&xs[xr][xc]) = xreg;
    {
      const uint32_t w4[4] = {wreg.x ^ 0x80808080u, wreg.y ^ 0x80808080u,
                              wreg.z ^ 0x80808080u, wreg.w ^ 0x80808080u};
      uint32_t h[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        h[2 * q] = pack_bf16x2(i8_to_f32(w4[q], 0), i8_to_f32(w4[q], 1));
        h[2 * q + 1] = pack_bf16x2(i8_to_f32(w4[q], 2), i8_to_f32(w4[q], 3));
      }
      *reinterpret_cast<uint4*>(&ws[wr][wc]) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(&ws[wr][wc + 8]) =
          make_uint4(h[4], h[5], h[6], h[7]);
    }
    __syncthreads();
    if (kt + 1 < nk) {
      const size_t k1 = (size_t)(kt + 1) * BK;
      xreg = x_ok ? *reinterpret_cast<const uint4*>(xp + k1) : zero;
      wreg = w_ok ? __ldg(reinterpret_cast<const uint4*>(wp + k1)) : zero;
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

    if ((kt + 1) % k_per_group == 0) {
      const size_t srow = (size_t)((kt + 1) / k_per_group - 1) * out;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn * 32 + j * 8 + tig * 2;
        const float s0 = col < out ? scales[srow + col] : 0.f;
        const float s1 = col + 1 < out ? scales[srow + col + 1] : 0.f;
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

struct Args {
  const __nv_bfloat16* x;
  const int8_t* wq;
  const float* scales;
  const int* ids;  // null for sel::Whole
  int n_experts;
  int T, out, in_p, group;
};

// pairs: the grid's second dimension (1 unless the launch is a pairs launch)
template <class Sel, int TP, typename OutT>
cudaError_t launch_gemv(const Args& a, OutT* y, int T, int pairs,
                        cudaStream_t stream) {
  auto kernel = w8_gemv<Sel, TP, OutT>;
  const size_t smem = (size_t)TP * a.group * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int rows_per_block = kWarps * kRows;
  dim3 grid((a.out + rows_per_block - 1) / rows_per_block, pairs);
  kernel<<<grid, kThreads, smem, stream>>>(a.x, a.wq, a.scales, y, a.ids,
                                           a.n_experts, T, a.out, a.in_p,
                                           a.group);
  return cudaGetLastError();
}

template <class Sel, typename OutT>
cudaError_t launch_typed(const Args& a, void* y, cudaStream_t stream) {
  auto* yo = static_cast<OutT*>(y);
  const int T = a.T;
  if constexpr (Sel::kPairs) {
    // T pairs, each one row of x through its own expert
    if (T > 65535) return cudaErrorInvalidValue;
    return launch_gemv<Sel, 1, OutT>(a, yo, 1, T, stream);
  } else {
    if (T <= 1) return launch_gemv<Sel, 1, OutT>(a, yo, T, 1, stream);
    if (T <= 2) return launch_gemv<Sel, 2, OutT>(a, yo, T, 1, stream);
    if (T <= 4) return launch_gemv<Sel, 4, OutT>(a, yo, T, 1, stream);
    if (T <= 8) return launch_gemv<Sel, 8, OutT>(a, yo, T, 1, stream);
    if (T <= 16) return launch_gemv<Sel, 16, OutT>(a, yo, T, 1, stream);
    dim3 grid((a.out + BN - 1) / BN, (T + BM - 1) / BM);
    w8_gemm<Sel, OutT><<<grid, kThreads, 0, stream>>>(
        a.x, a.wq, a.scales, yo, a.ids, a.n_experts, T, a.out, a.in_p,
        a.group);
    return cudaGetLastError();
  }
}

// out_dtype: 0 = bf16, 1 = f32. Returns the CUDA error code of the
// launch (0 on success). Requires in_p % group == 0, group % 32 == 0,
// 16-byte aligned x and wq, all tensors contiguous on the current device.
template <class Sel>
int launch(const void* x, const void* wq, const void* scales, const void* ids,
           void* y, int T, int out, int in_p, int group, int n_experts,
           int out_dtype, void* stream) {
  const Args a = {static_cast<const __nv_bfloat16*>(x),
                  static_cast<const int8_t*>(wq),
                  static_cast<const float*>(scales),
                  static_cast<const int*>(ids),
                  n_experts, T, out, in_p, group};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0:
      return (int)launch_typed<Sel, __nv_bfloat16>(a, y, s);
    case 1:
      return (int)launch_typed<Sel, float>(a, y, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace w8
