// K7 bf16_matmul on Hopper (sm_90a): y = x @ w^T with bf16 operands and
// f32 accumulation, the exact-parity runtime format's product.
//
// Replaces vptq_tpu/ops/pallas_gemm.py:_bf16_kernel (entry bf16_matmul):
// x is rounded to bf16, the products are summed in f32 over the whole of
// in, and the sum is cast to the output type once.
//
//   x (T, in)    bf16, row-major, in % 512 == 0
//   w (out, in)  bf16, row-major
//   y (T, out)   bf16 / f32
//
// What bounds it on an H100: at decode (T <= 16) the bytes of w, two per
// weight, read once; at prefill the tensor-core FLOPs (2*T*out*in). The
// TPU kernel walked in on a sequential grid axis with an f32 accumulator
// in VMEM; here a loop inside each block walks it. This is K1's pair of
// kernels (w8.cuh) without the int8 widening and the scale groups:
//  * bf16_gemv (T <= 16): each warp owns kRows weight rows and streams
//    them with 16-byte loads, kRows * 2 loads per lane in flight; x is
//    staged in shared memory 512 columns at a time and shared by the
//    block's warps; per-lane partials are reduced with warp shuffles at
//    the end.
//  * bf16_gemm (T > 16): 64 x 128 output tiles, 8 warps, bf16 mma.sync
//    m16n8k16 with f32 accumulators; the next tile's global loads are in
//    flight during the current tile's MMAs.
// wgmma/TMA pipelining is later work.

#include "w8.cuh"

namespace bf16mm {

using w8::bf16_hi;
using w8::bf16_lo;
using w8::cvt_out;
using w8::kThreads;
using w8::kWarps;

constexpr int kRows = 2;     // weight rows per warp
constexpr int kChunk = 512;  // columns of x staged at a time
constexpr int kSpan = 256;   // columns a warp covers with one 16 B load

template <int TP, typename OutT>
__global__ void __launch_bounds__(kThreads)
    bf16_gemv(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ w, OutT* __restrict__ y,
              int T, int out, int in) {
  __shared__ __align__(16) __nv_bfloat16 xs[TP * kChunk];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = (blockIdx.x * kWarps + warp) * kRows;

  bool row_ok[kRows];
  const __nv_bfloat16* wrow[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    row_ok[r] = row0 + r < out;
    wrow[r] = w + (size_t)(row_ok[r] ? row0 + r : 0) * in;
  }
  float part[kRows][TP];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int t = 0; t < TP; ++t) part[r][t] = 0.f;

  constexpr int kVecPerRow = kChunk / 8;  // uint4 of bf16 per staged x row
  for (int c0 = 0; c0 < in; c0 += kChunk) {
    __syncthreads();
    for (int i = threadIdx.x; i < TP * kVecPerRow; i += kThreads) {
      const int t = i / kVecPerRow;
      const int c = i - t * kVecPerRow;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t < T)
        v = *reinterpret_cast<const uint4*>(x + (size_t)t * in + c0 + c * 8);
      reinterpret_cast<uint4*>(xs)[i] = v;
    }
    __syncthreads();

    uint4 wv[kChunk / kSpan][kRows];
#pragma unroll
    for (int u = 0; u < kChunk / kSpan; ++u)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        wv[u][r] = row_ok[r]
                       ? __ldg(reinterpret_cast<const uint4*>(
                             wrow[r] + c0 + u * kSpan + lane * 8))
                       : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int u = 0; u < kChunk / kSpan; ++u) {
      const int c = u * kSpan + lane * 8;
#pragma unroll
      for (int t = 0; t < TP; ++t) {
        const uint4 xv = *reinterpret_cast<const uint4*>(xs + t * kChunk + c);
        const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const uint32_t ww[4] = {wv[u][r].x, wv[u][r].y, wv[u][r].z,
                                  wv[u][r].w};
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            part[r][t] += bf16_lo(ww[p]) * bf16_lo(xw[p]);
            part[r][t] += bf16_hi(ww[p]) * bf16_hi(xw[p]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int t = 0; t < TP; ++t) {
      float v = part[r][t];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == t && t < T && row_ok[r])
        y[(size_t)t * out + row0 + r] = cvt_out<OutT>(v);
    }
  }
}

using w8::BK;
using w8::BM;
using w8::BN;
using w8::LDS;
using w8::lds32;
using w8::mma_bf16;

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    bf16_gemm(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ w, OutT* __restrict__ y,
              int T, int out, int in) {
  __shared__ __align__(16) __nv_bfloat16 xs[BM][LDS];
  __shared__ __align__(16) __nv_bfloat16 ws[BN][LDS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // 2 warps along tokens (32 each)
  const int wn = warp & 3;   // 4 warps along out rows (32 each)
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // global -> register staging per step: one 16 B load of x and two of w
  const int xr = tid >> 2, xc = (tid & 3) * 8;
  const int wr = tid >> 1, wc = (tid & 1) * 16;
  const bool x_ok = m0 + xr < T;
  const bool w_ok = n0 + wr < out;
  const __nv_bfloat16* xp = x + (size_t)(x_ok ? m0 + xr : 0) * in + xc;
  const __nv_bfloat16* wp = w + (size_t)(w_ok ? n0 + wr : 0) * in + wc;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 xreg = x_ok ? *reinterpret_cast<const uint4*>(xp) : zero;
  uint4 wreg0 = w_ok ? __ldg(reinterpret_cast<const uint4*>(wp)) : zero;
  uint4 wreg1 = w_ok ? __ldg(reinterpret_cast<const uint4*>(wp + 8)) : zero;

  const int nk = in / BK;
  for (int kt = 0; kt < nk; ++kt) {
    *reinterpret_cast<uint4*>(&xs[xr][xc]) = xreg;
    *reinterpret_cast<uint4*>(&ws[wr][wc]) = wreg0;
    *reinterpret_cast<uint4*>(&ws[wr][wc + 8]) = wreg1;
    __syncthreads();
    if (kt + 1 < nk) {
      const size_t k1 = (size_t)(kt + 1) * BK;
      xreg = x_ok ? *reinterpret_cast<const uint4*>(xp + k1) : zero;
      wreg0 = w_ok ? __ldg(reinterpret_cast<const uint4*>(wp + k1)) : zero;
      wreg1 = w_ok ? __ldg(reinterpret_cast<const uint4*>(wp + k1 + 8)) : zero;
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
          y[(size_t)rr * out + col] = cvt_out<OutT>(acc[i][j][2 * h]);
        if (col + 1 < out)
          y[(size_t)rr * out + col + 1] = cvt_out<OutT>(acc[i][j][2 * h + 1]);
      }
    }
  }
}

template <int TP, typename OutT>
cudaError_t launch_gemv(const __nv_bfloat16* x, const __nv_bfloat16* w,
                        OutT* y, int T, int out, int in,
                        cudaStream_t stream) {
  const int rows_per_block = kWarps * kRows;
  bf16_gemv<TP, OutT>
      <<<(out + rows_per_block - 1) / rows_per_block, kThreads, 0, stream>>>(
          x, w, y, T, out, in);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch(const __nv_bfloat16* x, const __nv_bfloat16* w, void* y,
                   int T, int out, int in, cudaStream_t stream) {
  auto* yo = static_cast<OutT*>(y);
  if (T <= 1) return launch_gemv<1, OutT>(x, w, yo, T, out, in, stream);
  if (T <= 2) return launch_gemv<2, OutT>(x, w, yo, T, out, in, stream);
  if (T <= 4) return launch_gemv<4, OutT>(x, w, yo, T, out, in, stream);
  if (T <= 8) return launch_gemv<8, OutT>(x, w, yo, T, out, in, stream);
  if (T <= 16) return launch_gemv<16, OutT>(x, w, yo, T, out, in, stream);
  dim3 grid((out + BN - 1) / BN, (T + BM - 1) / BM);
  bf16_gemm<OutT><<<grid, kThreads, 0, stream>>>(x, w, yo, T, out, in);
  return cudaGetLastError();
}

}  // namespace bf16mm

// out_dtype: 0 = bf16, 1 = f32. Returns the CUDA error code of the
// launch (0 on success). Requires in % 512 == 0, 16-byte aligned x and
// w, both contiguous on the current device.
extern "C" int vptq_bf16_matmul(const void* x, const void* w, void* y, int T,
                                int out, int in, int out_dtype,
                                void* stream) {
  auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* wp = static_cast<const __nv_bfloat16*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in < 512 || in % 512) return (int)cudaErrorInvalidValue;
  switch (out_dtype) {
    case 0:
      return (int)bf16mm::launch<__nv_bfloat16>(xp, wp, y, T, out, in, s);
    case 1:
      return (int)bf16mm::launch<float>(xp, wp, y, T, out, in, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
