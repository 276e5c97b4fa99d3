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
// weight, read once; at prefill the tensor-core operations (2*T*out*in,
// 0.226 ms per Llama-3.1-8B layer at T = 512). The TPU kernel walked in
// on a sequential grid axis with an f32 accumulator in VMEM; here a loop
// inside each block walks it:
//  * bf16_gemv (T <= 16): each warp owns kRows weight rows and streams
//    them with 16-byte loads, kRows * 2 loads per lane in flight; x is
//    staged in shared memory 512 columns at a time and shared by the
//    block's warps; per-lane partials are reduced with warp shuffles at
//    the end.
//  * T > 16: the Hopper prefill tile of lowbit_tile.cuh (wg_tile) with
//    the policy BF16 below, in its SS form: w is K-major like x, so both
//    wgmma operands come from 128-byte-swizzled shared memory through
//    descriptors, fed by a TMA ring (128 output rows x 128 tokens a block,
//    weight stages of 128 x 128 bf16 in two 64-position boxes); there is
//    nothing to unpack and no scale, and the f32 sums are written once.

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

// The bf16 weight on the prefill tile: one 128-position stage feeds one x
// slab, both read by wgmma from shared memory (lowbit_tile.cuh's SS form).
// The name BF16 tags the tile's instances in a profiler trace
// (bf16_matmul.trace_tags).
struct BF16 {
  static constexpr bool kTileSS = true;
  static constexpr int kPlanes = 1;
  static constexpr int kParts = 1;
};

namespace tile = lowbit::tile;

// T > 16 tokens through the tile: x (T, in) and w (out, in) as 2-D maps of
// 64-position boxes (128 tokens, 128 rows); the scales and ids go unused
template <typename OutT>
cudaError_t launch_tile(const __nv_bfloat16* x, const __nv_bfloat16* w,
                        OutT* y, int T, int out, int in,
                        cudaStream_t stream) {
  const uint64_t row = (uint64_t)in * sizeof(__nv_bfloat16);
  tile::Maps maps = {};
  if (!tile::encode(&maps.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, T, in, row,
                    tile::kTokens, 64) ||
      !tile::encode(&maps.w[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, out, in,
                    row, tile::kRows, 64))
    return cudaErrorInvalidValue;
  using Sc = lowbit::ScalesOf<float>;
  auto kernel = tile::wg_tile<BF16, sel::Whole, tile::kGroup, OutT, Sc>;
  constexpr int smem = tile::Smem<BF16>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T + tile::kTokens - 1) / tile::kTokens,
                  (out + tile::kRows - 1) / tile::kRows);
  kernel<<<grid, tile::kThreads, smem, stream>>>(
      maps, Sc{nullptr, 0, 0}, lowbit::Ids{nullptr, 0}, y, T, out, in, 1);
  return cudaGetLastError();
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
  return launch_tile<OutT>(x, w, yo, T, out, in, stream);
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
