// The small-codebook VQ probe P3 on Hopper (sm_90a): a GEMV whose weights
// are uint8 ids into a codebook of at most 256 vectors, expanded inside
// the kernel.
//
// Replaces examples/vq_smallk_probe.py:vq_matmul's kernel (onehot_only
// False and True).
//
//   x        (T, in)      bf16
//   ids      (out, in / v) uint8; id c of row o selects the v-vector of
//                         columns c·v … c·v + v − 1
//   codebook (k, v)       bf16, k <= 256, v in {4, 8}
//   y        (T, out)     bf16 / f32
//
//   fused        y[t, o] = Σ_c Σ_d x[t, c·v + d] · C[ids[o, c], d], f32
//                sums; an id >= k adds 0
//   onehot_only  y[t, o] = Σ_c x[t, c·v] · [ids[o, c] < k]: the ids stream
//                and its compare alone, the floor of the same kernel
//
// What bounds it on an H100: the id bytes, 1/v byte per weight (11.3 MB
// for the 22016 x 4096 gate_up of a 7B model at v = 8, 3.4 µs at
// 3.35 TB/s). The TPU kernel selects each vector with a one-hot product
// on its matrix unit (256 compares and 512·v flops per id); here there is
// no one-hot: the codebook is staged in shared memory as bf16, padded
// with zero rows to 256, so an id >= k reads zeros and nothing past the
// codebook is ever read, and each id costs one shared-memory read of v
// bf16 (16 or 8 bytes) and v FMAs per token. Design (probe_gemv.cuh's
// frame): each lane takes 16 ids of a row at a time with one 16-byte
// load; random ids make the shared-memory reads conflict in banks.

#include "probe_gemv.cuh"

namespace vq_smallk {

// one codebook vector of V bf16: V = 8 one uint4, V = 4 one uint2
template <int V>
struct Vec;
template <>
struct Vec<8> {
  using T = uint4;
};
template <>
struct Vec<4> {
  using T = uint2;
};

template <int V>
__device__ __forceinline__ void unpack(const typename Vec<V>::T& v,
                                       float (&f)[V]) {
  const uint32_t* u = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < V / 2; ++i) {
    f[2 * i] = probe::bf16_lo(u[i]);
    f[2 * i + 1] = probe::bf16_hi(u[i]);
  }
}

template <int V, bool kOnehot, int TP, int kRows, typename OutT>
__global__ void __launch_bounds__(probe::kThreads)
    vq_smallk_gemv(const __nv_bfloat16* __restrict__ x,
                   const uint8_t* __restrict__ ids,
                   const __nv_bfloat16* __restrict__ cb, int k,
                   OutT* __restrict__ y, int T, int out, int in) {
  using VecT = typename Vec<V>::T;
  __shared__ __align__(16) __nv_bfloat16 cbs[256 * V];
  if (!kOnehot) {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
    for (int i = threadIdx.x; i < 256 * V; i += probe::kThreads)
      cbs[i] = i < k * V ? cb[i] : zero;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  int row0, t0;
  probe::origin<kRows, TP>(row0, t0);
  const int n_ids = in / V;

  float tot[kRows][TP];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int t = 0; t < TP; ++t) tot[r][t] = 0.f;

  for (int c0 = lane * 16; c0 < n_ids; c0 += 32 * 16) {
    uint4 iv[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      iv[r] = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < out)
        iv[r] = __ldg(reinterpret_cast<const uint4*>(
            ids + (size_t)(row0 + r) * n_ids + c0));
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = (c0 + j) * V;
      if constexpr (kOnehot) {
        float x0[TP];
#pragma unroll
        for (int t = 0; t < TP; ++t)
          x0[t] = t0 + t < T
                      ? __bfloat162float(x[(size_t)(t0 + t) * in + col])
                      : 0.f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int id = (probe::word(iv[r], j >> 2) >> (8 * (j & 3))) & 0xFF;
#pragma unroll
          for (int t = 0; t < TP; ++t)
            tot[r][t] += id < k ? x0[t] : 0.f;
        }
      } else {
        float xf[TP][V];
#pragma unroll
        for (int t = 0; t < TP; ++t) {
          VecT xv{};
          if (t0 + t < T)
            xv = __ldg(reinterpret_cast<const VecT*>(
                x + (size_t)(t0 + t) * in + col));
          unpack<V>(xv, xf[t]);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int id = (probe::word(iv[r], j >> 2) >> (8 * (j & 3))) & 0xFF;
          float cf[V];
          unpack<V>(reinterpret_cast<const VecT*>(cbs)[id], cf);
#pragma unroll
          for (int t = 0; t < TP; ++t)
#pragma unroll
            for (int d = 0; d < V; ++d) tot[r][t] += cf[d] * xf[t][d];
        }
      }
    }
  }
  probe::store<kRows, TP>(tot, y, row0, t0, T, out,
                          [](int, float v) { return v; });
}

template <int V, bool kOnehot, typename OutT>
struct Launch {
  template <int TP>
  struct At {
    static cudaError_t run(int T, const __nv_bfloat16* x, const uint8_t* ids,
                           const __nv_bfloat16* cb, int k, OutT* y, int out,
                           int in, cudaStream_t stream) {
      constexpr int kRows = TP <= 2 ? 4 : 2;
      vq_smallk_gemv<V, kOnehot, TP, kRows, OutT>
          <<<probe::grid<kRows, TP>(out, T), probe::kThreads, 0, stream>>>(
              x, ids, cb, k, y, T, out, in);
      return cudaGetLastError();
    }
  };
};

template <int V, bool kOnehot, typename OutT>
cudaError_t launch(const void* x, const void* ids, const void* cb, int k,
                   void* y, int T, int out, int in, cudaStream_t stream) {
  return probe::by_tokens<Launch<V, kOnehot, OutT>::template At>(
      T, static_cast<const __nv_bfloat16*>(x),
      static_cast<const uint8_t*>(ids),
      static_cast<const __nv_bfloat16*>(cb), k, static_cast<OutT*>(y), out,
      in, stream);
}

template <int V, typename OutT>
cudaError_t launch_v(const void* x, const void* ids, const void* cb, int k,
                     int onehot, void* y, int T, int out, int in,
                     cudaStream_t stream) {
  return onehot ? launch<V, true, OutT>(x, ids, cb, k, y, T, out, in, stream)
                : launch<V, false, OutT>(x, ids, cb, k, y, T, out, in, stream);
}

template <typename OutT>
cudaError_t launch_typed(const void* x, const void* ids, const void* cb,
                         int k, int v, int onehot, void* y, int T, int out,
                         int in, cudaStream_t stream) {
  if (v == 8)
    return launch_v<8, OutT>(x, ids, cb, k, onehot, y, T, out, in, stream);
  if (v == 4)
    return launch_v<4, OutT>(x, ids, cb, k, onehot, y, T, out, in, stream);
  return cudaErrorInvalidValue;
}

}  // namespace vq_smallk

// Returns the CUDA error of the launch (0 on success). Requires v in {4, 8},
// 1 <= k <= 256, in % (16·v) == 0, 16-byte aligned x and ids, all tensors
// contiguous on the current device; out_dtype 0 = bf16, 1 = f32.
extern "C" int vptq_vq_smallk_matmul(const void* x, const void* ids,
                                     const void* codebook, void* y, int T,
                                     int out, int in, int k, int v,
                                     int onehot, int out_dtype,
                                     void* stream) {
  if (k < 1 || k > 256 || (v != 4 && v != 8) || in % (16 * v))
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0:
      return (int)vq_smallk::launch_typed<__nv_bfloat16>(
          x, ids, codebook, k, v, onehot, y, T, out, in, st);
    case 1:
      return (int)vq_smallk::launch_typed<float>(x, ids, codebook, k, v,
                                                 onehot, y, T, out, in, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
