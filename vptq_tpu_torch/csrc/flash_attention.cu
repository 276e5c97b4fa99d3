// K8 flash_attention on Hopper (sm_90a): causal attention over one fresh
// chunk, out[b, s, h] = sum_{t <= s} softmax_t(scale * q[b,s,h].k[b,t,g])
// * v[b,t,g] with g = h / group (GQA), never materialising the scores.
//
// Replaces the Pallas TPU flash-attention op that the JAX package calls
// at vptq_tpu/models/llama.py:577-591 (body
// _flash_attention_kernel_single_batch of
// jax/experimental/pallas/ops/tpu/flash_attention.py). The arithmetic is
// that body's: q.k products of bf16 inputs summed in f32, the scale on
// the f32 scores, masked scores set to a large finite negative, running
// max and sum in f32 (the sum adds the f32 p), p rounded to bf16 before
// the p.v product, which sums in f32; one division and one rounding to
// bf16 at the end. exp is exp2 with log2(e) folded into the scale.
//
//   q (B, S, H, D)   bf16, head stride D, row and batch strides given
//   k (B, S, KV, D)  bf16, likewise (a view into a fused q|k|v row is fine)
//   v (B, S, KV, D)  bf16, likewise
//   o (B, S, H * D)  bf16, contiguous
//
// The JAX call repeats K/V to H heads and moves heads before positions;
// here the KV head is h / group and every layout is read in place.
//
// What bounds it on an H100: the tensor-core operations, 4*D per
// (query, key) pair of the lower triangle (34 GFLOP at S = 2048, H = 32,
// D = 128 against 42 MB moved). The TPU kernel walks the K/V blocks on a
// sequential grid axis with m, l and the accumulator in VMEM scratch;
// here blocks run in no order, so one block owns a 64-query tile of one
// head and loops over its K/V tiles itself, with m, l and the accumulator
// in registers. Tiles above the diagonal are never loaded; the diagonal
// tile is masked per element. K/V tiles of 64 positions arrive by
// cp.async, double-buffered, so the next tile's loads run under this
// tile's MMAs. 4 warps of 16 query rows; bf16 mma.sync m16n8k16 with f32
// accumulators. The f32 score fragment, packed to bf16, is the A operand
// of the p.v product as it lies, so p never touches shared memory; V is
// read with ldmatrix.trans so that positions become the k dimension.
// Shared rows are padded by 8 bf16, which keeps every ldmatrix free of
// bank conflicts. The heaviest query tiles are scheduled first.
// wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fa {

constexpr int BM = 64;  // queries per block
constexpr int BN = 64;  // K/V positions per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// DEFAULT_MASK_VALUE of the TPU op: -0.7 * max f32
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; zero-filled when !ok (src must stay valid)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 64 rows of D bf16 from row0 on (row stride in elements) into a padded
// shared tile; rows at or past S are zero-filled, so that a masked
// probability of 0 never meets a NaN
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int row0, int S) {
  constexpr int LD = D + 8;
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < 64 * CPR; i += kThreads) {
    const int r = i / CPR;
    const int c = i - r * CPR;
    const bool ok = row0 + r < S;
    const __nv_bfloat16* g = src + (long long)(ok ? row0 + r : 0) * stride +
                             c * 8;
    cp_async16(dst + r * LD + c * 8, g, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, int S, int H, int group,
              long long q_sb, long long q_ss, long long k_sb, long long k_ss,
              long long v_sb, long long v_ss, float scale_log2e) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BM][LD]
  __nv_bfloat16* Ks = Qs + BM * LD;      // [2][BN][LD]
  __nv_bfloat16* Vs = Ks + 2 * BN * LD;  // [2][BN][LD]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  // the last query tile has the most K/V tiles: run it first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int m0 = qt * BM;
  const __nv_bfloat16* qb = q + (long long)b * q_sb + (long long)h * D;
  const __nv_bfloat16* kb = k + (long long)b * k_sb + (long long)(h / group) * D;
  const __nv_bfloat16* vb = v + (long long)b * v_sb + (long long)(h / group) * D;

  load_tile<D>(Qs, qb, q_ss, m0, S);
  load_tile<D>(Ks, kb, k_ss, 0, S);
  load_tile<D>(Vs, vb, v_ss, 0, S);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float oacc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  // rows gid and gid + 8 of this warp's 16: running max (of the scores
  // times log2 e) and this thread's share of the running sum
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  // ldmatrix source coordinates of this lane (matrix lane / 8, row lane % 8)
  const int lm = lane >> 3;
  const int lr = lane & 7;

  const int n_kt = qt + 1;  // tiles up to and including the diagonal
  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_kt) {
      load_tile<D>(Ks + (buf ^ 1) * BN * LD, kb, k_ss, (kt + 1) * BN, S);
      load_tile<D>(Vs + (buf ^ 1) * BN * LD, vb, v_ss, (kt + 1) * BN, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                            (lane >> 4) * 8);
    }

    // scores: S = Q K^T, 16 rows x 64 positions per warp
    float sacc[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
    const __nv_bfloat16* Kt = Ks + buf * BN * LD;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < BN / 16; ++jp) {
        uint32_t kr[4];
        ldsm_x4(kr, Kt + (jp * 16 + (lm >> 1) * 8 + lr) * LD + kk * 16 +
                        (lm & 1) * 8);
        mma_bf16(sacc[2 * jp], qf[kk], kr[0], kr[1]);
        mma_bf16(sacc[2 * jp + 1], qf[kk], kr[2], kr[3]);
      }
    }

    // scale, causal mask (the diagonal tile only), running max
    const bool diag = kt == qt;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sacc[j][e] * scale_log2e;
        if (diag) {
          const int col = j * 8 + tig * 2 + (e & 1);
          const int row = warp * 16 + gid + (e >> 1) * 8;
          if (col > row) s = kMaskValue;
        }
        sacc[j][e] = s;
        mx[e >> 1] = fmaxf(mx[e >> 1], s);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // column 0 of the first tile is never masked, so m_new is finite
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sacc[j][e] - m_run[e >> 1]);
        sacc[j][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }

    // O += P V, p rounded to bf16
    const __nv_bfloat16* Vt = Vs + buf * BN * LD;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16x2(sacc[2 * kk][0], sacc[2 * kk][1]),
          pack_bf16x2(sacc[2 * kk][2], sacc[2 * kk][3]),
          pack_bf16x2(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
          pack_bf16x2(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t vr[4];
        ldsm_x4_trans(vr, Vt + (kk * 16 + (lm & 1) * 8 + lr) * LD + np * 16 +
                              (lm >> 1) * 8);
        mma_bf16(oacc[2 * np], pa, vr[0], vr[1]);
        mma_bf16(oacc[2 * np + 1], pa, vr[2], vr[3]);
      }
    }
    // every warp is done with this buffer before the next loads land in it
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    const int row = m0 + warp * 16 + gid + r * 8;
    if (row >= S) continue;
    const float inv = 1.f / l_run[r];
    __nv_bfloat16* orow =
        o + (((long long)b * S + row) * H + h) * D + tig * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16x2(oacc[n][2 * r] * inv, oacc[n][2 * r + 1] * inv);
  }
}

template <int D>
cudaError_t launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, __nv_bfloat16* o, int B, int S,
                   int H, int KV, long long q_sb, long long q_ss,
                   long long k_sb, long long k_ss, long long v_sb,
                   long long v_ss, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd<D>;
  const int smem = (BM + 4 * BN) * (D + 8) * (int)sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((S + BM - 1) / BM, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      q, k, v, o, S, H, H / KV, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
      (float)((double)scale * 1.4426950408889634));
  return cudaGetLastError();
}

}  // namespace fa

// Strides in elements: *_sb between batches, *_ss between positions; a
// head's D values are contiguous and heads lie D apart. Requires D in
// {64, 128}, H % KV == 0, S >= 1, H and B at most 65535, 16-byte aligned
// pointers and strides that are multiples of 8. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int vptq_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, int B, int S,
                                    int H, int KV, int D, long long q_sb,
                                    long long q_ss, long long k_sb,
                                    long long k_ss, long long v_sb,
                                    long long v_ss, float scale,
                                    void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* kp = static_cast<const __nv_bfloat16*>(k);
  auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)fa::launch<64>(qp, kp, vp, op, B, S, H, KV, q_sb, q_ss,
                                 k_sb, k_ss, v_sb, v_ss, scale, s);
    case 128:
      return (int)fa::launch<128>(qp, kp, vp, op, B, S, H, KV, q_sb, q_ss,
                                  k_sb, k_ss, v_sb, v_ss, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
