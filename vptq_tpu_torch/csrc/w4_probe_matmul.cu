// The int4 unpack probes P1a, P1b and P2 on Hopper (sm_90a): K2's function
// y = x @ (s ⊙ L)^T on K2's bytes, with the nibbles unpacked in other ways.
//
// Replaces examples/w4_wall_candidates.py:_prod_kernel and _fma16_kernel
// (entry run_variant) and examples/w4_unpack_ablation.py:_kernel (entry
// variant_matmul).
//
//   x      (T, in_p)         bf16, or f32 in the modes fma16f32 and t8
//   wq     (out, in_p / 2)   int8, split-half nibbles (w4.cuh): byte k of
//                            a row holds column k in its low nibble and
//                            column in_p/2 + k in its high one; for fma16
//                            the byte is 16·hi + lo of those two columns
//   scales (in_p / 128, out) bf16
//   y      (T, out)          bf16 / f32
//
// Modes, each a policy of namespace unpack (the unpack of one byte into
// the levels of its two columns) on one kernel, so that beside K2
// (w4::W4, the magic-number unpack) the card compares unpacks and
// nothing else:
//   prod      the TPU kernel's unpack: sign-extend the byte, lo =
//             (b << 28) >> 28, hi = b >> 4, two integer-to-float converts
//   shift28   lo = b << 28 and 2^-28 folded into the low part's scales
//             (one shift fewer per low nibble)
//   fma16     byte b = 16·hi + lo: one convert, hi = rint(b / 16), lo =
//             b − 16·hi (round half to even, as jnp.round)
//   fma16f32  fma16 with x read in f32
//   t8        prod with x read in f32 (the TPU's 8-row token tile needs
//             f32 operands; here only the operand type is left)
//   g256      prod with one scale row per 256 columns: rows 2·(k / 256)
//             for the low nibble of byte k, in_p/256 + 2·(k / 256) for
//             the high one (G = 256, group stride 2·out)
// x in f32 is rounded to bf16 as it is staged, so every mode computes the
// numbers of its bf16 sibling.
//
// What bounds it on an H100: at decode the weight bytes, as K2 (half a byte
// per weight, 45 MB for the 22016 x 4096 gate_up of a 7B model, 0.014 ms
// at 3.35 TB/s); the question these modes ask is how many instructions
// per weight the unpack costs on top of the product.
// Design: ring_gemv.cuh's frame, as P1c (w4_i32x8_matmul.cu), so that the
// frame is the fast one and only the unpack differs between modes:
//  * The bytes stream through the asynchronous ring: 32 rows a block up to
//    8 tokens, 64 past them; stages of 128 bytes of a row (128 positions,
//    each a column of both parts); a cluster splits a row's groups (g256:
//    pairs of stages, so that no range cuts a group).
//  * x (both parts of the block's stages) and the scales of its rows are
//    staged once a block, before the producer starts: bf16 x by cp.async,
//    f32 x through registers, rounded to bf16 there. x unit w (positions
//    4w .. 4w + 3) of a part's stage lies at w + w / 16 of 34 units, the
//    rows of x 2 mod 16 units apart, so that a half warp's 8-byte B reads
//    (4 tokens x 4 threads of a quad) fall in 16 distinct bank pairs and
//    each read's place is the thread's base plus a constant.
//  * A thread reads 16-byte chunks 2·tig and 2·tig + 1 of rows r0 and
//    r0 + 8 of each stage. Step (h, u) takes word u of chunk 2·tig + h of
//    both rows (positions q .. q + 3, q = 32·tig + 16·h + 4·u): the policy
//    unpacks each of its bytes into the levels of both parts, each pair
//    of positions of a part is packed into one bf16x2 A register
//    (cvt.rn.bf16x2.f32: slots 2·tig, +1 are positions q, q + 1, slots
//    2·tig + 8, +9 are q + 2, q + 3), and one mma.sync m16n8k16 bf16 ->
//    f32 a part and token tile takes x's unit of those four positions as
//    its B (one 8-byte read).
//  * Each part sums its group's steps in its own acc; once the group is
//    whole (a stage; g256: two) each is folded into the totals with its
//    scale.

#include "ring_gemv.cuh"

// A block's phases, for a timeline: 0 its start, 1 x and the scales
// staged, 2 the first stage landed, 3 the last stage used, 4 y stored
// (examples/probe_timeline.py stamps %globaltimer there; empty here).
#ifndef RG_STAMP_IF
#define RG_STAMP_IF(cond, i)
#endif

namespace unpack {

// The policies: the levels (lo: the low part's, hi: the high part's) of
// byte j of word w, each mode in its own arithmetic, read by
// tests/test_torch_probe_codes.py. Their names tag the kernels in a
// profiler trace (w4_probe_matmul.trace_tags). kLowScale multiplies the
// low part's scales as they are staged.

// the bits of w shifted left by n, as a signed int
__device__ __forceinline__ int shl(uint32_t w, int n) {
  return (int)(w << n);
}
// v shifted right by n, its sign copied in
__device__ __forceinline__ int asr(int v, int n) { return v >> n; }
// the integer-to-float convert (cvt.rn.f32.s32)
__device__ __forceinline__ float i2f(int v) { return (float)v; }

struct Prod {
  static constexpr float kLowScale = 1.f;
  __device__ static void levels(uint32_t w, int j, float& lo, float& hi) {
    const int b = asr(shl(w, 24 - 8 * j), 24);
    lo = i2f(asr(shl(b, 28), 28));
    hi = i2f(asr(b, 4));
  }
};

struct Shift28 {
  static constexpr float kLowScale = 0x1p-28f;
  __device__ static void levels(uint32_t w, int j, float& lo, float& hi) {
    const int b = asr(shl(w, 24 - 8 * j), 24);
    lo = i2f(shl(b, 28));
    hi = i2f(asr(b, 4));
  }
};

struct Fma16 {
  static constexpr float kLowScale = 1.f;
  __device__ static void levels(uint32_t w, int j, float& lo, float& hi) {
    const float f = i2f(asr(shl(w, 24 - 8 * j), 24));
    hi = rintf(f * 0.0625f);
    lo = fmaf(-16.f, hi, f);
  }
};

enum Mode { kProd, kShift28, kFma16, kFma16F32, kT8, kG256 };

// two levels as a bf16 pair, a in the low half
__device__ __forceinline__ uint32_t pair(float a, float b) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(b), "f"(a));
  return d;
}

// 32 rows a block up to 8 tokens (NT = 1), 64 past them, as P1c
template <int NT>
using FrameOf = ring::Frame<NT == 1 ? 2 : 4>;
constexpr int kParts = 2;
constexpr int kStageUnits = ring::kStage / 4;  // x units of a part's stage
constexpr int kBlockUnits = kStageUnits + 2;   // their places, padded

// the 8-byte units of one token's row of x, of stages stages of both
// parts: kBlockUnits each, rounded up to 2 mod 16
__host__ __device__ inline int x_pitch(int stages) {
  const int used = kParts * kBlockUnits * stages;
  return used + ((2 - used % 16) + 16) % 16;
}

// the bytes of dynamic shared memory a block takes: the ring, x (tokens
// rows of `units` groups of gs stages), the scales of its rows (one bf16
// a group, part and row) and the ranks' partials
template <class Frame>
inline size_t smem_bytes(int tokens, int units, int gs) {
  return (size_t)Frame::kHead + (size_t)tokens * x_pitch(units * gs) * 8 +
         (size_t)units * kParts * Frame::kRows * 2 +
         (size_t)Frame::kRows * tokens * 4;
}

template <int NT>
constexpr int kMinBlocks = NT == 1 ? 5 : 2;

__device__ __forceinline__ uint32_t word(const uint4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// x's staging: bf16 x unit by unit (cp.async, 8 bytes), f32 x in batches
// of kXBatch units a thread loaded into registers, each rounded to bf16
// and stored; `release` lets the producer start once the first loads are
// out
constexpr int kXBatch = 8;

__device__ __forceinline__ void store_x(uint32_t dst, const float4& v) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};" ::"r"(dst),
               "r"(lowbit::pack_bf16x2(v.x, v.y)),
               "r"(lowbit::pack_bf16x2(v.z, v.w))
               : "memory");
}

// G: the scale group (128: a stage, 256: two); XT: the type x lies in
template <class P, typename XT, int G, int NT, typename OutT>
__global__ void __launch_bounds__(FrameOf<NT>::kThreads, kMinBlocks<NT>)
    ring_gemv(const XT* __restrict__ x, const uint8_t* __restrict__ w,
              const __nv_bfloat16* __restrict__ s, OutT* __restrict__ y,
              int T, int out, int in_p) {
  using Frame = FrameOf<NT>;
  constexpr int kConsumers = Frame::kConsumers;
  constexpr int kRows = Frame::kRows;
  constexpr int kCThreads = 32 * kConsumers;
  constexpr int kGS = G / ring::kStage;  // stages of a group
  const int L = in_p / kParts;           // positions of a row
  const int n = L / G;                   // groups of a part
  const int split = (int)gridDim.x;
  const int rank = (int)cooperative_groups::this_cluster().block_rank();
  const int max_st = (n + split - 1) / split * kGS;
  int ga, gb;
  ring::range_of(rank, split, n, ga, gb);
  const int st0 = ga * kGS;           // the range's first stage
  const int nl = (gb - ga) * kGS;     // its stages
  const int n0 = blockIdx.y * kRows;
  const int rows = min(kRows, out - n0);
  const int t0 = blockIdx.z * 8 * NT;
  const int tt = min(T - t0, 8 * NT);
  x += (size_t)t0 * in_p;
  y += (size_t)t0 * out;

  RG_STAMP_IF(true, 0);
  extern __shared__ __align__(16) unsigned char up_smem[];
  unsigned char* sm =
      up_smem + ((128 - (ring::smem_u32(up_smem) & 127)) & 127);
  const uint32_t full = ring::smem_u32(sm), empty = full + 8 * ring::kRing;
  const uint32_t ring_u32 = full + ring::kBars;
  const uint32_t xs = ring_u32 + ring::kRing * Frame::kSlot;
  const int pitch = x_pitch(max_st);  // units of an x row
  // the scales: [group of the range][part][row]
  __nv_bfloat16* ss =
      reinterpret_cast<__nv_bfloat16*>(sm + (xs - full) + tt * pitch * 8);
  float* rx = reinterpret_cast<float*>(ss + max_st / kGS * kParts * kRows);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  ring::init_bars<Frame>(full, empty);
  __syncthreads();
  if (split > 1) ring::cluster_arrive_relaxed();

  float tot[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) tot[j][e] = 0.f;

  const bool producer = warp == kConsumers;
  if (producer) {
    asm volatile("bar.sync 2, %0;" ::"n"(Frame::kThreads) : "memory");
    ring::produce<Frame>(w, (size_t)L, L / 16, n0, rows, st0, nl, ring_u32,
                         full, empty);
  } else {
    bool went = false;  // whether this thread let the producer start
    auto release = [&] {
      if (!went)
        asm volatile("barrier.cta.arrive 2, %0;" ::"n"(Frame::kThreads)
                     : "memory");
      went = true;
    };
    // x: tt rows of both parts of the range's stages, unit w of stage i
    // of part p at unit kBlockUnits·(p·max_st + i) + w + w / 16
    const int per_part = nl * kStageUnits;
    const int per_tok = kParts * per_part;
    auto x_src = [&](int e, uint32_t& dst) {
      const int t = e / per_tok;
      const int r = e - t * per_tok;
      const int p = r / per_part;
      const int i = (r - p * per_part) / kStageUnits;
      const int u = r & (kStageUnits - 1);
      dst = xs + (t * pitch + kBlockUnits * (p * max_st + i) + u + (u >> 4)) *
                     8;
      return x + (size_t)t * in_p + (size_t)p * L +
             (size_t)(st0 + i) * ring::kStage + 4 * u;
    };
    if constexpr (std::is_same_v<XT, float>) {
      for (int e0 = threadIdx.x; e0 < tt * per_tok;
           e0 += kXBatch * kCThreads) {
        float4 v[kXBatch];
        uint32_t dst[kXBatch];
#pragma unroll
        for (int q = 0; q < kXBatch; ++q) {
          const int e = e0 + q * kCThreads;
          if (e < tt * per_tok)
            v[q] = *reinterpret_cast<const float4*>(x_src(e, dst[q]));
        }
        release();
#pragma unroll
        for (int q = 0; q < kXBatch; ++q)
          if (e0 + q * kCThreads < tt * per_tok) store_x(dst[q], v[q]);
      }
    } else {
      for (int e = threadIdx.x; e < tt * per_tok; e += kCThreads) {
        uint32_t dst;
        const XT* src = x_src(e, dst);
        ring::cp_async8(dst, src);
      }
    }
    // the scales of the block's rows, in batches of 16 a thread; group g
    // of the range in part p is scale row p·L/128 + kGS·(ga + g)
    constexpr int kBatch = 16;
    const int n_s = (gb - ga) * kParts * kRows;
    for (int e0 = threadIdx.x; e0 < n_s; e0 += kBatch * kCThreads) {
      __nv_bfloat16 v[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int e = e0 + q * kCThreads;
        const int row = e % kRows;
        const int p = (e / kRows) % kParts;
        const int g = ga + e / (kRows * kParts);
        const size_t srow = (size_t)p * (L / ring::kStage) + kGS * g;
        v[q] = e < n_s && n0 + row < out ? s[srow * out + n0 + row]
                                         : __float2bfloat16_rn(0.f);
        if constexpr (P::kLowScale != 1.f)
          if (p == 0)
            v[q] = __float2bfloat16_rn(__bfloat162float(v[q]) *
                                       P::kLowScale);
      }
      release();
#pragma unroll
      for (int q = 0; q < kBatch; ++q)
        if (e0 + q * kCThreads < n_s) ss[e0 + q * kCThreads] = v[q];
    }
    release();
    asm volatile("cp.async.wait_all;" ::: "memory");
    asm volatile("bar.sync 1, %0;" ::"n"(kCThreads) : "memory");
    RG_STAMP_IF(true, 1);

    const int gid = lane >> 2;
    const int tig = lane & 3;
    const int r0 = warp * 16 + gid;
    // the x row of each token tile's column gid, at this thread's unit 8·tig
    // of every stage; a column past the tile's tokens loads nothing and
    // keeps zeros (it is never stored)
    uint32_t xb[NT];
    bool live[NT];
    uint2 bx[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int tok = min(8 * j + gid, tt - 1);
      live[j] = 8 * j + gid < tt;
      xb[j] = xs + (tok * pitch + 8 * tig + (tig >> 1)) * 8;
      bx[j] = make_uint2(0u, 0u);
    }
    const uint32_t part_step = kBlockUnits * max_st * 8;  // part 0 to 1
    float acc[kParts][NT][4];
#pragma unroll
    for (int p = 0; p < kParts; ++p)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][j][e] = 0.f;

    for (int i = 0; i < nl; ++i) {
      const int slot = i % ring::kRing;
      ring::bar_wait(full + 8 * slot, (i / ring::kRing) & 1);
      RG_STAMP_IF(i == 0, 2);
      // chunks 2·tig and 2·tig + 1 of rows r0 and r0 + 8; then the slot is
      // free
      uint4 w0[2], w1[2];
      const uint32_t base = ring_u32 + slot * Frame::kSlot + r0 * ring::kStage;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = ring::wswz(2 * tig + h, r0);
        w0[h] = ring::lds128(base + (c << 4));
        w1[h] = ring::lds128(base + 8 * ring::kStage + (c << 4));
      }
      __syncwarp();
      if (lane == 0) ring::bar_arrive(empty + 8 * slot);

      const uint32_t xi = kBlockUnits * 8 * i;  // stage i's units
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          // word u of rows r0 (a) and r0 + 8 (b): positions q .. q + 3
          const uint32_t wa = word(w0[h], u), wb = word(w1[h], u);
          float lo[2][4], hi[2][4];  // [row r0 / r0 + 8][byte]
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            P::levels(wa, k, lo[0][k], hi[0][k]);
            P::levels(wb, k, lo[1][k], hi[1][k]);
          }
          const uint32_t af[kParts][4] = {
              {pair(lo[0][0], lo[0][1]), pair(lo[1][0], lo[1][1]),
               pair(lo[0][2], lo[0][3]), pair(lo[1][2], lo[1][3])},
              {pair(hi[0][0], hi[0][1]), pair(hi[1][0], hi[1][1]),
               pair(hi[0][2], hi[0][3]), pair(hi[1][2], hi[1][3])}};
#pragma unroll
          for (int p = 0; p < kParts; ++p)
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              if (live[j])
                bx[j] = ring::lds64(xb[j] + xi + p * part_step +
                                    (4 * h + u) * 8);
              const uint32_t bf[2] = {bx[j].x, bx[j].y};
              ring::mma_bf16(acc[p][j], af[p], bf);
            }
        }
      if (i % kGS == kGS - 1) {
        // the group is whole in both parts: fold each with its scale
        const __nv_bfloat16* sp = ss + i / kGS * kParts * kRows;
#pragma unroll
        for (int p = 0; p < kParts; ++p) {
          const float s0 = __bfloat162float(sp[p * kRows + r0]);
          const float s1 = __bfloat162float(sp[p * kRows + r0 + 8]);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            tot[j][0] += acc[p][j][0] * s0;
            tot[j][1] += acc[p][j][1] * s0;
            tot[j][2] += acc[p][j][2] * s1;
            tot[j][3] += acc[p][j][3] * s1;
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[p][j][e] = 0.f;
          }
        }
      }
    }
    RG_STAMP_IF(true, 3);
  }
  ring::finish<kRows, kConsumers, NT, OutT>(producer, tot, rx, y, tt, out,
                                            n0, split);
  RG_STAMP_IF(true, 4);
}

template <class P, typename XT, int G, int NT, typename OutT>
cudaError_t launch_n(const void* x, const void* wq, const void* scales,
                     void* y, int T, int out, int in_p, int split,
                     cudaStream_t stream) {
  using Frame = FrameOf<NT>;
  constexpr int kGS = G / ring::kStage;
  const int n = in_p / kParts / G;
  const int tile = 8 * NT;
  static std::atomic<uint64_t> done{0};
  return ring::launch(
      ring_gemv<P, XT, G, NT, OutT>, done, split,
      (out + Frame::kRows - 1) / Frame::kRows, (T + tile - 1) / tile,
      Frame::kThreads,
      smem_bytes<Frame>(T < tile ? T : tile, (n + split - 1) / split, kGS),
      stream, static_cast<const XT*>(x), static_cast<const uint8_t*>(wq),
      static_cast<const __nv_bfloat16*>(scales), static_cast<OutT*>(y), T,
      out, in_p);
}

template <class P, typename XT, int G>
int launch(const void* x, const void* wq, const void* scales, void* y, int T,
           int out, int in_p, int split, int tile, int out_dtype,
           cudaStream_t stream) {
  if (in_p % (kParts * G) || !ring::split_ok(split, in_p / kParts / G))
    return (int)cudaErrorInvalidValue;
  return lowbit::with_out_type(out_dtype, [&](auto* tag) {
    using OutT = std::remove_pointer_t<decltype(tag)>;
    return tile == 8 ? launch_n<P, XT, G, 1, OutT>(x, wq, scales, y, T, out,
                                                   in_p, split, stream)
                     : launch_n<P, XT, G, 2, OutT>(x, wq, scales, y, T, out,
                                                   in_p, split, stream);
  });
}

}  // namespace unpack

// Returns the CUDA error of the launch (0 on success). Requires
// in_p % 256 == 0 (g256: % 512), T >= 1, split 1, 2, 4 or 8 and at most
// the groups of a part (in_p / 256; g256: in_p / 512), tile 8 or 16
// tokens a block (ops/w4_probe_matmul.py probe_plan), 16-byte aligned x
// and wq, all tensors contiguous on the current device; mode as
// unpack::Mode; out_dtype 0 = bf16, 1 = f32.
extern "C" int vptq_w4_probe_matmul(const void* x, const void* wq,
                                    const void* scales, void* y, int T,
                                    int out, int in_p, int mode, int split,
                                    int tile, int out_dtype, void* stream) {
  using namespace unpack;
  if (in_p < 256 || T < 1 || out < 1 || (tile != 8 && tile != 16))
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  switch (mode) {
    case kProd:
      return launch<Prod, bf16, 128>(x, wq, scales, y, T, out, in_p, split,
                                     tile, out_dtype, st);
    case kShift28:
      return launch<Shift28, bf16, 128>(x, wq, scales, y, T, out, in_p,
                                        split, tile, out_dtype, st);
    case kFma16:
      return launch<Fma16, bf16, 128>(x, wq, scales, y, T, out, in_p, split,
                                      tile, out_dtype, st);
    case kFma16F32:
      return launch<Fma16, float, 128>(x, wq, scales, y, T, out, in_p, split,
                                       tile, out_dtype, st);
    case kT8:
      return launch<Prod, float, 128>(x, wq, scales, y, T, out, in_p, split,
                                      tile, out_dtype, st);
    case kG256:
      return launch<Prod, bf16, 256>(x, wq, scales, y, T, out, in_p, split,
                                     tile, out_dtype, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
