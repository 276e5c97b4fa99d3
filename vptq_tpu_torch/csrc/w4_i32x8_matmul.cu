// The int4 unpack probe P1c on Hopper (sm_90a): eight unsigned nibble
// planes per int32 word.
//
// Replaces examples/w4_wall_candidates.py:_i32x8_kernel (entry run_variant,
// mode "i32x8").
//
//   x      (T, in)         bf16
//   wq     (out, in / 8)   int32; word m of a row lies in superblock
//                          m / 128 of 1024 natural columns, and its bits
//                          4p … 4p+3 hold the level of natural column
//                          1024·(m / 128) + 128·p + m % 128, as 0 … 15
//                          (no +8 correction: a probe of the unpack)
//   scales (in / 128, out) bf16, one per (128-column group, row); plane p
//                          of superblock u is group 8u + p
//   y      (T, out)        bf16 / f32
//
// y[t, o] = Σ_c x[t, c] · level(o, c) · scales[c / 128, o], x rounded to
// bf16, the products of each (row, group) summed in f32 and that partial
// multiplied by the group's scale, the scaled partials summed in f32.
//
// What bounds it on an H100: at decode the weight bytes (half a byte per
// weight, as K2: 45 MB at the 22016 x 4096 gate_up, 13.5 µs at 3.35 TB/s).
// Design: decode_gemv.cuh's, on ring_gemv.cuh's frame (a kernel of its own:
// neither its x nor its groups are the split-half layout's):
//  * The words stream through the asynchronous ring: 32 rows a block up to
//    8 tokens, 64 past them; stages of 128 bytes (32 words) of a row; a
//    cluster splits a row's superblocks (4 stages each, so that no range
//    cuts a group).
//  * x and the scales of the block's rows and superblocks are staged once
//    a block. A thread reads 16-byte chunks 2·tig and 2·tig + 1 of rows r0
//    and r0 + 8 of each stage: words 4q .. 4q + 3 of chunk q.
//  * The unpack straight into bf16 pairs, the magic-number idiom: one prmt
//    puts the low (or high) 16 bits of two words a, b into the two halves
//    of a word (planes 0-3, or 4-7, of each), a shift and one lop3 put
//    plane p's nibble of each under a bf16 exponent (128 + level), and one
//    fma.rn.bf16x2 takes the 128 away: levels 0 … 15 exact, a pair of
//    neighbouring columns of one plane.
//  * mma.sync m16n8k16 bf16 -> f32 with 16 rows as M and the tokens as N:
//    step p of a chunk is plane p, its slots 2·tig, +1 words 4q, 4q + 1
//    and slots 2·tig + 8, +9 words 4q + 2, 4q + 3, i.e. columns
//    128p + 32·(stage % 4) + 4q .. + 3 of the superblock: one 8-byte read
//    of x. Each plane (group) sums into its own acc over the superblock's
//    four stages; then each is folded into the totals with its scale.

#include "ring_gemv.cuh"

namespace i32x8 {

// 32 rows a block up to 8 tokens (NT = 1), 64 past them, as decode_gemv.cuh
// (fewer blocks stage x fewer times)
template <int NT>
using FrameOf = ring::Frame<NT == 1 ? 2 : 4>;
constexpr int kPlanes = 8;
constexpr int kUnitStages = 4;   // stages of a superblock (512 bytes)
constexpr int kUnitCols = 1024;  // its columns
constexpr int kUnitX = kUnitCols / 4;  // its 8-byte units of x (a token)

// The unpack, read by tests/test_torch_i32x8_codes.py.
constexpr uint32_t kSelLo = 0x5410u;  // bytes 0, 1 of a, then of b
constexpr uint32_t kSelHi = 0x7632u;  // bytes 2, 3 of a, then of b
constexpr uint32_t kNibbles = 0x000F000Fu;
constexpr uint32_t kBase = 0x43004300u;  // 128.0 in both bf16 halves
constexpr uint32_t kOne = 0x3F803F80u;   // 1.0
constexpr uint32_t kBias = 0xC300C300u;  // -128.0

// planes 0-3 (lo) or 4-7 (hi) of words a and b, a's in the low half
__device__ __forceinline__ uint32_t spread_lo(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, kSelLo);
}
__device__ __forceinline__ uint32_t spread_hi(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, kSelHi);
}
// plane p's levels of a spread word as a bf16 pair
__device__ __forceinline__ uint32_t level_pair(uint32_t t, int p) {
  return lowbit::tile::bf16x2_fma(((t >> (4 * (p & 3))) & kNibbles) | kBase,
                                  kOne, kBias);
}

// x unit u (columns 4u .. 4u + 3) of token t lies at unit xswz(u, t): a
// half warp's 8-byte B reads (units 2·tig + h of 4 tokens) then fall in 16
// distinct bank pairs
__device__ __forceinline__ int xswz(int u, int t) {
  return u ^ ((t & 1) | ((t & 2) << 2));
}

// the bytes of dynamic shared memory a block takes: the ring, x (tokens
// rows of `units` superblocks), the scales and the ranks' partials
template <class Frame>
inline size_t smem_bytes(int tokens, int units) {
  return (size_t)Frame::kHead + (size_t)tokens * units * kUnitCols * 2 +
         (size_t)units * kPlanes * Frame::kRows * 2 +
         (size_t)Frame::kRows * tokens * 4;
}

template <int NT>
constexpr int kMinBlocks = NT == 1 ? 5 : 2;

template <int NT, typename OutT>
__global__ void __launch_bounds__(FrameOf<NT>::kThreads, kMinBlocks<NT>)
    ring_gemv(const __nv_bfloat16* __restrict__ x,
              const uint32_t* __restrict__ w,
              const __nv_bfloat16* __restrict__ s, OutT* __restrict__ y,
              int T, int out, int in) {
  using Frame = FrameOf<NT>;
  constexpr int kConsumers = Frame::kConsumers;
  constexpr int kRows = Frame::kRows;
  constexpr int kCThreads = 32 * kConsumers;
  const int n = in / kUnitCols;  // superblocks of a row
  const int split = (int)gridDim.x;
  const int rank = (int)cooperative_groups::this_cluster().block_rank();
  const int max_units = (n + split - 1) / split;
  int a, b;
  ring::range_of(rank, split, n, a, b);
  const int nu = b - a;
  const int n0 = blockIdx.y * kRows;
  const int rows = min(kRows, out - n0);
  const int t0 = blockIdx.z * 8 * NT;
  const int tt = min(T - t0, 8 * NT);
  x += (size_t)t0 * in;
  y += (size_t)t0 * out;

  extern __shared__ __align__(16) unsigned char i8_smem[];
  unsigned char* sm =
      i8_smem + ((128 - (ring::smem_u32(i8_smem) & 127)) & 127);
  const uint32_t full = ring::smem_u32(sm), empty = full + 8 * ring::kRing;
  const uint32_t ring_u32 = full + ring::kBars;
  const uint32_t xs = ring_u32 + ring::kRing * Frame::kSlot;
  const int pitch = max_units * kUnitCols * 2;  // bytes of an x row
  // the scales: [group of the range][row]
  __nv_bfloat16* ss =
      reinterpret_cast<__nv_bfloat16*>(sm + (xs - full) + tt * pitch);
  float* rx = reinterpret_cast<float*>(ss + max_units * kPlanes * kRows);

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
    const int row_bytes = in / 2;
    ring::produce<Frame>(reinterpret_cast<const uint8_t*>(w),
                         (size_t)row_bytes, row_bytes / 16, n0, rows,
                         a * kUnitStages, nu * kUnitStages, ring_u32, full,
                         empty);
  } else {
    // x: tt rows of nu superblocks of 8-byte units at their swizzled places
    const int units = nu * kUnitX;
    for (int e = threadIdx.x; e < tt * units; e += kCThreads) {
      const int t = e / units;
      const int u = e - t * units;
      ring::cp_async8(xs + t * pitch + xswz(u, t) * 8,
                      x + (size_t)t * in + (size_t)a * kUnitCols + 4 * u);
    }
    // the scales of the block's rows, [group][row], in batches of 16 a
    // thread; the producer may start once the first batch is out
    constexpr int kBatch = 16;
    const int n_s = nu * kPlanes * kRows;
    bool went = false;
    for (int e0 = threadIdx.x; e0 < n_s; e0 += kBatch * kCThreads) {
      __nv_bfloat16 v[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int e = e0 + q * kCThreads;
        const int row = e % kRows;
        const int g = a * kPlanes + e / kRows;
        v[q] = e < n_s && n0 + row < out ? s[(size_t)g * out + n0 + row]
                                         : __float2bfloat16_rn(0.f);
      }
      if (!went)
        asm volatile("barrier.cta.arrive 2, %0;" ::"n"(Frame::kThreads)
                     : "memory");
      went = true;
#pragma unroll
      for (int q = 0; q < kBatch; ++q)
        if (e0 + q * kCThreads < n_s) ss[e0 + q * kCThreads] = v[q];
    }
    if (!went)
      asm volatile("barrier.cta.arrive 2, %0;" ::"n"(Frame::kThreads)
                   : "memory");
    asm volatile("cp.async.wait_all;" ::: "memory");
    asm volatile("bar.sync 1, %0;" ::"n"(kCThreads) : "memory");

    const int gid = lane >> 2;
    const int tig = lane & 3;
    const int r0 = warp * 16 + gid;
    // the x row of each token tile's column gid; a column past the tile's
    // tokens loads nothing and keeps zeros (it is never stored)
    int tok[NT];
    uint32_t xrow[NT];
    bool live[NT];
    uint2 bx[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      tok[j] = min(8 * j + gid, tt - 1);
      live[j] = 8 * j + gid < tt;
      xrow[j] = xs + tok[j] * pitch;
      bx[j] = make_uint2(0u, 0u);
    }
    float acc[kPlanes][NT][4];
#pragma unroll
    for (int p = 0; p < kPlanes; ++p)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][j][e] = 0.f;

    const int nl = nu * kUnitStages;  // stages of the range
    for (int i = 0; i < nl; ++i) {
      const int slot = i % ring::kRing;
      const int su = i % kUnitStages;  // stage of its superblock
      ring::bar_wait(full + 8 * slot, (i / ring::kRing) & 1);
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

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // [row r0 / r0 + 8][words 0, 1 / 2, 3]
        const uint32_t lo[2][2] = {
            {spread_lo(w0[h].x, w0[h].y), spread_lo(w0[h].z, w0[h].w)},
            {spread_lo(w1[h].x, w1[h].y), spread_lo(w1[h].z, w1[h].w)}};
        const uint32_t hi[2][2] = {
            {spread_hi(w0[h].x, w0[h].y), spread_hi(w0[h].z, w0[h].w)},
            {spread_hi(w1[h].x, w1[h].y), spread_hi(w1[h].z, w1[h].w)}};
        // x unit of chunk 2·tig + h of plane 0 in this superblock; plane
        // p's is 32·p units on (the swizzle keeps bits 0-4's place)
        const int u0 = (i / kUnitStages) * kUnitX + 8 * su + 2 * tig + h;
        uint32_t xb[NT];
#pragma unroll
        for (int j = 0; j < NT; ++j) xb[j] = xrow[j] + xswz(u0, tok[j]) * 8;
#pragma unroll
        for (int p = 0; p < kPlanes; ++p) {
          const uint32_t(&t)[2][2] = p < 4 ? lo : hi;
          const uint32_t af[4] = {level_pair(t[0][0], p),
                                  level_pair(t[1][0], p),
                                  level_pair(t[0][1], p),
                                  level_pair(t[1][1], p)};
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            if (live[j]) bx[j] = ring::lds64(xb[j] + 32 * 8 * p);
            const uint32_t bf[2] = {bx[j].x, bx[j].y};
            ring::mma_bf16(acc[p][j], af, bf);
          }
        }
      }
      if (su == kUnitStages - 1) {
        // the superblock's eight groups are whole: fold each with its scale
        const __nv_bfloat16* sp = ss + (i / kUnitStages) * kPlanes * kRows;
#pragma unroll
        for (int p = 0; p < kPlanes; ++p) {
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
  }
  ring::finish<kRows, kConsumers, NT, OutT>(producer, tot, rx, y, tt, out,
                                            n0, split);
}

template <int NT, typename OutT>
cudaError_t launch_n(const void* x, const void* wq, const void* scales,
                     void* y, int T, int out, int in, int split,
                     cudaStream_t stream) {
  using Frame = FrameOf<NT>;
  const int n = in / kUnitCols;
  const int tile = 8 * NT;
  static std::atomic<uint64_t> done{0};
  return ring::launch(
      ring_gemv<NT, OutT>, done, split, (out + Frame::kRows - 1) / Frame::kRows,
      (T + tile - 1) / tile, Frame::kThreads,
      smem_bytes<Frame>(T < tile ? T : tile, (n + split - 1) / split), stream,
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(wq),
      static_cast<const __nv_bfloat16*>(scales), static_cast<OutT*>(y), T,
      out, in);
}

template <typename OutT>
cudaError_t launch(const void* x, const void* wq, const void* scales, void* y,
                   int T, int out, int in, int split, int tile,
                   cudaStream_t stream) {
  return tile == 8 ? launch_n<1, OutT>(x, wq, scales, y, T, out, in, split,
                                       stream)
                   : launch_n<2, OutT>(x, wq, scales, y, T, out, in, split,
                                       stream);
}

}  // namespace i32x8

// Returns the CUDA error of the launch (0 on success). Requires
// in % 1024 == 0, T >= 1, split 1, 2, 4 or 8 and at most in / 1024, tile 8
// or 16 tokens a block (ops/w4_i32x8_matmul.py i32x8_plan), 16-byte aligned
// x and wq, all tensors contiguous on the current device; out_dtype 0 =
// bf16, 1 = f32.
extern "C" int vptq_w4_i32x8_matmul(const void* x, const void* wq,
                                    const void* scales, void* y, int T,
                                    int out, int in, int split, int tile,
                                    int out_dtype, void* stream) {
  if (in < 1024 || in % 1024 || T < 1 || out < 1 ||
      (tile != 8 && tile != 16) || !ring::split_ok(split, in / 1024))
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0:
      return (int)i32x8::launch<__nv_bfloat16>(x, wq, scales, y, T, out, in,
                                               split, tile, st);
    case 1:
      return (int)i32x8::launch<float>(x, wq, scales, y, T, out, in, split,
                                       tile, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
