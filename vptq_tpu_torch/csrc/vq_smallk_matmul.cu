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
// 3.35 TB/s; 6.7 µs at v = 4), and, in the fused mode, the shared memory
// that the codebook rows are read from: 16 bytes an id at v = 8 and 8 at
// v = 4, 180 MB a call at gate_up either way, ~6 µs at 128 bytes a clock an
// SM. The TPU kernel selects each vector with a one-hot product on its
// matrix unit; here there is no one-hot. Design (ring_gemv.cuh's frame):
//  * The ids stream through the asynchronous ring: 64 rows a block, stages
//    of 128 ids a row; a cluster splits a row's stages where the row
//    blocks alone make fewer than two blocks an SM.
//  * The products run on tensor cores: mma.sync m16n8k16 bf16 -> f32, 16
//    rows as M, the tokens as N. The 16 k-slots of a step are permuted
//    (Map below) so that a thread's four slots of a row (2·tig, +1, +8, +9)
//    are one whole v = 4 vector, or one half of a v = 8 vector: one 8-byte
//    shared read of the codebook is two A registers, with no convert, and
//    the four slots' x are four neighbouring positions, one 8-byte read.
//  * The codebook is staged once a block as a table of 256 rows of 128
//    bytes, the vector repeated across the row (16 copies at v = 4, 8 at
//    v = 8) and rows past k zero, so that an id >= k reads zeros. Lane l
//    reads its copy at byte 8·(l & 15): the 16 lanes of a half warp read
//    16 distinct 8-byte bank pairs whatever their ids, with no conflict.
//  * A thread holds a 16-byte chunk of ids of each of its rows, one id a
//    step (a prmt makes it an offset into the table; onehot: one 4-id
//    word a step).
//  * x is staged once a block as 8-byte units of four positions (onehot:
//    the first position of four ids), with spare units after each chunk's
//    and a skew of each token's row (Map), so that a half warp's B reads
//    fall in 16 distinct bank pairs and each step's read is an immediate
//    offset from its chunk's. Positions past in read zeros.
//  * Each block stages its table and x before its loop: the codebook with
//    one 16-byte (v = 4: 8-byte) load a centroid, x with 8-byte cp.async.
//  * onehot_only runs the same ring: each step's A is the compare of four
//    ids against k (__vcmpltu4) spread into bf16 ones by prmt.

#include "ring_gemv.cuh"

namespace vq_smallk {

using Frame = ring::Frame<4>;  // 64 rows a block
constexpr int kTableRow = 128;  // bytes of one centroid's row in the table
constexpr int kCentroids = 256;
constexpr uint32_t kOnes = 0x3F803F80u;  // 1.0 in both bf16 halves

// The k-slot map of a mode. A stage is 128 ids of a row, 8 chunks of 16
// ids: a thread takes kChunks of them of each of its rows (chunk(tig, h),
// h < kChunks) and runs kSteps steps a chunk.
//  v = 4: four id lanes (tig); step s takes byte s of the chunk: slots
//    2·tig, +1, +8, +9 are positions 0-3 of that id's vector.
//  v = 8: two id lanes (tig >> 1), each id split over two threads: slots
//    2·tig, +1, +8, +9 are positions 4·(tig & 1) .. + 3 of the id's vector.
//  onehot: four id lanes; step s takes word s of the chunk (four ids):
//    slots 2·tig, +1, +8, +9 are its bytes 0-3.
// x is staged as 8-byte units (fused: positions 4u .. 4u + 3; onehot: the
// first position of ids 4u .. 4u + 3), kChunkUnits a chunk; a thread's
// unit of step s in chunk c is c·kChunkUnits + s·kStepUnits +
// lane_unit(tig). Each chunk's units are followed by kPad spare ones and a
// token's row starts kTokenSkew units past a multiple of 16, so that the
// 16 lanes of a half warp (tig 0-3, tokens gid 0-3) read 16 distinct
// 8-byte bank pairs at every step, with the step's offset an immediate.
constexpr int kPad = 2;

template <int V, bool kOnehot>
struct Map;

template <>
struct Map<4, false> {
  static constexpr int kChunks = 2;
  static constexpr int kSteps = 16;
  static constexpr int kChunkUnits = 16;
  static constexpr int kStepUnits = 1;
  static constexpr int kTokenSkew = 1;
  static __device__ int chunk(int tig, int h) { return 2 * tig + h; }
  static __device__ int lane_unit(int tig) { return 0; }
};

template <>
struct Map<8, false> {
  static constexpr int kChunks = 4;
  static constexpr int kSteps = 16;
  static constexpr int kChunkUnits = 32;
  static constexpr int kStepUnits = 2;
  static constexpr int kTokenSkew = 2;
  static __device__ int chunk(int tig, int h) { return 4 * (tig >> 1) + h; }
  static __device__ int lane_unit(int tig) { return tig & 1; }
};

template <int V>
struct Map<V, true> {
  static constexpr int kChunks = 2;
  static constexpr int kSteps = 4;
  static constexpr int kChunkUnits = 4;
  static constexpr int kStepUnits = 1;
  static constexpr int kTokenSkew = 1;
  static __device__ int chunk(int tig, int h) { return 2 * tig + h; }
  static __device__ int lane_unit(int tig) { return 0; }
};

// the units of a stage and of a token's x row of `stages` stages, spare
// units included
template <class M>
constexpr int kStageUnits = 8 * (M::kChunkUnits + kPad);
template <class M>
__host__ __device__ inline int pitch_units(int stages) {
  return (stages * kStageUnits<M> + 15) / 16 * 16 + M::kTokenSkew;
}

// byte offset of lane l's copy in a table row
__device__ __forceinline__ int table_lane(int lane) { return 8 * (lane & 15); }

// the A pairs of four ids (bytes of q) against k: 1.0 where id < k, else 0;
// lo: bytes 0, 1, hi: bytes 2, 3
__device__ __forceinline__ uint32_t hits(uint32_t q, int k) {
  return k >= kCentroids ? 0xFFFFFFFFu : __vcmpltu4(q, (uint32_t)k * 0x01010101u);
}
__device__ __forceinline__ uint32_t hit_lo(uint32_t m) {
  return __byte_perm(m, 0u, 0x1100u) & kOnes;
}
__device__ __forceinline__ uint32_t hit_hi(uint32_t m) {
  return __byte_perm(m, 0u, 0x3322u) & kOnes;
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// the bytes of dynamic shared memory a block takes: the ring, the table
// (fused), x (tokens rows of stages stages) and the ranks' partials
template <int V, bool kOnehot>
inline size_t smem_bytes(int tokens, int stages) {
  return (size_t)Frame::kHead +
         (kOnehot ? 0 : (size_t)kCentroids * kTableRow) +
         (size_t)tokens * pitch_units<Map<V, kOnehot>>(stages) * 8 +
         (size_t)Frame::kRows * tokens * 4;
}

// The blocks an SM the registers must allow.
template <int NT>
constexpr int kMinBlocks = NT == 1 ? 3 : 2;

template <int V, bool kOnehot, int NT, typename OutT>
__global__ void __launch_bounds__(Frame::kThreads, kMinBlocks<NT>)
    ring_gemv(const __nv_bfloat16* __restrict__ x,
              const uint8_t* __restrict__ ids,
              const __nv_bfloat16* __restrict__ cb, int k,
              OutT* __restrict__ y, int T, int out, int in) {
  using M = Map<V, kOnehot>;
  constexpr int kConsumers = Frame::kConsumers;
  constexpr int kRows = Frame::kRows;
  constexpr int kCThreads = 32 * kConsumers;
  const int n_ids = in / V;  // bytes of a row of ids
  const int n = (n_ids + ring::kStage - 1) / ring::kStage;  // its stages
  const int split = (int)gridDim.x;
  const int rank = (int)cooperative_groups::this_cluster().block_rank();
  const int max_stages = (n + split - 1) / split;
  int a, b;
  ring::range_of(rank, split, n, a, b);
  const int nl = b - a;
  const int n0 = blockIdx.y * kRows;
  const int rows = min(kRows, out - n0);
  const int t0 = blockIdx.z * 8 * NT;
  const int tt = min(T - t0, 8 * NT);  // tokens of this tile
  x += (size_t)t0 * in;
  y += (size_t)t0 * out;

  extern __shared__ __align__(16) unsigned char vq_smem[];
  unsigned char* sm =
      vq_smem + ((128 - (ring::smem_u32(vq_smem) & 127)) & 127);
  const uint32_t full = ring::smem_u32(sm), empty = full + 8 * ring::kRing;
  const uint32_t ring_u32 = full + ring::kBars;
  const uint32_t tbl = ring_u32 + ring::kRing * Frame::kSlot;
  const uint32_t xs =
      tbl + (kOnehot ? 0 : kCentroids * kTableRow);
  const int pitch = pitch_units<M>(max_stages) * 8;  // bytes of an x row
  float* rx = reinterpret_cast<float*>(sm + (xs - full) + tt * pitch);

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
    // once the consumers' loads of the codebook and x are out
    asm volatile("bar.sync 2, %0;" ::"n"(Frame::kThreads) : "memory");
    ring::produce<Frame>(ids, (size_t)n_ids, n_ids / 16, n0, rows, a, nl,
                         ring_u32, full, empty);
  } else {
    // x: tt rows of nl stages of 8-byte units, each chunk's followed by its
    // spare units
    const int units = nl * 8 * M::kChunkUnits;
    for (int e = threadIdx.x; e < tt * units; e += kCThreads) {
      const int t = e / units;
      const int u = e - t * units;
      const uint32_t dst =
          xs + t * pitch +
          (u / M::kChunkUnits * (M::kChunkUnits + kPad) + u % M::kChunkUnits) *
              8;
      if constexpr (kOnehot) {
        // the first position of each of four ids
        const int id0 = a * ring::kStage + 4 * u;
        uint32_t h[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          h[i] = id0 + i < n_ids
                     ? (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(
                           x + (size_t)t * in + (size_t)(id0 + i) * V))
                     : 0u;
        asm volatile("st.shared.v2.u32 [%0], {%1, %2};" ::"r"(dst),
                     "r"(h[0] | (h[1] << 16)), "r"(h[2] | (h[3] << 16))
                     : "memory");
      } else {
        const int pos = a * ring::kStage * V + 4 * u;
        if (pos < in)
          ring::cp_async8(dst, x + (size_t)t * in + pos);
        else
          asm volatile("st.shared.v2.u32 [%0], {%1, %1};" ::"r"(dst), "r"(0u)
                       : "memory");
      }
    }
    if constexpr (!kOnehot) {
      // the table: thread i loads centroids i and i + 128 (zero past k),
      // then writes each row's 8 chunks, chunk q + lane of the row at its
      // q-th store, so that a quarter warp's 8 rows go to 8 bank groups
      static_assert(kCThreads * 2 == kCentroids, "two centroids a thread");
      uint32_t c[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = threadIdx.x + r * kCThreads;
        if (i >= k) {
          c[r][0] = c[r][1] = c[r][2] = c[r][3] = 0u;
        } else if constexpr (V == 8) {
          const uint4 q = __ldg(reinterpret_cast<const uint4*>(cb) + i);
          c[r][0] = q.x, c[r][1] = q.y, c[r][2] = q.z, c[r][3] = q.w;
        } else {
          const uint2 q = __ldg(reinterpret_cast<const uint2*>(cb) + i);
          c[r][0] = c[r][2] = q.x, c[r][1] = c[r][3] = q.y;
        }
      }
      asm volatile("barrier.cta.arrive 2, %0;" ::"n"(Frame::kThreads)
                   : "memory");
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t row = tbl + (threadIdx.x + r * kCThreads) * kTableRow;
        // v = 8: the vector; v = 4: the vector twice
        const uint4 q = make_uint4(c[r][0], c[r][1], c[r][2], c[r][3]);
#pragma unroll
        for (int q16 = 0; q16 < kTableRow / 16; ++q16)
          asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(
                           row + 16 * ((q16 + lane) & 7)),
                       "r"(q.x), "r"(q.y), "r"(q.z), "r"(q.w)
                       : "memory");
      }
    } else {
      asm volatile("barrier.cta.arrive 2, %0;" ::"n"(Frame::kThreads)
                   : "memory");
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    asm volatile("bar.sync 1, %0;" ::"n"(kCThreads) : "memory");

    const int gid = lane >> 2;
    const int tig = lane & 3;
    const int r0 = warp * 16 + gid;  // rows r0 and r0 + 8 of the block
    // the x row of each token tile's column gid; a column past the tile's
    // tokens loads nothing and keeps zeros (it is never stored)
    uint32_t xrow[NT];
    bool live[NT];
    uint2 bx[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      live[j] = 8 * j + gid < tt;
      xrow[j] = xs + min(8 * j + gid, tt - 1) * pitch + M::lane_unit(tig) * 8;
      bx[j] = make_uint2(0u, 0u);
    }
    const uint32_t tlane = tbl + table_lane(lane);
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    for (int i = 0; i < nl; ++i) {
      const int slot = i % ring::kRing;
      ring::bar_wait(full + 8 * slot, (i / ring::kRing) & 1);
      const uint32_t base = ring_u32 + slot * Frame::kSlot + r0 * ring::kStage;
#pragma unroll
      for (int h = 0; h < M::kChunks; ++h) {
        // this thread's chunk h of rows r0 and r0 + 8, one chunk's ids live
        // at a time; after the last chunk's loads the slot is free
        const int c = M::chunk(tig, h);
        const uint4 w0 = ring::lds128(base + (ring::wswz(c, r0) << 4));
        const uint4 w1 =
            ring::lds128(base + 8 * ring::kStage + (ring::wswz(c, r0) << 4));
        if (h == M::kChunks - 1) {
          __syncwarp();
          if (lane == 0) ring::bar_arrive(empty + 8 * slot);
        }
        // the chunk's x units; a step's is an immediate offset from it
        const int xu = i * kStageUnits<M> + c * (M::kChunkUnits + kPad);
#pragma unroll
        for (int s = 0; s < M::kSteps; ++s) {
          uint32_t af[4];
          if constexpr (kOnehot) {
            const uint32_t m0 = hits(word_of(w0, s), k);
            const uint32_t m1 = hits(word_of(w1, s), k);
            af[0] = hit_lo(m0);
            af[1] = hit_lo(m1);
            af[2] = hit_hi(m0);
            af[3] = hit_hi(m1);
          } else {
            // byte s of the chunk, zero-extended, is the id
            const uint32_t id0 = __byte_perm(word_of(w0, s >> 2), 0u, 0x4440u | (s & 3));
            const uint32_t id1 = __byte_perm(word_of(w1, s >> 2), 0u, 0x4440u | (s & 3));
            const uint2 p0 = ring::lds64(tlane + id0 * kTableRow);
            const uint2 p1 = ring::lds64(tlane + id1 * kTableRow);
            af[0] = p0.x;
            af[1] = p1.x;
            af[2] = p0.y;
            af[3] = p1.y;
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            if (live[j])
              bx[j] = ring::lds64(xrow[j] + (xu + s * M::kStepUnits) * 8);
            const uint32_t bf[2] = {bx[j].x, bx[j].y};
            ring::mma_bf16(acc[j], af, bf);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[j][e] = acc[j][e];
  }
  ring::finish<kRows, kConsumers, NT, OutT>(producer, tot, rx, y, tt, out,
                                            n0, split);
}

template <int V, bool kOnehot, int NT, typename OutT>
cudaError_t launch_n(const void* x, const void* ids, const void* cb, int k,
                     void* y, int T, int out, int in, int split,
                     cudaStream_t stream) {
  const int n = (in / V + ring::kStage - 1) / ring::kStage;
  const int tile = 8 * NT;
  const size_t smem =
      smem_bytes<V, kOnehot>(T < tile ? T : tile, (n + split - 1) / split);
  static std::atomic<uint64_t> done{0};
  return ring::launch(
      ring_gemv<V, kOnehot, NT, OutT>, done, split,
      (out + Frame::kRows - 1) / Frame::kRows, (T + tile - 1) / tile,
      Frame::kThreads, smem, stream, static_cast<const __nv_bfloat16*>(x),
      static_cast<const uint8_t*>(ids),
      static_cast<const __nv_bfloat16*>(cb), k, static_cast<OutT*>(y), T,
      out, in);
}

template <int V, bool kOnehot, typename OutT>
cudaError_t launch(const void* x, const void* ids, const void* cb, int k,
                   void* y, int T, int out, int in, int split, int tile,
                   cudaStream_t stream) {
  return tile == 8 ? launch_n<V, kOnehot, 1, OutT>(x, ids, cb, k, y, T, out,
                                                   in, split, stream)
                   : launch_n<V, kOnehot, 2, OutT>(x, ids, cb, k, y, T, out,
                                                   in, split, stream);
}

template <int V, typename OutT>
cudaError_t launch_v(const void* x, const void* ids, const void* cb, int k,
                     int onehot, void* y, int T, int out, int in, int split,
                     int tile, cudaStream_t stream) {
  return onehot ? launch<V, true, OutT>(x, ids, cb, k, y, T, out, in, split,
                                        tile, stream)
                : launch<V, false, OutT>(x, ids, cb, k, y, T, out, in, split,
                                         tile, stream);
}

template <typename OutT>
cudaError_t launch_typed(const void* x, const void* ids, const void* cb,
                         int k, int v, int onehot, void* y, int T, int out,
                         int in, int split, int tile, cudaStream_t stream) {
  if (v == 8)
    return launch_v<8, OutT>(x, ids, cb, k, onehot, y, T, out, in, split,
                             tile, stream);
  return launch_v<4, OutT>(x, ids, cb, k, onehot, y, T, out, in, split, tile,
                           stream);
}

}  // namespace vq_smallk

// Returns the CUDA error of the launch (0 on success). Requires v in {4, 8},
// 1 <= k <= 256, in % (16·v) == 0, T >= 1, split 1, 2, 4 or 8 and at most
// the stages of 128 ids of a row, tile 8 or 16 tokens a block
// (ops/vq_smallk_matmul.py vq_smallk_plan), 16-byte aligned x, ids and
// codebook, all tensors contiguous on the current device; out_dtype 0 =
// bf16, 1 = f32.
extern "C" int vptq_vq_smallk_matmul(const void* x, const void* ids,
                                     const void* codebook, void* y, int T,
                                     int out, int in, int k, int v,
                                     int onehot, int split, int tile,
                                     int out_dtype, void* stream) {
  if (k < 1 || k > 256 || (v != 4 && v != 8) || in < 16 * v ||
      in % (16 * v) || T < 1 || out < 1 || (tile != 8 && tile != 16) ||
      !ring::split_ok(split, (in / v + 127) / 128))
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0:
      return (int)vq_smallk::launch_typed<__nv_bfloat16>(
          x, ids, codebook, k, v, onehot, y, T, out, in, split, tile, st);
    case 1:
      return (int)vq_smallk::launch_typed<float>(
          x, ids, codebook, k, v, onehot, y, T, out, in, split, tile, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
