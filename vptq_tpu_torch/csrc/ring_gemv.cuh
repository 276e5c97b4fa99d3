// The asynchronous ring frame of the probe GEMVs P1c w4_i32x8_matmul.cu
// and P3 vq_smallk_matmul.cu on Hopper (sm_90a): decode_gemv.cuh's design
// for weights whose layout is none of the K1–K4 formats'.
//
//  * A block owns kRows rows of the weight (kConsumers warps of 16 rows)
//    and a range of stages of 128 bytes of each row. One producer warp
//    copies each stage (kRows rows of 128 bytes) into a ring slot with
//    cp.async.cg 16-byte copies, whose landing the slot's mbarrier tracks
//    (cp.async.mbarrier.arrive.noinc); kRing slots a block and several
//    blocks an SM keep some 25 KB and more in flight on every SM (Little's
//    law at 3.35 TB/s). A chunk past the row's end is not copied.
//  * Chunk c of row r lies at chunk c ^ (r & 1) of its slot row, so that
//    the 8 lanes of a quarter warp (rows 2i, 2i + 1; four chunks each, all
//    even or all odd) read 8 distinct bank groups.
//  * A thread-block cluster of `split` blocks (1, 2, 4 or 8; the host picks
//    it per shape) takes the same rows and disjoint ranges of a row's
//    stages (P1c: of its superblocks, so that no range cuts a group).
//    Each rank pushes its f32 totals into the shared memory of the rank
//    that writes those rows; one cluster barrier later that rank sums them
//    in rank order: one launch, no atomics, the same bits on every run.
//  * A launch takes any T: the grid's z is the token tiles (8 tokens at
//    T <= 8, else 16), each of which reads the weight again.
// The consumers (each kernel's own) stage x once a block, wait on a slot,
// load their 16-byte chunks of rows r0 = 16·warp + gid and r0 + 8, free
// the slot and run mma.sync m16n8k16 with the tokens as N.

#pragma once

#include "decode_gemv.cuh"

namespace ring {

constexpr int kStage = 128;  // bytes of a row a stage
constexpr int kChunks = kStage / 16;  // its 16-byte chunks
constexpr int kRing = 4;     // slots
constexpr int kBars = 128;   // barriers, padded
constexpr int kMaxSplit = 8;
constexpr int kMaxSmem = 232448;

using dgemv::cluster_arrive_relaxed;
using dgemv::cluster_arrive_release;
using dgemv::cluster_wait;
using dgemv::cp_async16;
using dgemv::cp_async_arrive;
using dgemv::range_of;
using lowbit::mma_bf16;
using lowbit::tile::bar_arrive;
using lowbit::tile::bar_init;
using lowbit::tile::bar_wait;
using lowbit::tile::lds128;
using lowbit::tile::smem_u32;

// the slot chunk of chunk c of row r
__device__ __forceinline__ int wswz(int c, int r) { return c ^ (r & 1); }

// 8 bytes from global to shared memory (x's 8-byte units)
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(dst),
               "l"(reinterpret_cast<uint64_t>(src))
               : "memory");
}

__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y)
               : "r"(addr));
  return v;
}

// The block of a kernel: kConsumers warps of 16 rows and one producer
// warp.
template <int kConsumersT>
struct Frame {
  static constexpr int kConsumers = kConsumersT;
  static constexpr int kRows = 16 * kConsumers;
  static constexpr int kThreads = 32 * (kConsumers + 1);
  static constexpr int kSlot = kRows * kStage;
  // bytes before the kernel's own area: alignment, barriers and the ring
  static constexpr int kHead = 128 + kBars + kRing * kSlot;
};

// The producer warp: stages [s0, s0 + nl) of rows n0 .. n0 + rows - 1 of
// the weight (row_bytes a row, nch 16-byte chunks of it), each into slot
// i % kRing once the consumers have freed it. Neighbouring lanes copy
// neighbouring chunks of a row, 4 rows at once (all of one parity, so
// that one swizzle serves them).
template <class F>
__device__ __forceinline__ void produce(const uint8_t* w, size_t row_bytes,
                                        int nch, int n0, int rows, int s0,
                                        int nl, uint32_t ring, uint32_t full,
                                        uint32_t empty) {
  constexpr int kAtOnce = 32 / kChunks;
  const int lane = threadIdx.x & 31;
  const int c = lane % kChunks;
  const int row0 = lane / kChunks;
  const uint8_t* src =
      w + (size_t)(n0 + row0) * row_bytes + (size_t)s0 * kStage + c * 16;
  const uint32_t dst0 = ring + row0 * kStage + (wswz(c, row0) << 4);
  for (int i = 0; i < nl; ++i) {
    const int slot = i % kRing;
    if (lane == 0) bar_wait(empty + 8 * slot, ((i / kRing) & 1) ^ 1);
    __syncwarp();
    if ((s0 + i) * kChunks + c < nch) {
      const uint32_t dst = dst0 + slot * F::kSlot;
      const uint8_t* from = src + (size_t)i * kStage;
#pragma unroll
      for (int k = 0; k < F::kRows / kAtOnce; ++k)
        if (row0 + kAtOnce * k < rows)
          cp_async16(dst + kAtOnce * k * kStage,
                     from + (size_t)kAtOnce * k * row_bytes);
    }
    cp_async_arrive(full + 8 * slot);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// the ring's barriers: full[i] (the producer's 32 lanes) and empty[i] (one
// arrival of each consumer warp) of every slot, by thread 0
template <class F>
__device__ __forceinline__ void init_bars(uint32_t full, uint32_t empty) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing; ++i) {
      bar_init(full + 8 * i, 32);
      bar_init(empty + 8 * i, F::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

// The end of a block: with no cluster the consumers store their totals;
// with one each rank pushes its totals of every row to the rank that
// writes it (rank q: rows q·kRows/split ..), into q's receive area rx at
// [this rank][row][token], and, once every rank is in, each rank sums its
// rows' partials in rank order. tot[j][e]: row r0 + 8·(e >> 1), token
// 8j + 2·tig + (e & 1). Every thread of the block calls it.
template <int kRows, int kConsumers, int NT, typename OutT>
__device__ __forceinline__ void finish(bool producer,
                                       const float (&tot)[NT][4], float* rx,
                                       OutT* __restrict__ y, int T, int out,
                                       int n0, int split) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = warp * 16 + gid;
  if (split == 1) {
    if (producer) return;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = 8 * j + 2 * tig + (e & 1);
        const int o = n0 + r0 + 8 * (e >> 1);
        if (tok < T && o < out)
          y[(size_t)tok * out + o] = lowbit::cvt_out<OutT>(tot[j][e]);
      }
    return;
  }
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int per = kRows / split;
  // the first phase: every block of the cluster has begun
  cluster_wait();
  if (!producer) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = 8 * j + 2 * tig + (e & 1);
        const int row = r0 + 8 * (e >> 1);
        if (tok < T) {
          const int q = row / per;
          float* theirs = cluster.map_shared_rank(rx, q);
          theirs[(rank * per + row - q * per) * T + tok] = tot[j][e];
        }
      }
  }
  // the second phase: every rank's partials are in
  __syncwarp();
  cluster_arrive_release();
  cluster_wait();
  if (producer) return;
  for (int e = threadIdx.x; e < per * T; e += 32 * kConsumers) {
    const int t = e / per;
    const int row = e - t * per;
    const int o = n0 + rank * per + row;
    if (o >= out) continue;
    float total = 0.f;
    for (int r = 0; r < split; ++r) total += rx[(r * per + row) * T + t];
    y[(size_t)t * out + o] = lowbit::cvt_out<OutT>(total);
  }
}

// One launch of `kernel` on a grid of (split, row blocks, token tiles),
// clusters of `split` along x, with `smem` bytes of dynamic shared memory;
// the kernel's limit is raised once per device (at most 64), as the bits
// of `done` record: each kernel keeps its own (kernels of one signature
// share this function).
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), std::atomic<uint64_t>& done,
                   int split, int row_blocks, int tiles, int threads,
                   size_t smem, cudaStream_t stream, Args... args) {
  if (smem > (size_t)kMaxSmem || row_blocks > 65535 || tiles > 65535)
    return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = 1ull << (dev & 63);
  if (!(done.load(std::memory_order_relaxed) & bit)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
    if (e != cudaSuccess) return e;
    done.fetch_or(bit, std::memory_order_relaxed);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, row_blocks, tiles);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t l = cudaLaunchKernelEx(&cfg, kernel, args...);
  return l != cudaSuccess ? l : cudaGetLastError();
}

// Whether a split is one the kernels take: 1, 2, 4 or 8, at most `units`.
inline bool split_ok(int split, int units) {
  return split >= 1 && split <= kMaxSplit && !(split & (split - 1)) &&
         split <= units;
}

}  // namespace ring
