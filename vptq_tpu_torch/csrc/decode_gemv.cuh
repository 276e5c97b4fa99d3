// The Hopper (sm_90a) decode GEMV of K1 w8_matmul, K2 w4_matmul, K3
// w2_matmul and K4 w3_matmul on one whole weight at T <= 16 tokens
// (sel::Whole), and of K5b w4_matmul_pairs on a stack of experts, one
// token a pair (sel::Pairs): y = x @ (s ⊙ L)^T over the formats' own byte
// layouts (w8.cuh, w4.cuh, w2_matmul.cu, w3_matmul.cu), bit for bit. It
// replaces w8.cuh's w8_gemv and lowbit.cuh's gemv on those routes, and
// computes what they and the TPU kernels compute
// (vptq_tpu/ops/pallas_gemm.py _w8_kernel, _w4_kernel, _w2_kernel,
// _w3_kernel, _w4p_kernel): x is rounded to bf16, every level is exact, the
// products of one (row, scale group) are summed in f32, that f32 partial
// is multiplied by the group's scale (int8: f32; the others: bf16), the
// scaled partials are summed in f32, and the result is cast once.
//
// What bounds it on an H100: the weight bytes, read once (int8 6.98 GB a
// token at Llama-3.1-8B width, 0.065 ms a layer at 3.35 TB/s; int4 half
// that; int3 3/8, int2 1/4 of it, plus their scales). Little's law at that
// rate and ~1 µs of latency asks for ~25 KB in flight on every SM at all
// times, and the unpack must keep pace. So:
//  * A deep asynchronous weight ring. A block owns kRows rows (32 up to 8
//    tokens, 64 past them: at one token the smaller blocks balance the SMs
//    better) and a range of 128-position stages. One producer warp copies
//    each stage (kRows rows of 128 bytes of each of the format's byte
//    planes: int3 three, the others one) into a ring slot with
//    cp.async.cg 16-byte copies, whose landing the slot's mbarrier tracks
//    (cp.async.mbarrier.arrive.noinc); 4 slots a block (int3: 2 of three
//    planes), several blocks an SM: 64 KB and more in flight on every SM.
//    (One 1-D bulk copy a row, cp.async.bulk, ran at half the rate:
//    128-byte bulk copies are too small for the copy engine.) No tensor
//    map, no workspace, no per-call attribute: the host does nothing per
//    call but the launch.
//  * A thread-block cluster splits the positions: its `split` blocks (1, 2,
//    4 or 8; ops/scaled_matmul.py decode_split picks it by shape so that
//    every Llama-3.1-8B and Qwen2.5-7B shape makes two blocks or more for
//    each SM) take the same rows and disjoint stage ranges. Each pushes its
//    partials into the shared memory of the rank that writes those rows
//    (distributed shared memory); one cluster barrier later that rank sums
//    them in rank order: one launch, no atomics, the same bits on every
//    run. (A pairs launch plans its split over all its pairs' row
//    blocks: decode_split's `pairs`.) Where a range cuts an int8 scale
//    group (512 to 2048 positions), each rank keeps that group's unscaled
//    f32 partial apart; the ranks' partials of the group are summed first
//    and the scale multiplies the sum. (The other formats' groups, 64 or
//    128 positions of a part, lie inside one stage: no range cuts them.)
//  * x is staged once a block, only the block's own positions of every
//    part (int4: two parts, L apart; int2 four; int3 eight), by cp.async
//    with an XOR swizzle on its 16-byte chunks that keeps the B-fragment
//    loads free of bank conflicts, and so are the scales of the block's
//    rows. Their loads are issued before the producer starts, so that they
//    do not queue behind the ring's copies; there is no barrier inside the
//    loop.
//  * The unpack and the product on tensor cores: each thread makes its A
//    fragments with the policy's own prefill-tile hooks (P::tile_code on
//    P::kTileSlots words, word i from plane P::tile_plane(p, i), and, for
//    a bias, one lowbit::tile::bf16x2_fma with P::kTileBias) and runs
//    mma.sync m16n8k16 bf16 -> f32 with 16 weight rows as M and the tokens
//    as N (8 or 16; a token past T reads token T - 1, whose columns are
//    never stored). The 16 k-slots of a step are the thread's own bytes:
//    bytes 0, 2 of word u of its chunk of each plane (tile_code reads bits
//    0-7 and 16-23 in place) fill slots 2·tig, +1, bytes 1, 3 (the words
//    shifted by 8) slots 2·tig + 8, +9, and x is staged with each four
//    positions as (0, 2), (1, 3) to match. A warp sums one scale group's
//    steps in acc and folds them into f32 totals with the group's scales,
//    as the tile does. mma.sync rather than wgmma: a warp owns its 16 rows
//    and needs no warpgroup to keep in step, and the tensor cores are far
//    from binding (one m16n8k16 per 256 weights). What binds at one token
//    is the loop's issue, not the bytes: K1 runs near its loop's issue
//    rate, and K3 and K4 near one instruction a cycle an SM, where an
//    unpack with 40% fewer integer operations moved them by 5% or less
//    (PERF.md).
//  * The parts (K1: one, K2: two, K3: four, K4: eight) run in turn: each
//    part's two chunks of a stage, then the fold of that part's group (64
//    positions: after each chunk; 128: after both; int8: after the
//    group's last stage) before the next part, so that one acc and one
//    part's x are live at a time: eight parts' x and accumulators at 16
//    tokens would not fit the registers.
//
// A selection policy Sel (expert_select.cuh) says which weight a block
// reads. sel::Whole: the one weight, a grid of (split, row blocks).
// sel::Pairs (K5b): a grid of (split, row blocks, P), pair p = blockIdx.z;
// the block's first load is ids[p] (clamped into the stack), which moves
// the planes by e·out·row_bytes bytes, the scales by e·out·groups
// elements (in 64 bits: a stack may pass 2^31 bytes), x and y to row p,
// before the producer's first copy and before x and the scales are
// staged; then the block runs one token (T = 1, N = 8: the padding
// columns read token 0 and are never stored). Pairs that pick one expert
// each read its slab, as the TPU kernel does.
// The policy's name is part of every instance's demangled name, so a
// trace tells K2's decode GEMV from K5b's. K5a's pairs grouped by expert
// (sel::Grouped) run decode_gemv_grouped, at the end of this file.
//
// A format policy P gives kPlanes, kParts and the tile hooks (w8::W8,
// w4::W4, w2_matmul.cu W2, w3_matmul.cu W3). The weight comes as a
// lowbit::Planes (each plane (out, L) bytes at its row stride and offset:
// one for K1–K3, three for K4) and the scales as a lowbit::ScalesOf (K1
// f32 and K2 bf16 laid out (groups, out), K3 and K4 bf16 (out, groups));
// gs is the stages of one scale group of one part (int8 group / 128, else
// 1) and G the group of a part of several (K3: 64 or 128; K4: 128).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <atomic>

#include "lowbit_tile.cuh"

namespace dgemv {

constexpr int kStage = 128;                     // positions of one stage
constexpr int kH = kStage / 64;                 // 16-byte chunks a thread
                                                // reads of a row a stage
static_assert(kStage == 128, "the swizzles below assume two chunks a row");
constexpr int kMaxSplit = 8;                    // the portable cluster
constexpr int kBars = 128;                      // barriers, padded
constexpr int kMaxSmem = 232448;                // one block's limit

// The block of a token tile: NT = 1 (N = 8, T <= 8) runs 2 consumer warps
// of 16 rows, NT = 2 (T <= 16) 4; one producer warp beside them. (At one
// token, 32-row blocks balance the SMs better than 64-row ones.)
template <int NT>
struct Block {
  static constexpr int kConsumers = NT == 1 ? 2 : 4;
  static constexpr int kRows = 16 * kConsumers;
  static constexpr int kThreads = 32 * (kConsumers + 1);
  static constexpr int kSlot = kRows * kStage;  // bytes of one plane's stage
};

// The ring's slots: four of one plane's stage (4 KB at 32 rows), two of
// three planes' (12 KB): as many bytes in flight a block, and more blocks
// an SM.
template <class P>
constexpr int kRingOf = P::kPlanes > 1 ? 2 : 4;

// The blocks an SM that the registers must allow (__launch_bounds__): up
// to 8 tokens six, four for int3's three planes; at 16 tokens five for
// int8, four for int4 (at five its loop spilled) and two for more parts,
// whose 64-row blocks' x leaves room for two an SM at most.
template <class P, int NT>
constexpr int kMinBlocks =
    NT == 1 ? (P::kPlanes > 1 ? 4 : 6)
            : (P::kParts == 1 ? 5 : P::kParts == 2 ? 4 : 2);

// The folds of one part in a stage: a scale group of 64 positions (K3 at
// G = 64) folds after each of a thread's two 64-position chunks, one of
// 128 after both; one part (int8) folds once its group's last stage is
// done. Its scales take kParts · folds · sizeof(ST) bytes a row and stage.
template <class P, int G>
constexpr int kFoldsOf = P::kParts > 1 && G == 64 ? 2 : 1;

using lowbit::mma_bf16;
using lowbit::tile::bar_arrive;
using lowbit::tile::bar_init;
using lowbit::tile::bar_wait;
using lowbit::tile::bf16x2_fma;
using lowbit::tile::smem_u32;
namespace cg = cooperative_groups;

// the shared memory of a block: barriers, the ring (ring slots of planes ·
// rows · 128 bytes), x (T rows of parts·max_stages·kStage bf16), the
// scales of each stage (scale_bytes a row) and the partials the cluster's
// ranks push (3 f32 a row and token), + 128 for alignment
inline size_t smem_bytes(int ring, int rows, int planes, int parts,
                         int scale_bytes, int T, int max_stages) {
  return 128 + kBars + (size_t)ring * planes * rows * kStage +
         (size_t)T * parts * max_stages * kStage * 2 +
         (size_t)max_stages * scale_bytes * rows + (size_t)3 * rows * T * 4;
}

// stage range [a, b) of rank r of `split` over n stages
__device__ __forceinline__ void range_of(int r, int split, int n, int& a,
                                         int& b) {
  a = r * n / split;
  b = (r + 1) * n / split;
}

// The scale groups rank r's range cuts (-1: none): g[0] the first group
// it touches, where that group reaches outside the range; g[1] the last,
// where it is another group and reaches past the range's end.
__device__ __forceinline__ void cuts_of(int r, int split, int n, int gs,
                                        int (&g)[2]) {
  int a, b;
  range_of(r, split, n, a, b);
  const int gf = a / gs, gl = (b - 1) / gs;
  g[0] = (gf * gs < a || (gf == gl && b < (gf + 1) * gs)) ? gf : -1;
  g[1] = (gl != gf && b < (gl + 1) * gs) ? gl : -1;
}

// the cluster barrier in its phases (every thread of every block of the
// cluster arrives once a phase)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// 16 bytes from global to shared memory, around L1
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(reinterpret_cast<uint64_t>(src))
               : "memory");
}

// an arrival on the barrier once this thread's earlier cp.async copies
// have landed (one of the barrier's expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar)
               : "memory");
}

// x row t's chunk q (8 positions) lies at chunk q ^ (t & 1), and chunk c
// of weight row r in a slot at chunk c ^ 4·(r & 1): the 8 lanes of a
// quarter warp (tokens or rows 2i and 2i + 1; tig 0..3) then read 8
// distinct bank groups
__device__ __forceinline__ int xswz(int q, int t) { return q ^ (t & 1); }
__device__ __forceinline__ int wswz(int c, int r) { return c ^ ((r & 1) << 2); }

// The A pair of part p from P::kTileSlots words whose bytes of two
// positions lie in bits 0-7 and 16-23 (the rest is never read): the
// prefill tile's unpack, tile_code and one bf16x2 fma that takes away the
// bias; a bias of 0 (int8) leaves code + (-0) = code, bit for bit, so that
// fma is skipped.
template <class P>
__device__ __forceinline__ uint32_t level_pair(
    const uint32_t (&t)[P::kTileSlots], int p) {
  const uint32_t code = P::tile_code(t, p);
  if constexpr (P::kTileBias == 0u)
    return code;
  else
    return bf16x2_fma(code, 0x3F803F80u, P::kTileBias ^ 0x80008000u);
}

// NT: 8-token tiles of N (1: T <= 8, 2: T <= 16); G: the scale group of a
// part of several (64 or 128 positions). x: (T, kParts·L) bf16; pl: the
// planes, each (out, L) bytes at its row stride and offset; sc: the scales;
// gs: the stages of one scale group of one part (1 for several parts);
// ids: with sel::Pairs, the expert of each row of x (P rows, T = 1), whose
// slabs lie in the stacks pl and sc point to (unread for sel::Whole).
template <class P, class Sel, int NT, int G, typename OutT, typename ST>
__global__ void __launch_bounds__(Block<NT>::kThreads, kMinBlocks<P, NT>)
    decode_gemv(const __nv_bfloat16* __restrict__ x, lowbit::Planes pl,
                lowbit::ScalesOf<ST> sc, OutT* __restrict__ y, int T, int out,
                int L, int gs, lowbit::Ids ids) {
  constexpr int kPlanes = P::kPlanes;
  constexpr int kParts = P::kParts;
  constexpr int kRing = kRingOf<P>;
  constexpr int kConsumers = Block<NT>::kConsumers;
  constexpr int kRows = Block<NT>::kRows;
  constexpr int kThreads = Block<NT>::kThreads;
  constexpr int kSlot = Block<NT>::kSlot;
  constexpr int kSlotAll = kPlanes * kSlot;  // bytes of one ring slot
  static_assert(kParts <= 2 ? kPlanes == 1 && G == 128
                            : G == 64 || G == 128,
                "one plane and group 128 for one or two parts; group 64 or "
                "128 for more");
  static_assert(!Sel::kIds || Sel::kPairs,
                "one whole weight, or one expert for each pair");
  if constexpr (Sel::kPairs) {
    // pair p's expert, the block's first load; everything after it reads
    // that expert's slab and row p of x and y
    const int p = sel::pair_of<Sel, 2>();
    const size_t e = sel::expert_of(ids.ids, ids.n_experts, p);
#pragma unroll
    for (int q = 0; q < kPlanes; ++q)
      pl.base[q] += e * (size_t)out * (size_t)pl.row_bytes[q];
    const size_t groups =
        kParts > 1 ? (size_t)kParts * (L / G) : (size_t)(L / kStage / gs);
    sc.s += e * (size_t)out * groups;
    x += (size_t)p * kParts * L;
    y += (size_t)p * out;
  }
  extern __shared__ __align__(16) unsigned char dg_smem[];
  unsigned char* sm = dg_smem + ((128 - (smem_u32(dg_smem) & 127)) & 127);
  const uint32_t full = smem_u32(sm), empty = full + 8 * kRing;
  unsigned char* ring = sm + kBars;
  const uint32_t ring_u32 = smem_u32(ring);

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)gridDim.x;
  const int rank = (int)cluster.block_rank();
  const int n = L / kStage;  // stages of a row
  const int max_stages = (n + split - 1) / split;
  int a, b;
  range_of(rank, split, n, a, b);
  const int nl = b - a;
  const int n0 = blockIdx.y * kRows;
  const int rows = min(kRows, out - n0);
  // x: T rows of kParts parts of max_stages stages
  unsigned char* xs = ring + kRing * kSlotAll;
  const int x_pitch = kParts * max_stages * kStage * 2;
  const int part_chunks = max_stages * (kStage / 8);  // of one x row
  // the scales each stage folds: [stage][part][fold][row] (ST)
  constexpr int kFold = kParts > 1 ? kH / kFoldsOf<P, G> : kH;
  constexpr int kFolds = kH / kFold;
  ST* ss = reinterpret_cast<ST*>(xs + T * x_pitch);
  // the partials other ranks push: [rank][kind][row][token] f32, kRows / split
  // rows of 3 kinds of each of split ranks
  float* rx = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(ss) +
      (size_t)max_stages * (kParts * kFolds * sizeof(ST)) * kRows);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing; ++i) {
      bar_init(full + 8 * i, 32);
      bar_init(empty + 8 * i, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (split > 1) cluster_arrive_relaxed();

  if (warp == kConsumers) {
    // the producer: a stage is kRows rows of kStage / 16 16-byte chunks of
    // each plane; neighbouring lanes copy neighbouring chunks of a row, and
    // each lane arrives on the slot's barrier once its copies have landed
    constexpr int kPerRow = kStage / 16;
    constexpr int kRowsAtOnce = 32 / kPerRow;
    const int c = lane % kPerRow;
    const int row0 = lane / kPerRow;
    const uint8_t* src[kPlanes];
#pragma unroll
    for (int q = 0; q < kPlanes; ++q)
      src[q] = pl.base[q] + (size_t)(n0 + row0) * pl.row_bytes[q] +
               pl.off[q] + (size_t)a * kStage + c * 16;
    const uint32_t dst0 =
        ring_u32 + row0 * kStage + (wswz(c, row0) << 4);
    // once the consumers' loads of x and the scales are out
    asm volatile("bar.sync 2, %0;" ::"n"(kThreads) : "memory");
    for (int i = 0; i < nl; ++i) {
      const int slot = i % kRing;
      if (lane == 0) bar_wait(empty + 8 * slot, ((i / kRing) & 1) ^ 1);
      __syncwarp();
#pragma unroll
      for (int q = 0; q < kPlanes; ++q) {
        const uint32_t dst = dst0 + slot * kSlotAll + q * kSlot;
        const uint8_t* from = src[q] + (size_t)i * kStage;
#pragma unroll
        for (int k = 0; k < kRows / kRowsAtOnce; ++k)
          if (row0 + k * kRowsAtOnce < rows)
            cp_async16(dst + k * kRowsAtOnce * kStage,
                       from + (size_t)k * kRowsAtOnce * pl.row_bytes[q]);
      }
      cp_async_arrive(full + 8 * slot);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    if (split == 1) return;
  } else {
    const int n_groups = kParts > 1 ? L / G : n / gs;  // of one part
    // stage x and the scales once: the block's own positions of each part
    // (of T tokens), and
    // the scales of its rows for every fold of every stage. Their loads are
    // issued before the producer may start, so that they do not queue
    // behind the ring's copies: x as 16-byte copies, the scales in batches
    // of 16 a thread.
    {
      constexpr int kStride = 32 * kConsumers;
      constexpr int kBatch = 16;
      const int cpp = nl * (kStage / 8);  // x chunks of one part
      const int per_tok = kParts * cpp;
      for (int e = threadIdx.x; e < T * per_tok; e += kStride) {
        const int t = e / per_tok;
        const int r = e - t * per_tok;
        const int p = r / cpp;
        const int c = r - p * cpp;
        const int q = p * part_chunks + c;
        cp_async16(smem_u32(xs) + t * x_pitch + (xswz(q, t) << 4),
                   x + (size_t)t * kParts * L + (size_t)p * L +
                       (size_t)a * kStage + (size_t)c * 8);
      }
      const int per_stage = kParts * kFolds * kRows;
      bool went = false;  // whether this thread let the producer start
      for (int e0 = threadIdx.x; e0 < nl * per_stage; e0 += kBatch * kStride) {
        ST v[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int e = e0 + k * kStride;
          const int row = e % kRows;
          const int f = (e / kRows) % kFolds;
          const int p = (e / (kRows * kFolds)) % kParts;
          const int i = e / per_stage;
          const int g = kParts > 1 ? p * n_groups + (a + i) * kFolds + f
                                   : (a + i) / gs;
          v[k] = e < nl * per_stage && n0 + row < out
                     ? sc.s[(size_t)(n0 + row) * sc.row_stride +
                            (size_t)g * sc.group_stride]
                     : ST(0.f);
        }
        if (!went)  // the producer may start
          asm volatile("barrier.cta.arrive 2, %0;" ::"n"(kThreads) : "memory");
        went = true;
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          if (e0 + k * kStride < nl * per_stage) ss[e0 + k * kStride] = v[k];
      }
      if (!went)
        asm volatile("barrier.cta.arrive 2, %0;" ::"n"(kThreads) : "memory");
      // x as the weight words give their pairs: positions 0 1 2 3 of each
      // four as (0, 2), (1, 3) (bytes 0, 2 and, shifted, 1, 3); each
      // thread reorders the chunks it copied
      asm volatile("cp.async.wait_all;" ::: "memory");
      for (int e = threadIdx.x; e < T * per_tok; e += kStride) {
        const int t = e / per_tok;
        const int r = e - t * per_tok;
        const int q = (r / cpp) * part_chunks + r % cpp;
        uint4* at = reinterpret_cast<uint4*>(xs + t * x_pitch +
                                             (xswz(q, t) << 4));
        const uint4 v = *at;
        *at = make_uint4(__byte_perm(v.x, v.y, 0x5410u),
                         __byte_perm(v.x, v.y, 0x7632u),
                         __byte_perm(v.z, v.w, 0x5410u),
                         __byte_perm(v.z, v.w, 0x7632u));
      }
      asm volatile("bar.sync 1, %0;" ::"n"(32 * kConsumers) : "memory");
    }

    const int gid = lane >> 2;
    const int tig = lane & 3;
    const int r0 = warp * 16 + gid;  // rows r0 and r0 + 8 of the block
    const int par = gid & 1;         // of r0, r0 + 8 and tokens 8j + gid
    // this thread's chunk h of rows r0 and r0 + 8 in slot 0: chunk
    // tig + 4h, swizzled by the row's parity
    const unsigned char* wrow[kH];
#pragma unroll
    for (int h = 0; h < kH; ++h)
      wrow[h] = ring + r0 * kStage + 16 * tig + 64 * (h ^ par);
    // its x chunks 2·tig + 8h + e of part p and token 8j + gid in stage 0:
    // 16 bytes apart, swizzled by the token's parity. A token past T reads
    // token T - 1: column n of a product depends on column n of B alone,
    // and the columns past T are never stored.
    const unsigned char* xrow[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      xrow[j] = xs + min(8 * j + gid, T - 1) * x_pitch + 32 * tig + 16 * par;
    const int xe = 16 - 32 * par;  // from chunk e = 0 to e = 1

    // the words of every plane stay in registers for the stage, and each
    // part's x, products and fold come in turn: one acc and one part's x
    // are live at a time
    constexpr int kSlots = P::kTileSlots;
    float tot[NT][4], cut[2][NT][4], acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tot[j][e] = cut[0][j][e] = cut[1][j][e] = acc[j][e] = 0.f;

    // the stage's group (one part) and its place in it, kept as counters
    int g = a / gs, in_group = a - g * gs;
    const int first_group = g;
    for (int i = 0; i < nl; ++i) {
      const int slot = i & (kRing - 1);
      const bool group_end = in_group == gs - 1 || i == nl - 1;
      bar_wait(full + 8 * slot, (i / kRing) & 1);
      // this thread's words of rows r0 and r0 + 8 (wd[plane][0 / 1]) in
      // chunk h of each plane; then the slot is free
      uint32_t wd[kPlanes][2][kH][4];
#pragma unroll
      for (int q = 0; q < kPlanes; ++q)
#pragma unroll
        for (int h = 0; h < kH; ++h) {
          const unsigned char* at = wrow[h] + slot * kSlotAll + q * kSlot;
          const uint4 v0 = *reinterpret_cast<const uint4*>(at);
          const uint4 v1 = *reinterpret_cast<const uint4*>(at + 8 * kStage);
          wd[q][0][h][0] = v0.x;
          wd[q][0][h][1] = v0.y;
          wd[q][0][h][2] = v0.z;
          wd[q][0][h][3] = v0.w;
          wd[q][1][h][0] = v1.x;
          wd[q][1][h][1] = v1.y;
          wd[q][1][h][2] = v1.z;
          wd[q][1][h][3] = v1.w;
        }
      __syncwarp();
      if (lane == 0) bar_arrive(empty + 8 * slot);

#pragma unroll
      for (int p = 0; p < kParts; ++p)
#pragma unroll
        for (int h = 0; h < kH; ++h) {
          // part p's x chunks 2·tig + 8h and + 1 (positions 16·tig + 64h
          // ..+ 15) of each token tile
          uint4 xq[NT][2];
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              xq[j][e] = *reinterpret_cast<const uint4*>(
                  xrow[j] + i * (kStage * 2) + p * part_chunks * 16 +
                  128 * h + e * xe);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            // step u: slots 2·tig, +1 are bytes 0, 2 of word u of the chunk
            // (positions 4u, 4u + 2 of it), slots 2·tig + 8, +9 bytes 1, 3;
            // x was staged in the same order. Each slot's word comes from
            // its plane: (row r0, r0 + 8) x (bytes 0 and 2, 1 and 3)
            uint32_t t[4][kSlots];
#pragma unroll
            for (int s = 0; s < kSlots; ++s) {
              const int q = P::tile_plane(p, s);
              t[0][s] = wd[q][0][h][u];
              t[1][s] = wd[q][1][h][u];
              t[2][s] = wd[q][0][h][u] >> 8;
              t[3][s] = wd[q][1][h][u] >> 8;
            }
            const uint32_t af[4] = {
                level_pair<P>(t[0], p), level_pair<P>(t[1], p),
                level_pair<P>(t[2], p), level_pair<P>(t[3], p)};
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const uint4& xc = xq[j][u >> 1];
              const uint32_t bf[2] = {(u & 1) ? xc.z : xc.x,
                                      (u & 1) ? xc.w : xc.y};
              mma_bf16(acc[j], af, bf);
            }
          }

          // part p's group ends (one part: its last stage in the range)
          const bool fold = kParts > 1 ? h % kFold == kFold - 1
                                       : h == kH - 1 && group_end;
          if (fold) {
            // a group inside the range is scaled here; a group the range
            // cuts (one part only) keeps its unscaled partial for the
            // cluster's sum
            const bool whole =
                kParts > 1 || (g * gs >= a && (g + 1) * gs <= b);
            const ST* sp = ss + ((i * kParts + p) * kFolds + h / kFold) * kRows;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              if (whole) {
                const float s0 = lowbit::scale_f32(sp[r0]);
                const float s1 = lowbit::scale_f32(sp[r0 + 8]);
                tot[j][0] += acc[j][0] * s0;
                tot[j][1] += acc[j][1] * s0;
                tot[j][2] += acc[j][2] * s1;
                tot[j][3] += acc[j][3] * s1;
              } else if (g == first_group) {
#pragma unroll
                for (int e = 0; e < 4; ++e) cut[0][j][e] = acc[j][e];
              } else {
#pragma unroll
                for (int e = 0; e < 4; ++e) cut[1][j][e] = acc[j][e];
              }
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
            }
          }
        }
      if (++in_group == gs) {
        in_group = 0;
        ++g;
      }
    }

    if (split == 1) {
      // no cluster: every group was whole, the totals are y
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
    // Push this block's partials, [body, cut 0, cut 1], of each row to the
    // rank that writes the row (rank q: rows q·kRows/split ..), into its
    // receive area at [this rank][kind][row][token]; once every rank is in
    // (the barrier's first phase, entered at the start, so that no block
    // writes to one that has not begun)
    cluster_wait();
    const int per = kRows / split;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = 8 * j + 2 * tig + (e & 1);
        const int row = r0 + 8 * (e >> 1);
        if (tok < T) {
          const int q = row / per;
          float* theirs = cluster.map_shared_rank(rx, q);
          const int at = ((rank * 3) * per + row - q * per) * T + tok;
          theirs[at] = tot[j][e];
          if (kParts == 1) {
            theirs[at + per * T] = cut[0][j][e];
            theirs[at + 2 * per * T] = cut[1][j][e];
          }
        }
      }
  }

  if (warp == kConsumers) cluster_wait();
  // the second phase: every rank's partials are in
  __syncwarp();
  cluster_arrive_release();
  cluster_wait();
  if (warp < kConsumers) {
    // this rank's rows: the ranks' partials summed in rank order; a cut
    // group's unscaled partials summed before its scale
    const int per = kRows / split;
    for (int e = threadIdx.x; e < per * T; e += 32 * kConsumers) {
      const int t = e / per;
      const int row = e - t * per;
      const int o = n0 + rank * per + row;
      if (o >= out) continue;
      float total = 0.f, open = 0.f;
      int open_g = -1;
      for (int r = 0; r < split; ++r) {
        const float* part = rx + ((r * 3) * per + row) * T + t;
        total += part[0];
        if (kParts > 1) continue;
        int cuts[2];
        cuts_of(r, split, n, gs, cuts);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          if (cuts[k] < 0) continue;
          if (cuts[k] != open_g) {
            if (open_g >= 0)
              total += open * sc.at(o, open_g);
            open = 0.f;
            open_g = cuts[k];
          }
          open += part[(1 + k) * per * T];
        }
      }
      if (open_g >= 0)
        total += open * sc.at(o, open_g);
      y[(size_t)t * out + o] = lowbit::cvt_out<OutT>(total);
    }
  }
}

// One launch on a cluster of `split` blocks along x, one row block of
// Block<NT> along y for each kRows rows of out and one pair along z (1 for
// sel::Whole); the kernel's limit of dynamic shared memory is raised once
// per device (at most 64).
template <class P, class Sel, int NT, int G, typename OutT, typename ST>
cudaError_t launch_n(const __nv_bfloat16* x, const lowbit::Planes& pl,
                     const lowbit::ScalesOf<ST>& sc, OutT* y, int T, int out,
                     int L, int gs, int split, const lowbit::Ids& ids,
                     int pairs, cudaStream_t stream) {
  using B = Block<NT>;
  static std::atomic<uint64_t> done{0};
  const int n = L / kStage;
  const size_t smem = smem_bytes(
      kRingOf<P>, B::kRows, P::kPlanes, P::kParts,
      P::kParts * kFoldsOf<P, G> * (int)sizeof(ST), T,
      (n + split - 1) / split);
  if (smem > (size_t)kMaxSmem || out > 65535 * B::kRows || pairs > 65535)
    return cudaErrorInvalidValue;
  auto kernel = decode_gemv<P, Sel, NT, G, OutT, ST>;
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
  cfg.gridDim = dim3(split, (out + B::kRows - 1) / B::kRows, pairs);
  cfg.blockDim = dim3(B::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t l =
      cudaLaunchKernelEx(&cfg, kernel, x, pl, sc, y, T, out, L, gs, ids);
  return l != cudaSuccess ? l : cudaGetLastError();
}

// The decode GEMV of format P on 1..16 tokens of bf16 x: its planes (each
// (out, L) bytes at its row stride and offset) and scales of type ST at
// sc.s[row·row_stride + g·group_stride]. G: the scale group of a part of
// several (K3: 64 or 128 positions; K4: 128); gs: the stages of one scale
// group of one part (K1: its group / 128, which must divide L / 128; 1
// for several parts). split: the cluster's blocks (1, 2, 4 or 8, at most
// L / 128). Sel: sel::Whole (pl and sc one weight, ids unread, pairs 1) or
// sel::Pairs (pl and sc stacks of ids.n_experts slabs, `pairs` rows of x
// of one token each, T = 1; the split planned for all pairs' blocks).
// Returns the CUDA error of the launch (cudaErrorInvalidValue for what it
// does not take).
template <class P, class Sel, int G = 128, typename OutT, typename ST>
cudaError_t launch(const __nv_bfloat16* x, const lowbit::Planes& pl,
                   const lowbit::ScalesOf<ST>& sc, OutT* y, int T, int out,
                   int L, int gs, int split, cudaStream_t stream,
                   const lowbit::Ids& ids = lowbit::Ids{nullptr, 0},
                   int pairs = 1) {
  const int n = L / kStage;
  if (T < 1 || T > 16 || out < 1 || L % kStage || gs < 1 || n % gs ||
      (P::kParts > 1 && gs != 1) || split < 1 || split > kMaxSplit ||
      (split & (split - 1)) || split > n)
    return cudaErrorInvalidValue;
  if constexpr (Sel::kPairs) {
    if (T != 1 || pairs < 1 || ids.ids == nullptr || ids.n_experts < 1)
      return cudaErrorInvalidValue;
    return launch_n<P, Sel, 1, G, OutT, ST>(x, pl, sc, y, 1, out, L, gs,
                                            split, ids, pairs, stream);
  } else {
    if (pairs != 1) return cudaErrorInvalidValue;
    if (T <= 8)
      return launch_n<P, Sel, 1, G, OutT, ST>(x, pl, sc, y, T, out, L, gs,
                                              split, ids, 1, stream);
    return launch_n<P, Sel, 2, G, OutT, ST>(x, pl, sc, y, T, out, L, gs,
                                            split, ids, 1, stream);
  }
}

// ---------------------------------------------------------------------
// K5a w8_matmul_pairs: the pairs grouped by expert (sel::Grouped).
//
// A grid of (split, row blocks, S), S = min(P, E) expert slots, clusters
// of `split` blocks along x as above: it depends on P, E and the shapes
// alone, so that a CUDA graph can hold the launch.
//  * Grouping on the card. The blocks of slot s find the s-th distinct
//    expert the ids pick (expert_select.cuh: a bitmap of the clamped ids,
//    its s-th set bit; a slot past the distinct experts exits at once, its
//    whole cluster with it) and stream that expert's rows of the stack
//    once for all of its pairs: the pairs are the product's N columns, in
//    ascending p, at most `cols` (8·NT at most) a pass, which one consumer
//    warp's ballots over the ids collect. An expert with more pairs than a
//    pass takes several, each reading its rows again. Column t of a pass
//    reads x row list[t] (a column past the pass's pairs reads its last
//    one and is never stored) and writes y row list[t].
//  * One ring for all a stage needs. The producer warp copies, into one
//    slot, the block's rows of the stage (as decode_gemv), the stage's 128
//    positions of each of the pass's x rows (256 bytes a column, 16-byte
//    chunk q of column t at q ^ (t & 1): the B-fragment loads of a quarter
//    warp hit 8 bank groups) and, where the stage ends a scale group in
//    the block's range, the rows' f32 scales. Nothing is staged before
//    the loop: the first product waits only for the first stage (staging
//    x and the scales of the whole range first took 3.5 to 8.6 µs of
//    blocks of 10 to 47 µs on an H100, PERF.md). Blocks of 32 rows take a
//    ring of 8 slots, of 64 rows 4: 32 KB of weight stages a block.
//  * x lies as it comes; each B fragment pairs its positions (0, 2), (1,
//    3) with two byte permutes, to match the weight words' bytes.
// The arithmetic is decode_gemv's for one part and one plane (int8):
// column n of a product depends on column n of B alone, so a pair's row
// of y is the same bits whichever pairs share its block and its columns;
// with the plan fixed (P, E), the other pairs' ids cannot change it.
// Shared memory: barriers, the ring, the partials the cluster's ranks
// push, the grouping (the bitmap, the expert and its count of pairs, the
// pass's pairs).

// Timeline hooks of the grouped kernel, empty unless a build defines
// DG_STAMP_IF (examples/pairs_timeline.py stamps %globaltimer there).
#ifndef DG_STAMP_IF
#define DG_STAMP_IF(cond, i)
#endif

constexpr int kMaxCols = 16;      // the columns of a pass: two tiles
constexpr int kGroupBytes = 128;  // bitmap, expert, count, kMaxCols pairs

// A grouped block of kCons consumer warps of 16 rows (2 or 4) and one
// producer warp.
template <int kCons>
struct GroupedBlock {
  static constexpr int kConsumers = kCons;
  static constexpr int kRows = 16 * kCons;
  static constexpr int kThreads = 32 * (kCons + 1);
  static constexpr int kRing = kCons == 2 ? 8 : 4;
};

// The blocks an SM the registers must allow (a stage's B fragments take
// 16 registers a thread a token tile): six of 32 rows at one tile, five
// at two, three of 64 rows (at four one tile's spilled 12 bytes)
template <int NT, int kCons>
constexpr int kGroupedBlocks = kCons == 2 ? (NT == 1 ? 6 : 5) : 3;

// the bytes of one slot: the rows' stage, the pass's x, the rows' scales
__host__ __device__ constexpr int grouped_slot_bytes(int rows, int cols) {
  return rows * kStage + cols * kStage * 2 + rows * 4;
}

inline size_t grouped_smem_bytes(int rows, int cols) {
  const int ring = rows == 32 ? GroupedBlock<2>::kRing : GroupedBlock<4>::kRing;
  return 128 + kBars + (size_t)ring * grouped_slot_bytes(rows, cols) +
         (size_t)3 * rows * cols * 4 + kGroupBytes;
}

// 4 bytes from global to shared memory
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"(reinterpret_cast<uint64_t>(src))
               : "memory");
}

// x: (P, L) bf16; wq: (E, out, L) bytes of format P; scales: (E, groups,
// out) f32, a group gs stages; y: (P, out); ids: the P expert ids and E.
template <class P, class Sel, int NT, int kCons, typename OutT>
__global__ void __launch_bounds__(GroupedBlock<kCons>::kThreads,
                                  kGroupedBlocks<NT, kCons>)
    decode_gemv_grouped(const __nv_bfloat16* __restrict__ x,
                        const uint8_t* __restrict__ wq,
                        const float* __restrict__ scales,
                        OutT* __restrict__ y, int pairs, int out, int L,
                        int gs, int cols, lowbit::Ids ids) {
  static_assert(P::kPlanes == 1 && P::kParts == 1 && P::kTileSlots == 1,
                "one plane and one part of one byte a level (int8)");
  static_assert(Sel::kIds && Sel::kPairs &&
                    Sel::kWords * 32 == Sel::kMaxExperts,
                "the pairs grouped by expert");
  using B = GroupedBlock<kCons>;
  constexpr int kRing = B::kRing;
  constexpr int kConsumers = B::kConsumers;
  constexpr int kRows = B::kRows;
  constexpr int kThreads = B::kThreads;
  static_assert(16 * kRing <= kBars && (kRing & (kRing - 1)) == 0,
                "the ring's barriers fit their area");
  extern __shared__ __align__(16) unsigned char dg_smem[];
  unsigned char* sm = dg_smem + ((128 - (smem_u32(dg_smem) & 127)) & 127);
  const uint32_t full = smem_u32(sm), empty = full + 8 * kRing;
  unsigned char* ring = sm + kBars;
  const uint32_t ring_u32 = smem_u32(ring);
  // a slot: the rows' stage, then x of the pass's pairs, then the scales
  const int slot_bytes = grouped_slot_bytes(kRows, cols);
  const int x_off = kRows * kStage;
  const int s_off = x_off + cols * kStage * 2;
  // the partials the cluster's ranks push: [rank][kind][row][column] f32
  float* rx = reinterpret_cast<float*>(ring + (size_t)kRing * slot_bytes);
  unsigned* bits = reinterpret_cast<unsigned*>(rx + (size_t)3 * kRows * cols);
  int* info = reinterpret_cast<int*>(bits + Sel::kWords);  // expert, count
  int* list = info + 2;  // the pass's pairs

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)gridDim.x;
  const int rank = (int)cluster.block_rank();
  const int n = L / kStage;  // stages of a row
  int a, b;
  range_of(rank, split, n, a, b);
  const int nl = b - a;
  const int n0 = blockIdx.y * kRows;
  const int rows = min(kRows, out - n0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // the block's expert: the blockIdx.z-th distinct one of the ids
  if (threadIdx.x < Sel::kWords) bits[threadIdx.x] = 0u;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing; ++i) {
      bar_init(full + 8 * i, 32);
      bar_init(empty + 8 * i, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  DG_STAMP_IF(true, 0);
  sel::mark_experts(ids.ids, ids.n_experts, pairs, bits);
  __syncthreads();
  if (warp == 0) {
    const int ex = sel::nth_expert(bits, (int)blockIdx.z);
    if (lane == 0) info[0] = ex;
  }
  __syncthreads();
  const int ex = info[0];
  if (ex < 0) return;  // no expert for this slot (nor for its cluster)
  DG_STAMP_IF(true, 1);
  wq += (size_t)ex * (size_t)out * (size_t)L;
  scales += (size_t)ex * (size_t)(n / gs) * (size_t)out;

  if (warp == kConsumers) {
    // the producer: a pass's stages once its pairs are collected (barrier
    // 2), each into the slot the consumers freed: the rows as decode_gemv
    // copies them, the pass's x chunks, the scales where a group ends
    constexpr int kPerRow = kStage / 16;
    constexpr int kRowsAtOnce = 32 / kPerRow;
    const int c = lane % kPerRow;
    const int row0 = lane / kPerRow;
    const uint8_t* src =
        wq + (size_t)(n0 + row0) * L + (size_t)a * kStage + c * 16;
    const uint32_t dst0 = ring_u32 + row0 * kStage + (wswz(c, row0) << 4);
    // the rows of the first stages need only the expert: out before the
    // pass's pairs are known (their slots start free)
    const int early = min(nl, kRing);
    for (int i = 0; i < early; ++i)
#pragma unroll
      for (int r = 0; r < kRows / kRowsAtOnce; ++r)
        if (row0 + r * kRowsAtOnce < rows)
          cp_async16(dst0 + i * slot_bytes + r * kRowsAtOnce * kStage,
                     src + (size_t)i * kStage + (size_t)r * kRowsAtOnce * L);
    int passes = 1, it = 0;
    for (int k = 0; k < passes; ++k) {
      asm volatile("bar.sync 2, %0;" ::"n"(kThreads) : "memory");
      const int count = info[1];
      passes = (count + cols - 1) / cols;
      const int T = min(cols, count - k * cols);
      int g = a / gs, in_group = a - g * gs;
      for (int i = 0; i < nl; ++i, ++it) {
        const int slot = it % kRing;
        const uint32_t at = ring_u32 + slot * slot_bytes;
        if (k > 0 || i >= early) {
          if (lane == 0) bar_wait(empty + 8 * slot, ((it / kRing) & 1) ^ 1);
          __syncwarp();
          const uint32_t dst = dst0 + slot * slot_bytes;
          const uint8_t* from = src + (size_t)i * kStage;
#pragma unroll
          for (int r = 0; r < kRows / kRowsAtOnce; ++r)
            if (row0 + r * kRowsAtOnce < rows)
              cp_async16(dst + r * kRowsAtOnce * kStage,
                         from + (size_t)r * kRowsAtOnce * L);
        }
        for (int q = lane; q < T * (kStage / 8); q += 32) {
          const int t = q / (kStage / 8);
          const int ch = q - t * (kStage / 8);
          cp_async16(at + x_off + t * (kStage * 2) + (xswz(ch, t) << 4),
                     x + (size_t)list[t] * L + (size_t)(a + i) * kStage +
                         ch * 8);
        }
        if (in_group == gs - 1 || i == nl - 1)
          for (int r = lane; r < rows; r += 32)
            cp_async4(at + s_off + r * 4, scales + (size_t)g * out + n0 + r);
        cp_async_arrive(full + 8 * slot);
        if (++in_group == gs) {
          in_group = 0;
          ++g;
        }
      }
      if (split > 1) {
        // the pass's two cluster phases: every rank's loop is done, every
        // rank's partials are in
        __syncwarp();
        cluster_arrive_relaxed();
        cluster_wait();
        cluster_arrive_release();
        cluster_wait();
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  constexpr int kStride = 32 * kConsumers;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int r0 = warp * 16 + gid;  // rows r0 and r0 + 8 of the block
  const int par = gid & 1;         // of r0, r0 + 8 and columns 8j + gid
  const int xe = 16 - 32 * par;    // from chunk e = 0 to e = 1
  int passes = 1;
  for (int k = 0, it0 = 0; k < passes; ++k, it0 += nl) {
    // the pass's pairs (once the last pass's are written), then the
    // producer may stream the pass
    if (k > 0) asm volatile("bar.sync 1, %0;" ::"n"(kStride) : "memory");
    if (warp == 0) {
      const int count = sel::collect_pairs(ids.ids, ids.n_experts, pairs,
                                           ex, k * cols, cols, list);
      if (lane == 0 && k == 0) info[1] = count;
    }
    asm volatile("bar.sync 1, %0;" ::"n"(kStride) : "memory");
    asm volatile("barrier.cta.arrive 2, %0;" ::"n"(kThreads) : "memory");
    const int count = info[1];
    passes = (count + cols - 1) / cols;
    const int T = min(cols, count - k * cols);
    DG_STAMP_IF(k == 0, 2);

    // this thread's chunk h of rows r0 and r0 + 8 and its x chunks 2·tig +
    // 8h + e of column 8j + gid in a slot
    const unsigned char* wrow[kH];
#pragma unroll
    for (int h = 0; h < kH; ++h)
      wrow[h] = ring + r0 * kStage + 16 * tig + 64 * (h ^ par);
    const unsigned char* xrow[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      xrow[j] = ring + x_off + min(8 * j + gid, T - 1) * (kStage * 2) +
                32 * tig + 16 * par;
    float tot[NT][4], cut[2][NT][4], acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tot[j][e] = cut[0][j][e] = cut[1][j][e] = acc[j][e] = 0.f;
    int g = a / gs, in_group = a - g * gs;
    const int first_group = g;
    for (int i = 0; i < nl; ++i) {
      const int it = it0 + i;
      const int slot = it & (kRing - 1);
      const int at = slot * slot_bytes;
      const bool group_end = in_group == gs - 1 || i == nl - 1;
      bar_wait(full + 8 * slot, (it / kRing) & 1);
      DG_STAMP_IF(k == 0 && i == 0, 3);
      // this thread's words of rows r0 and r0 + 8, its B fragments of the
      // stage (positions (0, 2), (1, 3) of each four, by byte permutes)
      // and, where the group ends, its rows' scales; then the slot is free
      uint32_t wd[2][kH][4], bx[kH][NT][4][2];
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        const unsigned char* w = wrow[h] + at;
        const uint4 v0 = *reinterpret_cast<const uint4*>(w);
        const uint4 v1 = *reinterpret_cast<const uint4*>(w + 8 * kStage);
        wd[0][h][0] = v0.x;
        wd[0][h][1] = v0.y;
        wd[0][h][2] = v0.z;
        wd[0][h][3] = v0.w;
        wd[1][h][0] = v1.x;
        wd[1][h][1] = v1.y;
        wd[1][h][2] = v1.z;
        wd[1][h][3] = v1.w;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint4 v = *reinterpret_cast<const uint4*>(
                xrow[j] + at + 128 * h + e * xe);
            bx[h][j][2 * e][0] = __byte_perm(v.x, v.y, 0x5410u);
            bx[h][j][2 * e][1] = __byte_perm(v.x, v.y, 0x7632u);
            bx[h][j][2 * e + 1][0] = __byte_perm(v.z, v.w, 0x5410u);
            bx[h][j][2 * e + 1][1] = __byte_perm(v.z, v.w, 0x7632u);
          }
      }
      float s0 = 0.f, s1 = 0.f;
      if (group_end) {
        const float* sp = reinterpret_cast<const float*>(ring + at + s_off);
        s0 = sp[r0];
        s1 = sp[r0 + 8];
      }
      __syncwarp();
      if (lane == 0) bar_arrive(empty + 8 * slot);

#pragma unroll
      for (int h = 0; h < kH; ++h)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const uint32_t t[4][1] = {{wd[0][h][u]},
                                    {wd[1][h][u]},
                                    {wd[0][h][u] >> 8},
                                    {wd[1][h][u] >> 8}};
          const uint32_t af[4] = {
              level_pair<P>(t[0], 0), level_pair<P>(t[1], 0),
              level_pair<P>(t[2], 0), level_pair<P>(t[3], 0)};
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(acc[j], af, bx[h][j][u]);
        }
      if (group_end) {
        // the group ends: scaled here when it lies inside the range,
        // kept unscaled for the cluster's sum when the range cuts it
        const bool whole = g * gs >= a && (g + 1) * gs <= b;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (whole) {
            tot[j][0] += acc[j][0] * s0;
            tot[j][1] += acc[j][1] * s0;
            tot[j][2] += acc[j][2] * s1;
            tot[j][3] += acc[j][3] * s1;
          } else if (g == first_group) {
#pragma unroll
            for (int e = 0; e < 4; ++e) cut[0][j][e] = acc[j][e];
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) cut[1][j][e] = acc[j][e];
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        }
      }
      if (++in_group == gs) {
        in_group = 0;
        ++g;
      }
    }
    DG_STAMP_IF(k + 1 == passes, 4);

    if (split == 1) {
      // no cluster: every group was whole, the totals are the pairs' y
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tok = 8 * j + 2 * tig + (e & 1);
          const int o = n0 + r0 + 8 * (e >> 1);
          if (tok < T && o < out)
            y[(size_t)list[tok] * out + o] = lowbit::cvt_out<OutT>(tot[j][e]);
        }
      DG_STAMP_IF(k + 1 == passes, 5);
      continue;
    }
    // every rank's loop is done: push this block's [body, cut 0, cut 1] of
    // each row to the rank that writes it (rank q: rows q·kRows/split ..),
    // at [this rank][kind][row][column]
    __syncwarp();
    cluster_arrive_release();
    cluster_wait();
    const int per = kRows / split;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = 8 * j + 2 * tig + (e & 1);
        const int row = r0 + 8 * (e >> 1);
        if (tok < T) {
          const int q = row / per;
          float* theirs = cluster.map_shared_rank(rx, q);
          const int at = ((rank * 3) * per + row - q * per) * T + tok;
          theirs[at] = tot[j][e];
          theirs[at + per * T] = cut[0][j][e];
          theirs[at + 2 * per * T] = cut[1][j][e];
        }
      }
    __syncwarp();
    cluster_arrive_release();
    cluster_wait();
    // this rank's rows: the ranks' partials summed in rank order; a cut
    // group's unscaled partials summed before its scale
    for (int e = threadIdx.x; e < per * T; e += kStride) {
      const int t = e / per;
      const int row = e - t * per;
      const int o = n0 + rank * per + row;
      if (o >= out) continue;
      float total = 0.f, open = 0.f;
      int open_g = -1;
      for (int r = 0; r < split; ++r) {
        const float* part = rx + ((r * 3) * per + row) * T + t;
        total += part[0];
        int cuts[2];
        cuts_of(r, split, n, gs, cuts);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (cuts[q] < 0) continue;
          if (cuts[q] != open_g) {
            if (open_g >= 0) total += open * scales[(size_t)open_g * out + o];
            open = 0.f;
            open_g = cuts[q];
          }
          open += part[(1 + q) * per * T];
        }
      }
      if (open_g >= 0) total += open * scales[(size_t)open_g * out + o];
      y[(size_t)list[t] * out + o] = lowbit::cvt_out<OutT>(total);
    }
    DG_STAMP_IF(k + 1 == passes, 5);
  }
}

// One launch of the grouped kernel (see launch_grouped).
template <class P, class Sel, int NT, int kCons, typename OutT>
cudaError_t launch_grouped_n(const __nv_bfloat16* x, const uint8_t* wq,
                             const float* scales, OutT* y, int pairs,
                             int out, int L, int gs, int cols, int split,
                             const lowbit::Ids& ids, cudaStream_t stream) {
  using B = GroupedBlock<kCons>;
  static std::atomic<uint64_t> done{0};
  const int slots = pairs < ids.n_experts ? pairs : ids.n_experts;
  const size_t smem = grouped_smem_bytes(B::kRows, cols);
  if (smem > (size_t)kMaxSmem || out > 65535 * B::kRows || slots > 65535)
    return cudaErrorInvalidValue;
  auto kernel = decode_gemv_grouped<P, Sel, NT, kCons, OutT>;
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
  cfg.gridDim = dim3(split, (out + B::kRows - 1) / B::kRows, slots);
  cfg.blockDim = dim3(B::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t l = cudaLaunchKernelEx(&cfg, kernel, x, wq, scales, y,
                                           pairs, out, L, gs, cols, ids);
  return l != cudaSuccess ? l : cudaGetLastError();
}

// The grouped pairs GEMV of format P (one plane, one part: int8) on
// `pairs` rows of bf16 x, each through the expert its id picks in the
// stack wq (E = ids.n_experts slabs of (out, L) bytes, at most
// Sel::kMaxExperts) with f32 scales (E, L / 128 / gs, out): cols columns
// a pass (1 to kMaxCols; up to 8 one token tile, past it two), rows the
// rows of a block (32 or 64), split the cluster's blocks (1, 2, 4 or 8,
// at most L / 128), all planned on the host from P, E and the shapes
// (ops/scaled_matmul.py pairs_plan). Returns the CUDA error of the launch
// (cudaErrorInvalidValue for what it does not take).
template <class P, class Sel, typename OutT>
cudaError_t launch_grouped(const __nv_bfloat16* x, const uint8_t* wq,
                           const float* scales, OutT* y, int pairs, int out,
                           int L, int gs, int cols, int rows, int split,
                           const lowbit::Ids& ids, cudaStream_t stream) {
  const int n = L / kStage;
  if (pairs < 1 || out < 1 || L < kStage || L % kStage || gs < 1 ||
      n % gs || cols < 1 || cols > kMaxCols || (rows != 32 && rows != 64) ||
      split < 1 || split > kMaxSplit || (split & (split - 1)) || split > n ||
      ids.ids == nullptr || ids.n_experts < 1 ||
      ids.n_experts > Sel::kMaxExperts)
    return cudaErrorInvalidValue;
  if (rows == 32)
    return cols <= 8 ? launch_grouped_n<P, Sel, 1, 2, OutT>(
                           x, wq, scales, y, pairs, out, L, gs, cols, split,
                           ids, stream)
                     : launch_grouped_n<P, Sel, 2, 2, OutT>(
                           x, wq, scales, y, pairs, out, L, gs, cols, split,
                           ids, stream);
  return cols <= 8 ? launch_grouped_n<P, Sel, 1, 4, OutT>(
                         x, wq, scales, y, pairs, out, L, gs, cols, split,
                         ids, stream)
                   : launch_grouped_n<P, Sel, 2, 4, OutT>(
                         x, wq, scales, y, pairs, out, L, gs, cols, split,
                         ids, stream);
}

}  // namespace dgemv
