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
// bf16 at the end. exp is exp2 with log2(e) folded into the scale, by the
// special function unit (ex2.approx.ftz): a p below 2^-126 of its row's
// largest is flushed to 0, which changes no f32 sum of at least 1.
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
// here blocks run in no order, so a block owns a 128-query tile of one
// head and loops over its K/V tiles itself. The design feeds wgmma:
//  * Warp specialisation: one producer thread issues TMA copies (the Q
//    tile once, then a ring of kStages K and V tiles of 128 positions on
//    full and empty mbarriers); two consumer warpgroups own 64 query rows
//    each; setmaxnreg moves registers from the producer warpgroup to the
//    consumers (S 64, O up to 64 and P 32 registers a thread at D = 128).
//  * The maps are 4-D, (D, heads, S, B), built per launch from the
//    tensors' own strides, so v's fused row and GQA need no copy. Boxes
//    are 64 head positions wide (128 bytes, the 128-byte swizzle): D = 96
//    takes two, and TMA fills the second box's columns 96-127 with zeros
//    (past D in the map), which the 6 k16 steps of q.k never read. Rows
//    at or past S read zeros: their keys are masked for every stored row,
//    and their queries are never stored.
//  * S = Q K^T: wgmma m64n128k16 in the SS form, Q and K both K-major in
//    swizzled shared memory. O += P V: wgmma m64nDk16 in the RS form: the
//    f32 score fragment, packed pairwise to bf16, is the A fragment as it
//    lies, so P never touches shared memory; V is the MN-major B operand
//    (the descriptor's transpose bit; 64-position boxes 16 KB apart).
//  * Overlap, both ways: within a warpgroup the products of tile j (Q K_j^T)
//    and of tile j - 1 (P V_{j-1}) are issued together, and the softmax of
//    tile j runs while P V_{j-1} is still on the tensor cores (O is
//    rescaled once that product is done); between the two warpgroups a
//    ping-pong on named barriers 2 and 3 lets one issue its products only
//    after the other has issued its own, so that one's softmax runs under
//    the other's products. The softmax (16384 exp2 a 128 x 128 tile, at
//    16 a clock an SM) costs about half the tile's tensor-core time. On an
//    H100 the ping-pong took 7% off S = 2048, the overlap within a
//    warpgroup 2-4%, ex2.approx.ftz in place of exp2f (no subnormal
//    fix-up around each ex2) 3.5%, and a third K/V stage nothing
//    (PERF.md, Findings).
//  * Causal schedule: tiles above the diagonal are never loaded, only the
//    diagonal tile is masked (BM == BN); the heaviest query tiles run
//    first, and the query heads that share a KV head are adjacent blocks,
//    so their K/V tiles are L2 hits.

#include "lowbit_tile.cuh"  // mbarriers, TMA, the SS wgmma, the map encoder

#include <math.h>

namespace fa {

using lowbit::tile::bar_arrive;
using lowbit::tile::bar_expect;
using lowbit::tile::bar_init;
using lowbit::tile::bar_wait;
using lowbit::tile::desc_sw128;
using lowbit::tile::fence_acc;
using lowbit::tile::mma_ss;
using lowbit::tile::smem_u32;

constexpr int BM = 128;  // queries per block: two consumer warpgroups of 64
constexpr int BN = 128;  // K/V positions per tile
constexpr int kStages = 2;
constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr int kBox = 128 * 128;  // one box: 128 rows of 64 bf16
// DEFAULT_MASK_VALUE of the TPU op: -0.7 * max f32
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

// shared memory of one block (bytes): Q, the K ring, the V ring, 1024-aligned
template <int D>
struct Smem {
  static constexpr int kTile = (D + 63) / 64 * kBox;  // Q, or one K / V stage
  static constexpr int kK = kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBars = kV + kStages * kTile;
  // q_full, k_full[], v_full[], k_empty[], v_empty[]
  static constexpr int kBytes = kBars + (1 + 4 * kStages) * 8 + 1024;
  static_assert(kBytes <= 232448, "one block's shared memory");
};

struct Maps {
  CUtensorMap q, k, v;  // (D, heads, S, B) bf16, boxes of 64 x 1 x 128 x 1
};

// a 4-D box at (c0, c1, c2, c3) of a tensor map into shared memory,
// counted on the barrier's transaction bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// the descriptor of an MN-major bf16 operand at addr: rows of 128 bytes
// (64 MN positions) with the 128-byte swizzle, 8-row atoms 1024 bytes
// apart along K, the next 64 MN positions one box (16 KB) on
__device__ __forceinline__ uint64_t desc_mn_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kBox >> 4) << 16) |
         (64ull << 32) | (1ull << 62);
}

// d += a · B for one k16 step: A (64 x 16 bf16) from registers, B (16 x N)
// from shared memory, MN-major (imm-trans-b 1); N = 128, 96 or 64
__device__ __forceinline__ void mma_pv(float (&d)[64],
                                       const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void mma_pv(float (&d)[48],
                                       const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void mma_pv(float (&d)[32],
                                       const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// 2^x by the special function unit, a result below 2^-126 flushed to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragments of an RS wgmma stay live until its wait: the compiler may
// not reuse their registers while the tensor cores still read them
__device__ __forceinline__ void fence_frag(uint32_t (&p)[BN / 16][4]) {
#pragma unroll
  for (int i = 0; i < BN / 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(p[i][j])::"memory");
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wgmma(const __grid_constant__ Maps maps,
                __nv_bfloat16* __restrict__ o, int B, int S, int H, int group,
                int n_qt, float scale_log2e) {
  using L = Smem<D>;
  constexpr int kBoxes = (D + 63) / 64;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  const uint32_t qs = (smem_u32(fa_smem) + 1023) & ~1023u;
  const uint32_t ks = qs + L::kK, vs = qs + L::kV;
  const uint32_t q_full = qs + L::kBars;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;

  // block -> (query tile, sequence, head): the heaviest query tiles first,
  // and the query heads of one KV head side by side
  const int h = blockIdx.x % H;
  const int b = (blockIdx.x / H) % B;
  const int qt = n_qt - 1 - blockIdx.x / (H * B);
  const int m0 = qt * BM;
  const int n_kt = qt + 1;  // K/V tiles up to and including the diagonal

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int i = 0; i < kStages; ++i) {
      bar_init(k_full + 8 * i, 1);
      bar_init(v_full + 8 * i, 1);
      bar_init(k_empty + 8 * i, 256);
      bar_init(v_empty + 8 * i, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // the producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      const int kvh = h / group;
      bar_expect(q_full, L::kTile);
#pragma unroll
      for (int x = 0; x < kBoxes; ++x)
        tma_load(qs + x * kBox, &maps.q, 64 * x, h, m0, b, q_full);
      for (int j = 0; j < n_kt; ++j) {
        const int st = j % kStages;
        const uint32_t empty = ((j / kStages) & 1) ^ 1;
        bar_wait(k_empty + 8 * st, empty);
        bar_expect(k_full + 8 * st, L::kTile);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x)
          tma_load(ks + st * L::kTile + x * kBox, &maps.k, 64 * x, kvh,
                   j * BN, b, k_full + 8 * st);
        bar_wait(v_empty + 8 * st, empty);
        bar_expect(v_full + 8 * st, L::kTile);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x)
          tma_load(vs + st * L::kTile + x * kBox, &maps.v, 64 * x, kvh,
                   j * BN, b, v_full + 8 * st);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int ctid = threadIdx.x - 128;
    const int lane = threadIdx.x & 31;
    const int gid = lane >> 2;
    const int tig = lane & 3;
    // tile row of this thread's fragment rows gid (r) and gid + 8
    const int row0 = (ctid >> 7) * 64 + ((ctid >> 5) & 3) * 16 + gid;
    // this warpgroup's 64 query rows of each Q box
    const uint32_t qa = qs + (ctid >> 7) * 64 * 128;

    float s[BN / 2];    // scores, then p, of one K/V tile
    float acc[D / 2];   // O
    uint32_t p[BN / 16][4];  // p in bf16 pairs: the A fragments of P V
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    // rows gid and gid + 8: running max (of the scores times log2 e) and
    // this thread's share of the running sum
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};

    // S = Q K^T of K stage st, issued as one commit group
    auto qk = [&](int st) {
      const uint32_t kb = ks + st * L::kTile;
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss(s, desc_sw128(qa + (kk >> 2) * kBox + (kk & 3) * 32),
               desc_sw128(kb + (kk >> 2) * kBox + (kk & 3) * 32), kk > 0);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    };
    // O += P V of V stage st, issued as one commit group
    auto pv = [&](int st) {
      const uint32_t vb = vs + st * L::kTile;
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        mma_pv(acc, p[kk], desc_mn_sw128(vb + kk * 16 * 128));
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    };
    // scale, causal mask (the diagonal tile only), running max and sum;
    // s becomes p; alpha rescales what O held before this tile
    auto softmax = [&](bool diag, float (&alpha)[2]) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        float v = s[i] * scale_log2e;
        if (diag) {
          const int col = 8 * (i >> 2) + 2 * tig + (i & 1);
          if (col > row0 + 8 * ((i >> 1) & 1)) v = kMaskValue;
        }
        s[i] = v;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], v);
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // column 0 of the first tile is never masked, so m_new is finite
        const float m_new = fmaxf(m_run[r], mx[r]);
        alpha[r] = exp2_ftz(m_run[r] - m_new);
        m_run[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const float e = exp2_ftz(s[i] - m_run[(i >> 1) & 1]);
        s[i] = e;
        rs[(i >> 1) & 1] += e;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
    };
    // p rounded to bf16, in the A fragment order of k16 step kk: (row gid,
    // positions 2·tig, +1), (gid + 8, the same), then both at + 8
    auto pack = [&]() {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          p[kk][j] = pack_bf16x2(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
    };

    // the ping-pong: a warpgroup issues its products in its turn (named
    // barrier 2 + wg), then hands the turn to the other, so that one's
    // softmax runs under the other's products
    const int wg = ctid >> 7;
    auto my_turn = [&] {
      asm volatile("bar.sync %0, 256;" ::"r"(2 + wg) : "memory");
    };
    auto hand_over = [&] {
      asm volatile("bar.arrive %0, 256;" ::"r"(3 - wg) : "memory");
    };
    if (wg == 1) hand_over();  // warpgroup 0 goes first

    float alpha[2];
    bar_wait(q_full, 0);
    bar_wait(k_full, 0);
    my_turn();
    qk(0);
    hand_over();
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(s);
    bar_arrive(k_empty);
    softmax(qt == 0, alpha);  // O is still 0
    pack();
    for (int j = 1; j < n_kt; ++j) {
      const int st = j % kStages, pst = (j - 1) % kStages;
      bar_wait(k_full + 8 * st, (j / kStages) & 1);
      bar_wait(v_full + 8 * pst, ((j - 1) / kStages) & 1);
      my_turn();
      qk(st);
      pv(pst);
      hand_over();
      // Q K_j^T is done; P V_{j-1} runs on under this tile's softmax
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_acc(s);
      bar_arrive(k_empty + 8 * st);
      softmax(j == qt, alpha);
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(acc);
      fence_frag(p);
      bar_arrive(v_empty + 8 * pst);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      pack();
    }
    const int lst = (n_kt - 1) % kStages;
    bar_wait(v_full + 8 * lst, ((n_kt - 1) / kStages) & 1);
    my_turn();
    pv(lst);
    hand_over();
    if (wg == 0) my_turn();  // the other's last hand-over
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(acc);
    fence_frag(p);

    // one division by the row's sum, one rounding to bf16
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = m0 + row0 + 8 * r;
      if (row >= S) continue;
      __nv_bfloat16* orow =
          o + (((long long)b * S + row) * H + h) * D + 2 * tig;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + 8 * n) = pack_bf16x2(
            acc[4 * n + 2 * r] / l, acc[4 * n + 2 * r + 1] / l);
    }
  }
}

// a (B, S, heads, D) bf16 tensor with the given element strides as a 4-D
// map read in boxes of 64 x 1 x 128 x 1 with the 128-byte swizzle; reads
// past D or S give zeros
inline bool encode(CUtensorMap* map, const void* base, int B, int S,
                   int heads, int D, long long sb, long long ss) {
  const lowbit::tile::EncodeTiled fn = lowbit::tile::encoder();
  constexpr uint64_t e = sizeof(__nv_bfloat16);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {D * e, ss * e, sb * e};
  const cuuint32_t box[4] = {64, 1, BN, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, __nv_bfloat16* o, int B, int S,
                   int H, int KV, long long q_sb, long long q_ss,
                   long long k_sb, long long k_ss, long long v_sb,
                   long long v_ss, float scale, cudaStream_t stream) {
  Maps maps = {};
  if (!encode(&maps.q, q, B, S, H, D, q_sb, q_ss) ||
      !encode(&maps.k, k, B, S, KV, D, k_sb, k_ss) ||
      !encode(&maps.v, v, B, S, KV, D, v_sb, v_ss))
    return cudaErrorInvalidValue;
  auto kernel = flash_wgmma<D>;
  constexpr int smem = Smem<D>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int n_qt = (S + BM - 1) / BM;
  kernel<<<n_qt * H * B, kThreads, smem, stream>>>(
      maps, o, B, S, H, H / KV, n_qt,
      (float)((double)scale * 1.4426950408889634));
  return cudaGetLastError();
}

}  // namespace fa

// Strides in elements: *_sb between batches, *_ss between positions (0
// where that dimension has one element); a head's D values are
// contiguous and heads lie D apart. Requires D in {64, 96, 128},
// H % KV == 0, S >= 1, at most 2^31 - 1 blocks of 128 queries and one
// head, 16-byte aligned pointers and strides that are multiples of 8.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int vptq_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, int B, int S,
                                    int H, int KV, int D, long long q_sb,
                                    long long q_ss, long long k_sb,
                                    long long k_ss, long long v_sb,
                                    long long v_ss, float scale,
                                    void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV ||
      (long long)((S + fa::BM - 1) / fa::BM) * H * B > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  // a map's stride along a dimension of one element is never used, but
  // must be a valid one: the extent of what lies inside it
  if (q_ss == 0) q_ss = (long long)H * D;
  if (k_ss == 0) k_ss = (long long)KV * D;
  if (v_ss == 0) v_ss = (long long)KV * D;
  if (q_sb == 0) q_sb = q_ss * S;
  if (k_sb == 0) k_sb = k_ss * S;
  if (v_sb == 0) v_sb = v_ss * S;
  auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* kp = static_cast<const __nv_bfloat16*>(k);
  auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)fa::launch<64>(qp, kp, vp, op, B, S, H, KV, q_sb, q_ss,
                                 k_sb, k_ss, v_sb, v_ss, scale, s);
    case 96:
      return (int)fa::launch<96>(qp, kp, vp, op, B, S, H, KV, q_sb, q_ss,
                                 k_sb, k_ss, v_sb, v_ss, scale, s);
    case 128:
      return (int)fa::launch<128>(qp, kp, vp, op, B, S, H, KV, q_sb, q_ss,
                                  k_sb, k_ss, v_sb, v_ss, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
