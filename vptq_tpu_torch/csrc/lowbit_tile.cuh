// The Hopper (sm_90a) prefill tile of the quantized formats at T > 16
// tokens: K1 w8_matmul, K2 w4_matmul, K3 w2_matmul, K4 w3_matmul, and K6a
// w8_matmul_expert and K6b w4_matmul_expert on one expert of a stack; and
// of K7 bf16_matmul's bf16 weights, in the SS form (last point below). It
// computes y = x @ (s ⊙ L)^T over the split layouts of lowbit.cuh, as
// lowbit.cuh's GEMV does: x is rounded to bf16, every level is exact in
// bf16, the products of one (row, scale group) are summed in f32, that
// f32 partial is multiplied by the group's scale (bf16; int8's f32), and
// the scaled partials are summed in f32. No scale is folded into a bf16
// weight. The byte layouts are the formats' own (w8.cuh, w4.cuh,
// w2_matmul.cu, w3_matmul.cu), bit for bit.
//
// What bounds it: at T = 512 the bf16 tensor-core operations (2·T·out·in_p,
// 0.226 ms per Llama-3.1-8B layer at 989 TFLOP/s); the int4 weight bytes
// take 0.034 ms. So the design feeds wgmma, the only way to the
// card's bf16 rate, and keeps the unpack off its path:
//  * The product is swapped: a block computes the tile y^T = W · x^T, with
//    128 output rows as M (two consumer warpgroups of 64) and N = 128
//    tokens. A, the weights, comes from registers (wgmma.mma_async
//    m64n128k16, the RS form); B, the x tile, from shared
//    memory, K-major with the 128-byte swizzle (a 64-position bf16 row is
//    128 bytes).
//  * Each thread unpacks only its own A-fragment elements (rows gid and
//    gid + 8 of its warp's 16, positions 2·tig, +1, +8, +9 of each 16) once
//    per token tile, straight into bf16 pairs: the bytes of two positions
//    are spread into the two halves (prmt), the format's code is put under
//    a bf16 exponent (lop3), giving base + code, and one bf16x2 fma
//    subtracts the bias, base + the code's offset; the policy chooses both
//    so that every step is exact in bf16 (int4 and int3: base 128, step 1;
//    int2's half levels: base 64, step ½; int8's 256 levels take two
//    exponents, so its code makes the signed level itself with one more
//    fma and its bias is 0). No conversion instruction runs and no level
//    touches shared memory.
//  * An asynchronous ring: one producer thread keeps TMA copies in flight,
//    a 128-position group of packed bytes for the block's 128 rows (int8,
//    int4 and int2 16 KB, int3 48 KB; as many stages as the x ring has
//    slabs' worth of positions, at least two: int8 4, the others 2) and
//    64-position x boxes (128 tokens each, four slabs of two boxes), with
//    full and empty mbarriers; setmaxnreg moves registers from the
//    producer warpgroup to the consumers.
//  * One position group of bytes feeds kParts x slabs (int8 1, int4 2,
//    int2 4, int3 8: x is kParts times wider than the bytes), so the bytes stay
//    resident while the x slabs of part 0, 1, ... stream through the ring,
//    group outer, part inner. Per part a
//    warpgroup unpacks its fragments, issues the 8 k16 steps into acc,
//    waits, and adds acc · s(row, group) into tot: two scales a thread,
//    since rows are M. A scale group G of 64 (int2's default) holds half a
//    stage: the 8 steps go as two commit groups of 4, each started with
//    scale-d 0 and folded with its own scales after its wait (no second
//    accumulator: the consumers hold 168 of their 232 registers). int8's
//    f32 scale groups of 512 to 2048 positions span 4 to 16 stages (a
//    run-time count, so K1 and K6a have one instance per output type):
//    acc sums them, each step after the group's first with scale-d 1, and
//    is folded into tot once, after the group's last wait. While one
//    consumer warpgroup unpacks, the other's wgmmas can run.
//  * One expert of a stack (Sel = sel::Expert, K6a, K6b): the weight maps are
//    3-D, {L, out, E}, and the producer reads the id from device memory
//    and passes it as the third coordinate of every weight copy; the
//    consumers read it too and move the scale pointer to the expert's
//    slab. The id never reaches the host and no slab is copied.
//  * The epilogue writes tot through shared memory, so the (T, out) stores
//    of y coalesce; the ragged T and out edges are masked, and TMA fills
//    the loads past T and past out with zeros (x past T adds 0; rows past
//    out get scale 0 and are never stored).
//  * bf16 weights (a policy with kTileSS, K7): nothing to unpack and no
//    scale, so A comes from shared memory too (wgmma.mma_async SS, both
//    operands through 128-byte-swizzled descriptors). A weight stage is
//    128 rows of 128 bf16 positions, 32 KB as two 64-position TMA boxes
//    like an x slab; each consumer warpgroup reads its 64 rows of it.
//    Four 32 KB x slabs leave room for three weight stages (four would
//    need 256 KB). tot takes every stage's products with scale-d 1 and is
//    written once; a warpgroup keeps one stage's wgmmas in flight
//    (wait_group 1) and frees the stage before it. The RS formats'
//    instances compile as they did: the SS path is a compile-time branch.
//
// A format policy P adds to its lowbit.cuh interface: kTileSlots, the
// planes one part reads; tile_plane(p, i), which plane feeds slot i of
// part p; tile_code(t, p), the bf16 pair base + code of part p from the
// spread bytes t of its slots; and kTileBias, the bf16 pair base + the
// code's offset (tests/test_torch_tile_codes.py checks every byte value
// of every policy against the plain unpack). The scales come as a
// ScalesOf<bf16> or ScalesOf<float> (lowbit.cuh).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lowbit.cuh"

namespace lowbit {
namespace tile {

constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kRows = 128;     // output rows per block
constexpr int kTokens = 128;   // tokens per block (N)
constexpr int kGroup = 128;    // positions of one weight stage
constexpr int kStages = 4;     // x slabs in the ring
constexpr int kPlaneTile = kRows * kGroup;  // bytes of one plane's stage
constexpr int kPad = 4;        // f32 padding of an epilogue row
constexpr int kDecodeMax = 16; // T up to this runs lowbit::gemv

// Whether format P's weights are bf16 that wgmma reads from shared memory
// (the SS form): no planes to unpack and no scales to fold.
template <class P, class = void>
struct TileSS : std::false_type {};
template <class P>
struct TileSS<P, std::void_t<decltype(P::kTileSS)>>
    : std::bool_constant<P::kTileSS> {};

// shared memory of one block (bytes), 1024-aligned tiles first
template <class P>
struct Smem {
  static constexpr bool kSS = TileSS<P>::value;
  static constexpr int kBox = kTokens * 128;  // one 64-position x box
  static constexpr int kSlab = 2 * kBox;
  static constexpr int kX = kStages * kSlab;
  static constexpr int kWBox = kRows * 128;   // SS: 64 bf16 positions
  // one weight stage: the planes' bytes of 128 positions, or (SS) two
  // boxes of 64 bf16 positions
  static constexpr int kWStage = kSS ? 2 * kWBox : P::kPlanes * kPlaneTile;
  // weight stages: as many position groups as the x ring holds slabs, at
  // least two (int8, one part: 4; the sub-byte formats: 2); SS: three,
  // all that fit beside the x ring
  static constexpr int kWStages =
      kSS ? 3 : (kStages / P::kParts > 2 ? kStages / P::kParts : 2);
  static constexpr int kW = kWStages * kWStage;
  static constexpr int kBars = (2 * kStages + 2 * kWStages) * 8;
  static constexpr int kBytes = kX + kW + kBars + 1024;  // + alignment
  static_assert(kTokens * (kRows + kPad) * 4 <= kX,
                "epilogue fits the x ring");
  static_assert(kBytes <= 232448, "one block's shared memory");
};

struct Maps {
  CUtensorMap x;              // (T, in_p) bf16, boxes of 128 x 64
  CUtensorMap w[kMaxPlanes];  // plane i: (out, L) bytes, boxes of 128 x 128;
                              // stacked: (E, out, L), boxes of 1 x 128 x 128
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// a 2-D box at (column c0, row c1) of a tensor map into shared memory,
// counted on the barrier's transaction bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// the descriptor of a K-major bf16 operand at addr: rows of 128 bytes with
// the 128-byte swizzle, 8-row atoms 1024 bytes apart
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// d (+)= A · B for one k16 step, both from shared memory through their
// descriptors (the SS form): A 64 x 16, B 16 x 128, both K-major
__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t desc_a,
                                       uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// the same into the slab of expert e of a 3-D map
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int e,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(e),
      "r"(bar)
      : "memory");
}

// acc as wgmma left it: the compiler may not read it before the wait
template <int M>
__device__ __forceinline__ void fence_acc(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a · B for one k16 step: A (64 x 16 bf16) from registers, B
// (16 x 128) from shared memory through its descriptor
__device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4],
                                    uint64_t desc, int accumulate) {
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
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// G: the scale group within a stage, 128 or 64 positions (two groups of
// each part in a stage); gstages: the stages of one scale group (1, or
// with G = 128 and one part a run-time count: int8's groups of 512 to
// 2048 positions span 4 to 16 stages, which acc sums before one fold).
// Sel: the whole weight, or the expert ids[0] of a stack; Sc: the scales'
// struct (bf16 or f32)
template <class P, class Sel, int G, typename OutT, class Sc>
__global__ void __launch_bounds__(kThreads, 1)
    wg_tile(const __grid_constant__ Maps maps, Sc sc, Ids ids,
            OutT* __restrict__ y, int T, int out, int L, int gstages) {
  static_assert(!Sel::kPairs, "a pairs launch runs the T = 1 gemv");
  static_assert(G == kGroup || G == kGroup / 2, "scale group 128 or 64");
  using S = Smem<P>;
  constexpr int kParts = P::kParts;
  constexpr int kW = S::kWStages;
  constexpr int kSplit = kGroup / G;  // scale groups of a part in a stage
  constexpr int kSteps = 8 / kSplit;  // k16 steps of one scale group
  constexpr int kAcc = kTokens / 2;   // f32 accumulators a thread holds
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const uint32_t raw = smem_u32(tile_smem);
  const uint32_t xs0 = (raw + 1023) & ~1023u;  // the x ring
  const uint32_t ws0 = xs0 + S::kX;            // the weight ring
  const uint32_t bars = ws0 + S::kW;
  // x_full[kStages], x_empty[kStages], w_full[kW], w_empty[kW]
  const uint32_t x_full = bars, x_empty = bars + 8 * kStages;
  const uint32_t w_full = bars + 16 * kStages, w_empty = w_full + 8 * kW;

  const int m0 = blockIdx.x * kTokens;  // first token
  const int n0 = blockIdx.y * kRows;    // first output row
  const int n_groups = L / kGroup;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      bar_init(x_full + 8 * i, 1);
      bar_init(x_empty + 8 * i, 256);
    }
    for (int i = 0; i < kW; ++i) {
      bar_init(w_full + 8 * i, 1);
      bar_init(w_empty + 8 * i, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // the producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      int e = 0;  // the expert: the third coordinate of a stacked map
      if constexpr (Sel::kIds)
        e = (int)sel::expert_of(ids.ids, ids.n_experts, 0);
      int it = 0;
      for (int gi = 0; gi < n_groups; ++gi) {
        const int ws = gi % kW;
        bar_wait(w_empty + 8 * ws, ((gi / kW) & 1) ^ 1);
        bar_expect(w_full + 8 * ws, S::kWStage);
        if constexpr (S::kSS) {
          // two 64-position boxes of the bf16 weight rows
          const uint32_t dst = ws0 + ws * S::kWStage;
          tma_load(dst, &maps.w[0], gi * kGroup, n0, w_full + 8 * ws);
          tma_load(dst + S::kWBox, &maps.w[0], gi * kGroup + 64, n0,
                   w_full + 8 * ws);
        } else {
#pragma unroll
          for (int i = 0; i < P::kPlanes; ++i) {
            const uint32_t dst = ws0 + (ws * P::kPlanes + i) * kPlaneTile;
            if constexpr (Sel::kIds)
              tma_load(dst, &maps.w[i], gi * kGroup, n0, e, w_full + 8 * ws);
            else
              tma_load(dst, &maps.w[i], gi * kGroup, n0, w_full + 8 * ws);
          }
        }
        for (int p = 0; p < kParts; ++p, ++it) {
          const int xs = it % kStages;
          bar_wait(x_empty + 8 * xs, ((it / kStages) & 1) ^ 1);
          bar_expect(x_full + 8 * xs, S::kSlab);
          const int col = p * L + gi * kGroup;
          tma_load(xs0 + xs * S::kSlab, &maps.x, col, m0, x_full + 8 * xs);
          tma_load(xs0 + xs * S::kSlab + S::kBox, &maps.x, col + 64, m0,
                   x_full + 8 * xs);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    // stages of one scale group: a run-time count only where a stage holds
    // one part (acc carries one part's sums), else 1, which leaves the
    // sub-byte formats' loop as it was
    const int gs = kParts == 1 ? gstages : 1;
    const int part_groups = L / (G * gs);  // scale groups of one part
    if constexpr (Sel::kIds)
      sc.s += sel::expert_of(ids.ids, ids.n_experts, 0) * out *
              (size_t)(kParts * part_groups);
    const int ctid = threadIdx.x - 128;
    const int lane = threadIdx.x & 31;
    const int gid = lane >> 2;
    const int tig = lane & 3;
    // tile row of this thread's fragment rows gid (r0) and gid + 8
    const int r0 = (ctid >> 7) * 64 + ((ctid >> 5) & 3) * 16 + gid;
    // spread the bytes of positions 2·tig and 2·tig + 1 of 8 into the
    // two halves of a word (bytes 1 and 3 are never read)
    const uint32_t spread = (2 * tig) * 0x11u + (2 * tig + 1) * 0x1100u;
    // chunk s of row r lies at chunk s ^ (r & 7); r0 & 7 == gid
    const uint32_t row0 = r0 * kGroup, row1 = (r0 + 8) * kGroup;
    const int o0 = n0 + r0, o1 = n0 + r0 + 8;
    constexpr uint32_t kOne = 0x3F803F80u;  // bf16 (1, 1)

    float acc[kAcc], tot[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = tot[i] = 0.f;

    if constexpr (S::kSS) {
      // bf16 weights: this warpgroup's 64 rows of each stage's two boxes
      // are A, the x slab B; tot sums every stage
      const uint32_t wrows = ws0 + (ctid >> 7) * 64 * 128;
      for (int gi = 0; gi < n_groups; ++gi) {
        const int ws = gi % kW, xs = gi % kStages;
        bar_wait(w_full + 8 * ws, (gi / kW) & 1);
        bar_wait(x_full + 8 * xs, (gi / kStages) & 1);
        const uint32_t wa = wrows + ws * S::kWStage;
        const uint32_t slab = xs0 + xs * S::kSlab;
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int s = 0; s < 8; ++s)
          mma_ss(tot, desc_sw128(wa + (s >> 2) * S::kWBox + (s & 3) * 32),
                 desc_sw128(slab + (s >> 2) * S::kBox + (s & 3) * 32),
                 gi > 0 || s > 0);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        // this stage's products stay in flight; the last stage's are done,
        // so its weight stage and x slab go back to the producer
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        fence_acc(tot);
        if (gi > 0) {
          bar_arrive(w_empty + 8 * ((gi - 1) % kW));
          bar_arrive(x_empty + 8 * ((gi - 1) % kStages));
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(tot);
    } else {
      // the A fragments of part p from weight stage ws: 8 k16 steps
      auto unpack = [&](uint32_t (&a)[8][4], int ws, int p) {
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          const uint32_t chunk = (uint32_t)(s ^ gid) << 4;
          // (row, half): r0 lo, r0 + 8 lo, r0 hi, r0 + 8 hi
          uint32_t t[4][P::kTileSlots];
#pragma unroll
          for (int i = 0; i < P::kTileSlots; ++i) {
            const uint32_t plane =
                ws0 + (ws * P::kPlanes + P::tile_plane(p, i)) * kPlaneTile +
                chunk;
            const uint4 q0 = lds128(plane + row0);
            const uint4 q1 = lds128(plane + row1);
            t[0][i] = __byte_perm(q0.x, q0.y, spread);
            t[1][i] = __byte_perm(q1.x, q1.y, spread);
            t[2][i] = __byte_perm(q0.z, q0.w, spread);
            t[3][i] = __byte_perm(q1.z, q1.w, spread);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
            a[s][j] = bf16x2_fma(P::tile_code(t[j], p), kOne,
                                 P::kTileBias ^ 0x80008000u);
        }
      };

      // in_group: this stage's place in its scale group; grp: the group (of
      // G·gs positions) the stage lies in
      int it = 0, in_group = 0, grp = 0;
      for (int gi = 0; gi < n_groups; ++gi) {
        const int ws = gi % kW;
        const bool last = gs == 1 || in_group == gs - 1;  // fold acc into tot
        bar_wait(w_full + 8 * ws, (gi / kW) & 1);
#pragma unroll 1
        for (int p = 0; p < kParts; ++p, ++it) {
          uint32_t a[8][4];
          unpack(a, ws, p);
          const int xs = it % kStages;
          bar_wait(x_full + 8 * xs, (it / kStages) & 1);
          __syncwarp();
          const uint32_t slab = xs0 + xs * S::kSlab;
          float s0[kSplit], s1[kSplit];
#pragma unroll
          for (int h = 0; h < kSplit; ++h) {
            asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
            for (int s = h * kSteps; s < (h + 1) * kSteps; ++s)
              mma(acc, a[s],
                  desc_sw128(slab + (s >> 2) * S::kBox + (s & 3) * 32),
                  s > h * kSteps || in_group > 0);
            asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
            if (h == 0 && last) {
              // group h' of part p at stage gi: p·part_groups + grp·kSplit + h'
#pragma unroll
              for (int k = 0; k < kSplit; ++k) {
                const int g = p * part_groups + grp * kSplit + k;
                s0[k] = o0 < out ? scale_of<P>(sc, o0, g, p) : 0.f;
                s1[k] = o1 < out ? scale_of<P>(sc, o1, g, p) : 0.f;
              }
            }
            asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
            fence_acc(acc);
            if (h == kSplit - 1) bar_arrive(x_empty + 8 * xs);
            if (last) {
#pragma unroll
              for (int i = 0; i < kAcc; ++i)
                tot[i] += acc[i] * ((i & 2) ? s1[h] : s0[h]);
            }
          }
        }
        bar_arrive(w_empty + 8 * ws);
        grp += last;
        in_group = last ? 0 : in_group + 1;
      }
    }

    // epilogue: tot (rows x tokens) through shared memory, the x ring now
    // that both warpgroups are done with it, to coalesced rows of y
    asm volatile("bar.sync 1, 256;" ::: "memory");
    float* stage = reinterpret_cast<float*>(tile_smem + (xs0 - raw));
    constexpr int kLd = kRows + kPad;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int tok = 8 * (i >> 2) + 2 * tig + (i & 1);
      stage[tok * kLd + r0 + 8 * ((i >> 1) & 1)] = tot[i];
    }
    asm volatile("bar.sync 1, 256;" ::: "memory");
    for (int i = ctid; i < kTokens * kRows; i += 256) {
      const int tok = i / kRows, row = i % kRows;
      if (m0 + tok < T && n0 + row < out)
        y[(size_t)(m0 + tok) * out + n0 + row] =
            cvt_out<OutT>(stage[tok * kLd + row]);
    }
  }
}

// --------------------------------------------------------------------
// launch

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, reached through the runtime so that
// the library needs no -lcuda; null where libcuda lacks it
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a (rows, cols) array with rows `stride` bytes apart, read in boxes of
// (box_rows, box_cols) with the 128-byte swizzle; loads past the edges
// read zeros. With depth > 0 the map has a third dimension of `depth`
// (rows, cols) slabs `depth_stride` bytes apart, read one slab a box.
inline bool encode(CUtensorMap* map, CUtensorMapDataType type,
                   const void* base, uint64_t rows, uint64_t cols,
                   uint64_t stride, uint32_t box_rows, uint32_t box_cols,
                   uint64_t depth = 0, uint64_t depth_stride = 0) {
  const EncodeTiled fn = encoder();
  const cuuint64_t dims[3] = {cols, rows, depth};
  const cuuint64_t strides[2] = {stride, depth_stride};
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn != nullptr &&
         fn(map, type, depth ? 3 : 2, const_cast<void*>(base), dims, strides,
            box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tile alone, on T > 16 tokens of bf16 x. group: the positions of one
// scale group, G itself, or (G = kGroup, one part) a multiple of the
// stage that divides L.
template <class P, class Sel, int G, typename OutT, class Sc>
cudaError_t launch_tile(const void* x, const Planes& pl, const Sc& sc,
                        const Ids& ids, OutT* y, int T, int out, int in_p,
                        int group, cudaStream_t stream) {
  const int L = in_p / P::kParts;
  const bool stages = G == kGroup && P::kParts == 1 && group % kGroup == 0;
  if (L % kGroup || group < G || L % group || (group != G && !stages))
    return cudaErrorInvalidValue;
  if (Sel::kIds && ids.n_experts < 1) return cudaErrorInvalidValue;
  Maps maps = {};
  if (!encode(&maps.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, T, in_p,
              (uint64_t)in_p * sizeof(__nv_bfloat16), kTokens, 64))
    return cudaErrorInvalidValue;
  for (int i = 0; i < P::kPlanes; ++i)
    if (!encode(&maps.w[i], CU_TENSOR_MAP_DATA_TYPE_UINT8,
                pl.base[i] + pl.off[i], out, L, pl.row_bytes[i], kRows,
                kGroup, Sel::kIds ? ids.n_experts : 0,
                (uint64_t)out * pl.row_bytes[i]))
      return cudaErrorInvalidValue;
  auto kernel = wg_tile<P, Sel, G, OutT, Sc>;
  constexpr int smem = Smem<P>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T + kTokens - 1) / kTokens, (out + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(maps, sc, ids, y, T, out, L,
                                           group / G);
  return cudaGetLastError();
}

template <class P, class Sel, int G, typename OutT>
cudaError_t launch_typed(const void* x, const Planes& pl, const Scales& sc,
                         const Ids& ids, OutT* y, int T, int out, int in_p,
                         cudaStream_t stream) {
  if ((in_p / P::kParts) % kGroup) return cudaErrorInvalidValue;
  if (T <= kDecodeMax)
    return launch_decode<P, Sel, G, OutT>(
        static_cast<const __nv_bfloat16*>(x), pl, sc, ids, y, T, out, in_p,
        in_p / P::kParts, stream);
  return launch_tile<P, Sel, G, OutT>(x, pl, sc, ids, y, T, out, in_p, G,
                                      stream);
}

// A launch of a format on bf16 x with scale group G: the whole weight, or
// (Sel = sel::Expert) expert ids[0] of a stack of ids.n_experts. T <= 16
// runs lowbit::gemv, more tokens the tile. out_dtype: 0 = bf16, 1 = f32.
template <class P, int G = kGroup, class Sel = sel::Whole>
int launch(const void* x, const Planes& pl, const Scales& sc, void* y, int T,
           int out, int in_p, int out_dtype, void* stream,
           const Ids& ids = Ids{nullptr, 0}) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_out_type(out_dtype, [&](auto* tag) {
    using OutT = std::remove_pointer_t<decltype(tag)>;
    return launch_typed<P, Sel, G, OutT>(x, pl, sc, ids, static_cast<OutT*>(y),
                                         T, out, in_p, s);
  });
}

}  // namespace tile
}  // namespace lowbit
