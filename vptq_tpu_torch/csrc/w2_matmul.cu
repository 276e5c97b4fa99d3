// K3 w2_matmul on Hopper (sm_90a): y = x @ ((unpack_int2(wq) + 0.5) ⊙ s)^T.
//
// Replaces vptq_tpu/ops/pallas_gemm.py:_w2_kernel (entry w2_matmul).
//
//   x      (T, in_p)          bf16
//   wq     (out, in_p / 4)    int8: bits 2q..2q+1 of byte k hold the
//                             two's-complement code c ∈ [−2, 1] of column
//                             q·in_p/4 + k (ops/packing.py pack_int2)
//   scales (out, in_p / G)    bf16, G = 64 or 128
//   y      (T, out)           bf16 / f32
//
// What bounds it on an H100: at decode the weight bytes, a quarter byte
// per weight plus 1/32 byte of scale at G = 64 (61.3 MB per
// Llama-3.1-8B layer, 0.018 ms at 3.35 TB/s); at T = 512 the bf16
// tensor-core FLOPs (0.226 ms per layer at 989 TFLOP/s).
//
// Design: four parts of L = in_p/4 columns; T <= 16 runs the Hopper
// decode GEMV of decode_gemv.cuh (a cp.async weight ring, a cluster that
// splits the positions, the tile's unpack into mma.sync, each quarter's
// x, products and folds in turn) where the wrapper planned a split
// (ops/scaled_matmul.py decode_split), else lowbit.cuh's GEMV; more tokens
// the Hopper tile of lowbit_tile.cuh (TMA ring, levels unpacked into bf16
// pairs in registers, wgmma), as K2 and K4 do.
// The level c + 0.5 is built exactly per weight: flipping the high bit of
// every 2-bit field maps c to v = c + 2 ∈ [0, 3]. The GEMV shifts v into
// the mantissa of 2^22 (half-unit steps) and subtracts 2^22 + 1.5. The tile
// cannot use the bf16 base 128 of int4 and int3, whose step of 1 holds no
// half: it puts 2v under the exponent of 64 (step ½), which gives the
// pair 64 + v, and subtracts 65.5 (bf16 0x4283, exact), leaving v − 1.5 =
// c + 0.5. The TPU kernel instead ran the integer codes through the MXU
// and added 0.5·s·Σx per group from precomputed group sums of x; on
// Hopper the exact half-integer level costs nothing extra, and the result
// is the same function up to summation order.
//
// Scales change every 64 columns at G = 64 (the default of every int2
// model): the gemv reduces over 4-lane sets; the decode GEMV folds each
// quarter after each of a thread's two 64-position chunks; the tile, whose
// weight stage is 128 positions, splits each part's 8 k16 steps into two
// commit groups of 4, each folded into the totals with its own scale
// after its wait (no second accumulator: the consumers have no registers
// to spare).
// The other design, 64-position weight stages with one x box a slab, was
// 7% slower on one H100 at T = 128, 512 and 2048 (twice the barrier round
// trips and copies). G = 128 runs the tile unsplit, as int4 and int3 do;
// G = 64 costs 12–15% over it.

#include "decode_gemv.cuh"
#include "lowbit_tile.cuh"

namespace {

// The name W2 tags this format's kernels in a profiler trace
// (w2_matmul.trace_tags).
struct W2 {
  static constexpr int kPlanes = 1;
  static constexpr int kParts = 4;
  __device__ static void prep(uint32_t (&w)[1][4]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) w[0][q] ^= 0xAAAAAAAAu;  // c -> c + 2
  }
  // level of quarter p at byte j of the 16: c + 0.5
  __device__ static float level(const uint32_t (&w)[1][4], int p, int j) {
    const uint32_t v = (w[0][j >> 2] >> (8 * (j & 3) + 2 * p)) & 0x3u;
    return __int_as_float(0x4A800000u | (v << 1)) - 4194305.5f;
  }
  // the prefill tile (lowbit_tile.cuh): every quarter reads the one plane;
  // t holds the bytes of two positions in bits 0-7 and 16-23, and quarter
  // p's pair is 64 + v in each bf16 half (2v in the mantissa, step ½), so
  // that subtracting 65.5 leaves v − 1.5 = c + 0.5
  static constexpr int kTileSlots = 1;
  static constexpr uint32_t kTileBias = 0x42834283u;  // bf16 (65.5, 65.5)
  __device__ static int tile_plane(int, int) { return 0; }
  __device__ static uint32_t tile_code(const uint32_t (&t)[1], int p) {
    return (((t[0] >> (2 * p)) & 0x00030003u) << 1) ^ 0x42844284u;
  }
};

}  // namespace

// split: the decode GEMV's cluster size at T <= 16 (ops/scaled_matmul.py
// decode_split; 0: lowbit.cuh's gemv). Returns the CUDA error of the
// launch (0 on success). Requires group 64 or 128, in_p % 512 == 0 (the
// stage of 128 positions a part), 16-byte aligned x and wq, all tensors
// contiguous on the current device.
extern "C" int vptq_w2_matmul(const void* x, const void* wq,
                              const void* scales, void* y, int T, int out,
                              int in_p, int group, int split, int out_dtype,
                              void* stream) {
  const int L = in_p / 4;
  const auto* w = static_cast<const uint8_t*>(wq);
  lowbit::Planes pl = {{w, nullptr, nullptr}, {L, 0, 0}, {0, 0, 0}};
  lowbit::Scales sc = {static_cast<const __nv_bfloat16*>(scales),
                       in_p / group, 1};
  if (T <= lowbit::tile::kDecodeMax && split > 0 &&
      (group == 64 || group == 128))
    return lowbit::with_out_type(out_dtype, [&](auto* tag) {
      using OutT = std::remove_pointer_t<decltype(tag)>;
      const auto* xb = static_cast<const __nv_bfloat16*>(x);
      auto* yo = static_cast<OutT*>(y);
      const auto s = static_cast<cudaStream_t>(stream);
      return group == 64
                 ? dgemv::launch<W2, sel::Whole, 64>(xb, pl, sc, yo, T, out,
                                                     L, 1, split, s)
                 : dgemv::launch<W2, sel::Whole, 128>(xb, pl, sc, yo, T, out,
                                                      L, 1, split, s);
    });
  if (group == 64)
    return lowbit::tile::launch<W2, 64>(x, pl, sc, y, T, out, in_p,
                                        out_dtype, stream);
  if (group == 128)
    return lowbit::tile::launch<W2, 128>(x, pl, sc, y, T, out, in_p,
                                         out_dtype, stream);
  return (int)cudaErrorInvalidValue;
}
