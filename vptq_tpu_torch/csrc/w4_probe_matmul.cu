// The int4 unpack probes P1a, P1b and P2 on Hopper (sm_90a): K2's function
// y = x @ (s ⊙ L)^T on K2's bytes, with the nibbles unpacked in other ways.
//
// Replaces examples/w4_wall_candidates.py:_prod_kernel and _fma16_kernel
// (entry run_variant) and examples/w4_unpack_ablation.py:_kernel (entry
// variant_matmul).
//
//   x      (T, in_p)         bf16, or f32 in the modes fma16f32 and t8
//   wq     (out, in_p / 2)   int8, split-half nibbles (w4.cuh), or for
//                            fma16 one byte 16·hi + lo per column pair
//   scales (in_p / 128, out) bf16
//   y      (T, out)          bf16 / f32
//
// Modes, each a format policy of lowbit.cuh's skeleton, so that beside
// K2 (w4::W4, the magic-number unpack) the card compares unpacks and
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
// per weight, 46.5 MB for the 22016 x 4096 gate_up of a 7B model, 0.014 ms
// at 3.35 TB/s); the question these modes ask is how many instructions
// per weight the unpack costs on top of the FMA.

#include "lowbit.cuh"

namespace unpack {

// byte j of the 16 loaded, sign-extended
__device__ __forceinline__ int sbyte(const uint32_t (&w)[1][4], int j) {
  return (int)(w[0][j >> 2] << (24 - 8 * (j & 3))) >> 24;
}

// The policy names (Prod, Shift28, Fma16) tag the kernels in a profiler
// trace, with the namespace (w4_probe_matmul.trace_tags).
struct Prod {
  static constexpr int kPlanes = 1;
  static constexpr int kParts = 2;
  __device__ static void prep(uint32_t (&)[1][4]) {}
  __device__ static float level(const uint32_t (&w)[1][4], int p, int j) {
    const int b = sbyte(w, j);
    return (float)(p == 0 ? (int)((uint32_t)b << 28) >> 28 : b >> 4);
  }
};

struct Shift28 {
  static constexpr int kPlanes = 1;
  static constexpr int kParts = 2;
  static constexpr bool kScaledParts = true;
  __device__ static void prep(uint32_t (&)[1][4]) {}
  __device__ static float level(const uint32_t (&w)[1][4], int p, int j) {
    const int b = sbyte(w, j);
    return (float)(p == 0 ? (int)((uint32_t)b << 28) : b >> 4);
  }
  __device__ static float part_scale(int p) {
    return p == 0 ? 0x1p-28f : 1.f;
  }
};

struct Fma16 {
  static constexpr int kPlanes = 1;
  static constexpr int kParts = 2;
  __device__ static void prep(uint32_t (&)[1][4]) {}
  __device__ static float level(const uint32_t (&w)[1][4], int p, int j) {
    const float f = (float)sbyte(w, j);
    const float hi = rintf(f * 0.0625f);
    return p == 0 ? fmaf(-16.f, hi, f) : hi;
  }
};

enum Mode { kProd, kShift28, kFma16, kFma16F32, kT8, kG256 };

}  // namespace unpack

// Returns the CUDA error of the launch (0 on success). Requires
// in_p % 256 == 0 (g256: % 512), 16-byte aligned x and wq, all tensors
// contiguous on the current device; mode as unpack::Mode.
extern "C" int vptq_w4_probe_matmul(const void* x, const void* wq,
                                    const void* scales, void* y, int T,
                                    int out, int in_p, int mode,
                                    int out_dtype, void* stream) {
  using namespace unpack;
  const auto* w = static_cast<const uint8_t*>(wq);
  const lowbit::Planes pl = {{w, nullptr, nullptr}, {in_p / 2, 0, 0},
                             {0, 0, 0}};
  const auto* s = static_cast<const __nv_bfloat16*>(scales);
  const lowbit::Scales sc = {s, 1, out};
  switch (mode) {
    case kProd:
      return lowbit::launch<Prod, 128>(x, pl, sc, y, T, out, in_p, out_dtype,
                                       stream);
    case kShift28:
      return lowbit::launch<Shift28, 128>(x, pl, sc, y, T, out, in_p,
                                          out_dtype, stream);
    case kFma16:
      return lowbit::launch<Fma16, 128>(x, pl, sc, y, T, out, in_p,
                                        out_dtype, stream);
    case kFma16F32:
      return lowbit::launch<Fma16, 128, sel::Whole, float>(
          x, pl, sc, y, T, out, in_p, out_dtype, stream);
    case kT8:
      return lowbit::launch<Prod, 128, sel::Whole, float>(
          x, pl, sc, y, T, out, in_p, out_dtype, stream);
    case kG256:
      return lowbit::launch<Prod, 256>(x, pl, {s, 1, 2 * out}, y, T, out,
                                       in_p, out_dtype, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
