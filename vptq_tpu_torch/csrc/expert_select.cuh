// How a launch of a dequant-matmul picks its weight: the policies that
// turn K1 w8_matmul and K2 w4_matmul into the MoE kernels K6 (one expert
// of a stack for every token) and K5 (one expert per row of x).
//
// The stacked weights are (E, out, ...) arrays whose expert slabs lie
// out·row_bytes apart, and the expert ids are int32 values in device
// memory. The TPU kernels receive them by scalar prefetch and let them
// drive the block index maps (vptq_tpu/ops/pallas_gemm.py:284-292,
// :413-423); here every block reads its id itself and adds the slab
// offset, in 64 bits (expert 7 of Mixtral's int8 gate_up starts 822 MB
// into the array), to the weight and scale pointers. The host never
// sees the ids.
//
// The policy's name (Whole, Expert, Pairs) is part of each kernel's
// demangled name and tells the three apart in a profiler trace.

#pragma once

#include <stddef.h>

namespace sel {

// K1–K4: one weight, no ids.
struct Whole {
  static constexpr bool kIds = false;
  static constexpr bool kPairs = false;
};

// K6: ids[0] picks the expert that all T rows of x go through.
struct Expert {
  static constexpr bool kIds = true;
  static constexpr bool kPairs = false;
};

// K5: a grid axis is a pair p; row p of x goes through expert ids[p]
// into row p of y. Each pair runs one token's GEMV.
struct Pairs {
  static constexpr bool kIds = true;
  static constexpr bool kPairs = true;
};

// The pair this block serves (0 unless the launch is a pairs launch): the
// grid's y axis for the GEMVs of lowbit.cuh and w8.cuh (a grid of (row
// tiles, pairs)), z for decode_gemv.cuh's (a grid of (cluster, row
// blocks, pairs)).
template <class S, int kAxis = 1>
__device__ __forceinline__ int pair_of() {
  static_assert(kAxis == 1 || kAxis == 2, "pairs lie along y or z");
  return S::kPairs ? (int)(kAxis == 2 ? blockIdx.z : blockIdx.y) : 0;
}

// The expert of pair p, clamped into the stack so that a bad id cannot
// read outside it.
__device__ __forceinline__ size_t expert_of(const int* ids, int n_experts,
                                            int p) {
  const int e = __ldg(ids + p);
  return (size_t)max(0, min(e, n_experts - 1));
}

}  // namespace sel
