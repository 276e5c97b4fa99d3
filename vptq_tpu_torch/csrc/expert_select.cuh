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
// The policy's name (Whole, Expert, Pairs, Grouped) is part of each
// kernel's demangled name and tells them apart in a profiler trace.

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

// K5a: the pairs grouped by expert on the card. A grid axis is a slot s
// of min(P, E): the block serves the s-th distinct expert the pairs pick
// (in ascending id), with all of that expert's pairs as the columns of
// its product, in ascending p, kCols-column passes at a time; a slot past
// the distinct experts has nothing to do. Everything is found in the
// block from the ids in device memory: a bitmap of the experts present
// (kMaxExperts bits), the s-th set bit from popcounts, then one warp's
// ballots over the ids for the expert's pairs. The grid depends on P, E
// and the shapes alone, never on the ids' values.
struct Grouped {
  static constexpr bool kIds = true;
  static constexpr bool kPairs = true;
  static constexpr int kMaxExperts = 256;  // the bitmap's bits
  static constexpr int kWords = kMaxExperts / 32;
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

// The experts pairs 0 .. P - 1 pick, as bits of `bits` (Grouped::kWords
// words, zeroed before): each thread of the block marks every
// blockDim.x-th pair's (clamped) expert. A __syncthreads() must follow.
__device__ __forceinline__ void mark_experts(const int* ids, int n_experts,
                                             int P, unsigned* bits) {
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int e = (int)expert_of(ids, n_experts, p);
    atomicOr(bits + (e >> 5), 1u << (e & 31));
  }
}

// The s-th set bit of the bitmap (Grouped::kWords words), or -1 where
// fewer than s + 1 bits are set: lanes 0 .. kWords - 1 of one warp each
// count one word, a shuffle scan gives each word's first rank, and the
// lane whose word holds rank s finds the bit in it. Every lane of the
// warp calls it and gets the answer.
__device__ __forceinline__ int nth_expert(const unsigned* bits, int s) {
  const int lane = threadIdx.x & 31;
  const unsigned word = lane < Grouped::kWords ? bits[lane] : 0u;
  const int n = __popc(word);
  int below = n;  // inclusive scan of the counts over the lanes
#pragma unroll
  for (int d = 1; d < Grouped::kWords; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, below, d);
    if (lane >= d) below += v;
  }
  below -= n;  // the bits set in the words before this lane's
  const bool here = s >= below && s < below + n;
  int e = -1;
  if (here) {
    // clear the word's lowest s - below set bits; the next is the one
    unsigned w = word;
    for (int k = below; k < s; ++k) w &= w - 1u;
    e = 32 * lane + __ffs(w) - 1;
  }
  const unsigned who = __ballot_sync(0xffffffffu, here);
  return who ? __shfl_sync(0xffffffffu, e, __ffs(who) - 1) : -1;
}

// The pairs of expert e in ascending p, by one warp's ballots over the
// ids 32 at a time: those of rank from .. from + n - 1 among them go to
// cols[rank - from]. Returns the expert's count of pairs (every lane).
__device__ __forceinline__ int collect_pairs(const int* ids, int n_experts,
                                             int P, int e, int from, int n,
                                             int* cols) {
  const int lane = threadIdx.x & 31;
  int seen = 0;
  for (int base = 0; base < P; base += 32) {
    const int p = base + lane;
    const bool mine = p < P && (int)expert_of(ids, n_experts, p) == e;
    const unsigned hit = __ballot_sync(0xffffffffu, mine);
    const int rank = seen + __popc(hit & ((1u << lane) - 1u));
    if (mine && rank >= from && rank < from + n) cols[rank - from] = p;
    seen += __popc(hit);
  }
  return seen;
}

}  // namespace sel
