// K2 w4_matmul on Hopper (sm_90a): y = x @ (scales^T ⊙ unpack_int4(wq))^T.
//
// Replaces vptq_tpu/ops/pallas_gemm.py:_w4_kernel (entry w4_matmul).
//
//   x      (T, in_p)        bf16
//   wq     (out, in_p / 2)  int8, split-half nibbles (w4.cuh)
//   scales (in_p / 128, out) bf16, one per (128-column group, row)
//   y      (T, out)         bf16 / f32
//
// What bounds it on an H100: at decode the weight bytes, half a byte per
// weight plus 1/64 byte of scale (112.5 MB per Llama-3.1-8B layer,
// 0.034 ms at 3.35 TB/s); at T = 512 the bf16 tensor-core FLOPs
// (2·T·out·in_p, 0.226 ms per layer at 989 TFLOP/s).
//
// Design: the int4 format of w4.cuh on one whole weight; T <= 16 runs
// the Hopper decode GEMV of decode_gemv.cuh (a bulk-copy weight ring, a
// cluster that splits the positions, the tile's unpack into mma.sync),
// more tokens the Hopper tile of lowbit_tile.cuh (TMA ring, levels
// unpacked into bf16 pairs in registers, wgmma).

#include "w4.cuh"

// split: the decode GEMV's cluster size at T <= 16 (ops/scaled_matmul.py
// decode_split; 0: lowbit.cuh's gemv). Returns the CUDA error of the
// launch (0 on success). Requires in_p % 256 == 0, 16-byte aligned x and
// wq, all tensors contiguous on the current device.
extern "C" int vptq_w4_matmul(const void* x, const void* wq,
                              const void* scales, void* y, int T, int out,
                              int in_p, int split, int out_dtype,
                              void* stream) {
  return w4::launch<sel::Whole>(x, wq, scales, nullptr, y, T, out, in_p, 0,
                                out_dtype, stream, split);
}
