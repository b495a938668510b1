// W4A16 / W8A16 mixed-precision GEMM over fragment-order packed weights.
//
// Replaces repro/kernels/mpgemm.py:137 mpgemm_2d (kernel body
// _mpgemm_kernel :45, nibble unpack _unpack_nibbles_tile :34), bits 4 and
// 8: y (M, N) bf16 = x (M, K) bf16 @ W, every weight entering the tensor
// cores as bf16(float(q) * scale) with its f32 group scale, accumulated in
// f32.  (wfp8 weights take bits 8: the JAX package stores them as
// per-group int8.)  W is in core/packing.to_kernel_layout's fragment order;
// a tile-major weight is refused by the wrapper.
//
// What bounds it on an H100 and what the design does about it:
// gemm_tile.cuh, the mainloop this kernel shares with mpgemm_int8.cu —
// swapped operands (weight columns are the rows of mma.sync m16n8k16 bf16,
// tokens its n8 columns), a cp.async ring of weights, scales and x, and
// split-K over a cluster combined in rank order over distributed shared
// memory.
#include "gemm_tile.cuh"

// x (M, K) bf16; w (N/16, ceil(K/64), 32, 4 * bits) int8 fragment order;
// scales (K/group, N) f32; y (M, N) bf16.  Takes bits in {4, 8}, group in
// {32, 64, 128}, K a multiple of 64 and of group or, at group 32, of 32,
// N a multiple of 16, and 16-byte aligned x, w and scales.  Returns the CUDA error of the launch
// (0 on success).
extern "C" int mpgemm_a16(const void* x, const void* w, const void* scales,
                          void* y, int bits, int M, int K, int N, int group,
                          void* stream) {
  const gemm::Args a{x,
                     nullptr,
                     static_cast<const int8_t*>(w),
                     static_cast<const float*>(scales),
                     static_cast<__nv_bfloat16*>(y),
                     M, K, N, group};
  return gemm::launch<false>(a, bits, static_cast<cudaStream_t>(stream));
}
