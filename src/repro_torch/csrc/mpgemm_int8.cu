// W4A8 / W8A8 GEMM on the int8 tensor cores over fragment-order packed
// weights.
//
// Replaces repro/kernels/mpgemm.py:96 mpgemm_int8_2d (kernel body
// _mpgemm_int8_kernel :69): y (M, N) bf16 = (xq (M, K) int8 @ W) with
// per-token activation scales xscale (M, 1) f32 and W as in mpgemm.cu.
// Each group's s32 partial product is exact (W4 nibbles enter as 16 q, an
// exact s8, against a scale divided by 16, also exact); it is multiplied
// by its f32 group scale into an f32 accumulator, and xscale multiplies
// at the store.  The activations are quantized outside the kernel (plain
// torch ops), as the JAX package quantizes them outside its Pallas kernel.
//
// What bounds it on an H100 (bytes at decode, both at prefill, against the
// int8 tensor-core peak) and the design: gemm_tile.cuh, the mainloop this
// kernel shares with mpgemm.cu, with mma.sync m16n8k32 s8 and x fragments
// from ldmatrix.
#include "gemm_tile.cuh"

// xq (M, K) int8; xscale (M,) f32; w (N/16, K/64, 32, 4 * bits) int8
// fragment order; scales (K/group, N) f32; y (M, N) bf16.  Takes what
// mpgemm_a16 takes.  Returns the CUDA error of the launch (0 on success).
extern "C" int mpgemm_int8(const void* x, const void* xs, const void* w,
                           const void* scales, void* y, int bits, int M,
                           int K, int N, int group, void* stream) {
  const gemm::Args a{x,
                     static_cast<const float*>(xs),
                     static_cast<const int8_t*>(w),
                     static_cast<const float*>(scales),
                     static_cast<__nv_bfloat16*>(y),
                     M, K, N, group};
  return gemm::launch<true>(a, bits, static_cast<cudaStream_t>(stream));
}
