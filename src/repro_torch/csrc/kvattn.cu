// Multi-query flash-decode attention over the dense KV slab, all four KV
// formats (kv8, kv4, kvfp8, kv16).
//
// Replaces repro/kernels/kvattn.py:147 kvattn_decode_grouped (kernel body
// _kvattn_kernel, :115): the paged kernel's walk over the slab
// (B, S, Hkv, ROW_BYTES) in block_s-token tiles, tile s at logical
// positions s * block_s + j.
//
// What bounds it on an H100: bytes — the stored K/V of the live tiles
// plus two f32 scales per token, against 4 * D flops per (query row,
// key) — and, at the serve's few hundred keys a slot, the latency of a
// walk in series.  It runs the paged kernel's block program
// (flash::decode_rows): each block visits only the tiles up to its rows'
// frontier (the Pallas grid visits every tile of the slab, masked ones
// included), the walk is split over a cluster of 8 blocks by logical tile
// index and combined in rank order, the dots run on mma.sync and the
// stored bytes come through a cp.async ring.  The split, the tile shape
// and the per-row arithmetic are the paged kernel's, so the dense and
// paged backends give bitwise equal outputs on the same logical contents
// when block_s equals the pool's block_size.
//
// Shared memory grows with block_s: at D = 128 a 256-token tile needs more
// than the 227 KB a block may use, and the launch is refused with
// flash::ERR_SMEM (the wrapper raises) rather than split.
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_block.cuh"

namespace {

using flash::Fmt;

template <Fmt F, int D>
__global__ void __launch_bounds__(flash::THREADS)
kvattn_kernel(const __nv_bfloat16* __restrict__ q,
              const uint8_t* __restrict__ k, const float* __restrict__ k_scale,
              const uint8_t* __restrict__ v, const float* __restrict__ v_scale,
              const int* __restrict__ pos, __nv_bfloat16* __restrict__ out,
              int Hkv, int R, int rep, int S, int bs, int window) {
  flash::decode_rows<F, D>(
      q, k, k_scale, v, v_scale, pos, out, Hkv, R, rep, bs, S / bs, window,
      [=](int b, int s) { return size_t(b) * S + size_t(s) * bs; });
}

struct Launch {
  const void *q, *k, *ks, *v, *vs, *pos;
  void* out;
  int B, Hkv, R, rep, S, bs, window;
  cudaStream_t stream;

  template <Fmt F, int D>
  int run() const {
    return flash::launch_rows<F, D>(
        kvattn_kernel<F, D>, B, Hkv, R, bs, stream,
        static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(k),
        static_cast<const float*>(ks), static_cast<const uint8_t*>(v),
        static_cast<const float*>(vs), static_cast<const int*>(pos),
        static_cast<__nv_bfloat16*>(out), Hkv, R, rep, S, bs, window);
  }
};

}  // namespace

// fmt: 0 kv8, 1 kv4, 2 kvfp8, 3 kv16 (flash::Fmt).  q (B, Hkv, R, D) bf16;
// k/v (B, S, Hkv, ROW_BYTES) stored; scales (B, S, Hkv) f32; pos (B,)
// int32; out (B, Hkv, R, D) bf16; bs divides S.  Returns the CUDA error of
// the launch (0 on success), or flash::ERR_SMEM when a bs-token tile does
// not fit in shared memory.
extern "C" int kvattn(const void* q, const void* k, const void* ks,
                      const void* v, const void* vs, const void* pos,
                      void* out, int fmt, int B, int Hkv, int R, int D,
                      int rep, int S, int bs, int window, void* stream) {
  if (bs < 1 || S % bs) return int(cudaErrorInvalidValue);
  const Launch l{q, k, ks, v, vs, pos, out, B, Hkv, R, rep, S, bs, window,
                 static_cast<cudaStream_t>(stream)};
  return flash::dispatch(fmt, D, l);
}
