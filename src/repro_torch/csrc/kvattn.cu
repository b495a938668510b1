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
// Shared memory grows with block_s: a tile that needs more than the 227 KB
// a block may use (at D 64 kv8 past 397 tokens: the engine's one
// whole-sequence tile when block_size does not divide max_seq) is walked
// as sub-tiles that fit (flash::sub_rows), a fixed cut of (D, format,
// block_s), so dense ≡ paged holds at any tile height.
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_block.cuh"

namespace {

using flash::Fmt;

template <Fmt F, int D, bool SUB>
__global__ void __launch_bounds__(flash::threads(D))
kvattn_kernel(const __nv_bfloat16* __restrict__ q,
              const uint8_t* __restrict__ k, const float* __restrict__ k_scale,
              const uint8_t* __restrict__ v, const float* __restrict__ v_scale,
              const int* __restrict__ pos, __nv_bfloat16* __restrict__ out,
              float* __restrict__ lse, int Hkv, int R, int rep, int S,
              int bs, int window, int key0) {
  flash::decode_rows<F, D, SUB>(
      q, k, k_scale, v, v_scale, pos, lse == nullptr ? out : nullptr, Hkv,
      R, rep, bs, S / bs, window,
      [=](int b, int s) { return size_t(b) * S + size_t(s) * bs; }, key0,
      lse, lse == nullptr ? nullptr : reinterpret_cast<float*>(out));
}

struct Launch {
  const void *q, *k, *ks, *v, *vs, *pos;
  void *out, *lse;
  int B, Hkv, R, rep, S, bs, window, key0;
  cudaStream_t stream;

  template <Fmt F, int D>
  int run() const {
    return flash::launch_rows<F, D>(
        kvattn_kernel<F, D, false>, kvattn_kernel<F, D, true>, B, Hkv, R,
        bs, stream,
        static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(k),
        static_cast<const float*>(ks), static_cast<const uint8_t*>(v),
        static_cast<const float*>(vs), static_cast<const int*>(pos),
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), Hkv, R,
        rep, S, bs, window, key0);
  }
};

}  // namespace

// fmt: 0 kv8, 1 kv4, 2 kvfp8, 3 kv16 (flash::Fmt).  q (B, Hkv, R, D) bf16;
// k/v (B, S, Hkv, ROW_BYTES) stored; scales (B, S, Hkv) f32; pos (B,)
// int32; out (B, Hkv, R, D) bf16, or f32 (unrounded) with lse (B, Hkv, R)
// f32 non-null; bs divides S.  The slab holds the keys at absolute positions key0 .. key0 + S - 1
// (flash::decode_rows).  Returns the CUDA error of the launch (0 on
// success), or flash::ERR_SMEM when not even a 16-token sub-tile fits in
// shared memory.
extern "C" int kvattn(const void* q, const void* k, const void* ks,
                      const void* v, const void* vs, const void* pos,
                      void* out, void* lse, int fmt, int B, int Hkv, int R,
                      int D, int rep, int S, int bs, int window, int key0,
                      void* stream) {
  if (bs < 1 || S % bs) return int(cudaErrorInvalidValue);
  const Launch l{q, k, ks, v, vs, pos, out, lse, B, Hkv, R, rep, S, bs,
                 window, key0, static_cast<cudaStream_t>(stream)};
  return flash::dispatch(fmt, D, l);
}
