// Multi-query paged flash-decode attention over the block pool, all four
// KV formats (kv8, kv4, kvfp8, kv16).
//
// Replaces repro/kernels/paged_kvattn.py:85 paged_kvattn_decode_grouped
// (kernel body _paged_kvattn_kernel, :49): one kernel for prefill chunks,
// preemption replay and decode.
//
// What bounds it on an H100: bytes.  Per (slot, kv-head) it reads the live
// blocks' stored K and V (2 * ROW_BYTES per token: D for kv8 and kvfp8,
// D / 2 for kv4, 2 * D for kv16) plus two f32 scales, and does 4 * D
// flops per (query row, key) — at decode (R = rep = 3 rows) about 1.5 flop
// per kv8 byte, far below the ~295 flop/byte where the tensor cores would
// become the limit.  At the serve's sizes the walk's latency dominates
// the bytes, so the design reads the pool straight through the block
// table (no dense per-slot view is gathered), keeps K/V in their stored
// format until they are in shared memory, and spreads the walk: each
// block visits only the tiles up to its rows' frontier (n_live stays an
// upper bound), eight blocks of a cluster take the tiles s % 8 in
// parallel and combine in rank order, the dots run on mma.sync and the
// stored bytes come through a cp.async ring (flash_block.cuh).
//
// Grid: (8, Hkv, B * ceil(R / 64)), clusters of 8 along x; 128 threads;
// the block program is flash::decode_rows.  For each logical block s <
// n_live it visits, the block reads tbl[b, s] itself and clamps the
// sentinel (n_blocks = unmapped) to n_blocks - 1 — its contents are
// masked to an exact no-op by the causal test.
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_block.cuh"

namespace {

using flash::Fmt;

template <Fmt F, int D>
__global__ void __launch_bounds__(flash::THREADS)
paged_kvattn_kernel(const __nv_bfloat16* __restrict__ q,
                    const uint8_t* __restrict__ k,
                    const float* __restrict__ k_scale,
                    const uint8_t* __restrict__ v,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ tbl, const int* __restrict__ pos,
                    __nv_bfloat16* __restrict__ out, int Hkv, int R, int rep,
                    int nb, int bs, int bps, int n_live, int window) {
  flash::decode_rows<F, D>(
      q, k, k_scale, v, v_scale, pos, out, Hkv, R, rep, bs, n_live, window,
      [=](int b, int s) {
        int blk = tbl[size_t(b) * bps + s];
        blk = blk < 0 ? 0 : (blk >= nb ? nb - 1 : blk);   // sentinel: masked
        return size_t(blk) * bs;
      });
}

struct Launch {
  const void *q, *k, *ks, *v, *vs, *tbl, *pos;
  void* out;
  int B, Hkv, R, rep, nb, bs, bps, n_live, window;
  cudaStream_t stream;

  template <Fmt F, int D>
  int run() const {
    return flash::launch_rows<F, D>(
        paged_kvattn_kernel<F, D>, B, Hkv, R, bs, stream,
        static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(k),
        static_cast<const float*>(ks), static_cast<const uint8_t*>(v),
        static_cast<const float*>(vs), static_cast<const int*>(tbl),
        static_cast<const int*>(pos), static_cast<__nv_bfloat16*>(out), Hkv,
        R, rep, nb, bs, bps, n_live, window);
  }
};

}  // namespace

// fmt: 0 kv8, 1 kv4, 2 kvfp8, 3 kv16 (flash::Fmt).  q (B, Hkv, R, D) bf16;
// k/v (nb, bs, Hkv, ROW_BYTES) stored; scales (nb, bs, Hkv) f32;
// tbl (B, bps) int32; pos (B,) int32; out (B, Hkv, R, D) bf16.  Returns
// the CUDA error of the launch (0 on success), or flash::ERR_SMEM when a
// bs-token tile does not fit in shared memory.
extern "C" int paged_kvattn(const void* q, const void* k, const void* ks,
                            const void* v, const void* vs, const void* tbl,
                            const void* pos, void* out, int fmt, int B,
                            int Hkv, int R, int D, int rep, int nb, int bs,
                            int bps, int n_live, int window, void* stream) {
  const Launch l{q, k, ks, v, vs, tbl, pos, out, B, Hkv, R, rep, nb, bs, bps,
                 n_live, window, static_cast<cudaStream_t>(stream)};
  return flash::dispatch(fmt, D, l);
}
