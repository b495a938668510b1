// Multi-query paged flash-decode attention over the kv8 block pool.
//
// Replaces repro/kernels/paged_kvattn.py:85 paged_kvattn_decode_grouped
// (kernel body _paged_kvattn_kernel, :49), kv8 instantiation: one kernel
// for prefill chunks, preemption replay and decode.
//
// What bounds it on an H100: bytes.  Per (slot, kv-head) it reads the live
// blocks' int8 K and V (2 * D bytes per token) plus two f32 scales, and
// does 4 * D flops per (query row, key) — at decode (R = rep = 3 rows)
// about 1.5 flop per byte, far below the ~295 flop/byte where the tensor
// cores would become the limit.  The design therefore reads the pool once
// per (slot, kv-head, row tile) straight through the block table — no
// dense per-slot view is ever gathered — keeps K/V int8 until they are in
// shared memory, and bounds the walk by the batch's live context
// (n_live), not by the table's length.  Everything after the load is
// simple CUDA-core arithmetic in shared memory (flash_block.cuh); wgmma,
// TMA and a cp.async pipeline over blocks are later work.
//
// Grid: (B, Hkv, ceil(R / ROW_TILE)); 128 threads.  For each logical block
// s < n_live the block reads tbl[b, s] itself, clamps the sentinel
// (n_blocks = unmapped) to n_blocks - 1 — its contents are masked to an
// exact no-op by the causal test — stages the K/V tile and its scales in
// shared memory with 16-byte loads, and runs the shared online-softmax
// update with base = s * block_size.  Rows are token-major (r = t*rep + g),
// so row r's frontier is pos[b] + r / rep.
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_block.cuh"

namespace {

constexpr int ROW_TILE = 16;
constexpr int THREADS = 128;

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

struct Smem {
  size_t kt, vt, ks, vs, q, acc, kd, vd, s, m, l, alpha, qpos, total;
};

__host__ __device__ inline Smem smem_layout(int D, int bs, int rt) {
  Smem o;
  size_t off = 0;
  o.kt = off;    off = align16(off + size_t(bs) * D);
  o.vt = off;    off = align16(off + size_t(bs) * D);
  o.ks = off;    off = align16(off + sizeof(float) * bs);
  o.vs = off;    off = align16(off + sizeof(float) * bs);
  o.q = off;     off = align16(off + sizeof(float) * rt * D);
  o.acc = off;   off = align16(off + sizeof(float) * rt * D);
  o.kd = off;    off = align16(off + sizeof(float) * bs * (D + 1));
  o.vd = off;    off = align16(off + sizeof(float) * bs * D);
  o.s = off;     off = align16(off + sizeof(float) * rt * bs);
  o.m = off;     off = align16(off + sizeof(float) * rt);
  o.l = off;     off = align16(off + sizeof(float) * rt);
  o.alpha = off; off = align16(off + sizeof(float) * rt);
  o.qpos = off;  off = align16(off + sizeof(int) * rt);
  o.total = off;
  return o;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
paged_kvattn_kv8_kernel(const __nv_bfloat16* __restrict__ q,
                        const int8_t* __restrict__ k,
                        const float* __restrict__ k_scale,
                        const int8_t* __restrict__ v,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ tbl,
                        const int* __restrict__ pos,
                        __nv_bfloat16* __restrict__ out, int Hkv, int R,
                        int rep, int nb, int bs, int bps, int n_live,
                        int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = smem_layout(D, bs, ROW_TILE);
  int8_t* kt = reinterpret_cast<int8_t*>(smem + L.kt);
  int8_t* vt = reinterpret_cast<int8_t*>(smem + L.vt);
  float* ks = reinterpret_cast<float*>(smem + L.ks);
  float* vs = reinterpret_cast<float*>(smem + L.vs);
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* kd = reinterpret_cast<float*>(smem + L.kd);
  float* vd = reinterpret_cast<float*>(smem + L.vd);
  float* sc = reinterpret_cast<float*>(smem + L.s);
  int* qpos = reinterpret_cast<int*>(smem + L.qpos);
  flash::State st{reinterpret_cast<float*>(smem + L.m),
                  reinterpret_cast<float*>(smem + L.l),
                  reinterpret_cast<float*>(smem + L.alpha),
                  reinterpret_cast<float*>(smem + L.acc)};

  const int b = blockIdx.x, h = blockIdx.y;
  const int row0 = blockIdx.z * ROW_TILE;
  const int rows = min(ROW_TILE, R - row0);
  const size_t q_off = (size_t(b) * Hkv + h) * R + row0;   // in rows

  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    qs[i] = __bfloat162float(q[q_off * D + i]);
    st.acc[i] = 0.f;
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    st.m[r] = flash::NEG_INF;
    st.l[r] = 0.f;
    qpos[r] = pos[b] + (row0 + r) / rep;
  }
  __syncthreads();

  constexpr int VEC = D / 16;            // 16-byte chunks per token row
  const size_t tok_stride = size_t(Hkv) * D;
  for (int s = 0; s < n_live; ++s) {
    int blk = tbl[size_t(b) * bps + s];
    blk = blk < 0 ? 0 : (blk >= nb ? nb - 1 : blk);   // sentinel -> masked
    const size_t tok0 = size_t(blk) * bs;
    for (int i = threadIdx.x; i < bs * VEC; i += blockDim.x) {
      const int j = i / VEC, c = i % VEC;
      const size_t g = (tok0 + j) * tok_stride + size_t(h) * D + c * 16;
      reinterpret_cast<int4*>(kt)[i] = *reinterpret_cast<const int4*>(k + g);
      reinterpret_cast<int4*>(vt)[i] = *reinterpret_cast<const int4*>(v + g);
    }
    for (int j = threadIdx.x; j < bs; j += blockDim.x) {
      ks[j] = k_scale[(tok0 + j) * Hkv + h];
      vs[j] = v_scale[(tok0 + j) * Hkv + h];
    }
    __syncthreads();
    flash::flash_block_update<D>(qs, kt, ks, vt, vs, kd, vd, sc, qpos, window,
                                 s * bs, rows, bs, st);
  }
  flash::flash_store<D>(out + q_off * D, D, rows, st);
}

template <int D>
int launch(const void* q, const void* k, const void* ks, const void* v,
           const void* vs, const void* tbl, const void* pos, void* out, int B,
           int Hkv, int R, int rep, int nb, int bs, int bps, int n_live,
           int window, cudaStream_t stream) {
  const Smem L = smem_layout(D, bs, ROW_TILE);
  auto kern = paged_kvattn_kv8_kernel<D>;
  if (L.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L.total));
    if (e != cudaSuccess) return int(e);
  }
  dim3 grid(B, Hkv, (R + ROW_TILE - 1) / ROW_TILE);
  kern<<<grid, THREADS, L.total, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
      static_cast<const float*>(ks), static_cast<const int8_t*>(v),
      static_cast<const float*>(vs), static_cast<const int*>(tbl),
      static_cast<const int*>(pos), static_cast<__nv_bfloat16*>(out), Hkv, R,
      rep, nb, bs, bps, n_live, window);
  return int(cudaGetLastError());
}

}  // namespace

// q (B, Hkv, R, D) bf16; k/v (nb, bs, Hkv, D) int8; scales (nb, bs, Hkv)
// f32; tbl (B, bps) int32; pos (B,) int32; out (B, Hkv, R, D) bf16.
// Returns the CUDA error of the launch (0 on success).
extern "C" int paged_kvattn_kv8(const void* q, const void* k, const void* ks,
                                const void* v, const void* vs, const void* tbl,
                                const void* pos, void* out, int B, int Hkv,
                                int R, int D, int rep, int nb, int bs, int bps,
                                int n_live, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(q, k, ks, v, vs, tbl, pos, out, B, Hkv, R, rep, nb, bs,
                        bps, n_live, window, st);
    case 64:
      return launch<64>(q, k, ks, v, vs, tbl, pos, out, B, Hkv, R, rep, nb, bs,
                        bps, n_live, window, st);
    case 128:
      return launch<128>(q, k, ks, v, vs, tbl, pos, out, B, Hkv, R, rep, nb,
                         bs, bps, n_live, window, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}
