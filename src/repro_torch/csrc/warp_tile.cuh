// Warp-level building blocks of the attention kernels (flash_block.cuh,
// flash_prefill.cu): cp.async copies into shared memory, ldmatrix fragment
// loads, the bf16 mma.sync m16n8k16 and the online-softmax update of one
// warp's 16 query rows held in registers.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"): lane
// = 4 g + t holds A rows g and g + 8, columns 2t, 2t + 1 (+ 8); B column
// g, rows 2t, 2t + 1 (+ 8); C rows g and g + 8, columns 2t, 2t + 1.  The
// tile loaders below take a row-major bf16 tile in shared memory with a
// row stride `ld` (elements) whose rows are 16-byte aligned; with ld = D
// + 8 the eight row addresses of one 8 x 8 matrix fall in distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ptx {

constexpr float NEG_INF = -1e30f;   // masked score: never -inf (-inf - -inf)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; `src_bytes` < 16 zero-fills the
// rest (0: the destination becomes zeros and nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// 4 bytes global -> shared (a per-token scale).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b: m16n8k16, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// A fragment of the 16 x 16 block at `p` (= &tile[row0][k0]).
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* p,
                                       int ld, int lane) {
  const int m = lane >> 3, i = lane & 7;
  ldsm_x4(a, p + ((m & 1) * 8 + i) * ld + (m >> 1) * 8);
}

// B fragments of Q K^T for two n8 tiles from a [key][d] tile, `p` =
// &K[n0][k0]: b[0..1] for keys n0..n0+7, b[2..3] for keys n0+8..n0+15,
// depth d in [k0, k0 + 16).
__device__ __forceinline__ void load_b_rows(uint32_t* b,
                                            const __nv_bfloat16* p, int ld,
                                            int lane) {
  const int m = lane >> 3, i = lane & 7;
  ldsm_x4(b, p + ((m >> 1) * 8 + i) * ld + (m & 1) * 8);
}

// B fragments of P V for two n8 tiles from a [key][d] tile (transposed by
// ldmatrix), `p` = &V[k0][n0]: b[0..1] for d in [n0, n0 + 8), b[2..3] for
// [n0 + 8, n0 + 16), keys k0..k0+15.
__device__ __forceinline__ void load_b_cols(uint32_t* b,
                                            const __nv_bfloat16* p, int ld,
                                            int lane) {
  const int m = lane >> 3, i = lane & 7;
  ldsm_x4_trans(b, p + ((m & 1) * 8 + i) * ld + (m >> 1) * 8);
}

// One online-softmax update of a warp's 16 rows against NJ n8 score tiles
// `s` (C fragments of Q K^T, unscaled): a score is kept when keep(j, i)
// (tile j, fragment element i: row g for i < 2, g + 8 else; key 8 j + 2 t
// + (i & 1)), scaled by `scale`, else NEG_INF.  Then m, l and acc (NT n8
// tiles of the output row) take the slice, and s holds the unrounded p
// (0 under the mask).  The row max and sum are reduced across the four
// lanes of a row quad; l sums the unrounded p.
template <int NJ, int NT, class Keep>
__device__ __forceinline__ void softmax_update(float (*s)[4], float scale,
                                               Keep keep, float* m, float* l,
                                               float (*acc)[4]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[j][i] = keep(j, i) ? s[j][i] * scale : NEG_INF;
      mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  const float alpha[2] = {expf(m[0] - mx[0]), expf(m[1] - mx[1])};
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = keep(j, i) ? expf(s[j][i] - mx[i >> 1]) : 0.f;
      sum[i >> 1] += p;
      s[j][i] = p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l[r] = l[r] * alpha[r] + sum[r];
    m[r] = mx[r];
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    acc[n][0] *= alpha[0];
    acc[n][1] *= alpha[0];
    acc[n][2] *= alpha[1];
    acc[n][3] *= alpha[1];
  }
}

// acc += bf16(p) V for the first 16 kk_n keys of a slice (kk_n <= NJ / 2):
// `v` = &V[first key][0] in a [key][d] tile.  The C fragments of two n8
// score tiles are the A fragment of one k16 step.
template <int NJ, int NT>
__device__ __forceinline__ void pv_update(const float (*s)[4],
                                          const __nv_bfloat16* v, int ld,
                                          int lane, int kk_n,
                                          float (*acc)[4]) {
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
    if (kk >= kk_n) break;
    const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                           pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                           pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t b[4];
      load_b_cols(b, v + kk * 16 * ld + n * 8, ld, lane);
      mma_bf16(acc[n], a, b);
      mma_bf16(acc[n + 1], a, b + 2);
    }
  }
}

}  // namespace ptx
