// One flash-decoding step over a (block_size x D) KV tile: the per-tile
// online-softmax update that the Hopper attention kernels share.
//
// Replaces repro/kernels/kvattn.py:53-112 (_dequant_tile,
// flash_block_update, flash_store), whose numerics it keeps exactly:
//   * K and V are dequantized element by element, bf16(float(q) * scale),
//     before the dots (the code's order, not the kvattn.py docstring's);
//   * scores are a bf16 x bf16 dot accumulated in f32, then x 1/sqrt(D);
//   * masked scores are NEG_INF = -1e30, never -INFINITY (-inf - -inf is
//     NaN), and p is zeroed under the mask, so a fully masked tile leaves
//     (m, l, acc) exactly unchanged: alpha = exp(0) = 1, p = 0;
//   * p is rounded to bf16 before the PV dot; l sums the unrounded p;
//   * the final store divides by max(l, 1e-20).
// The dense-slab kernel of the next slice calls the same routine, which is
// what will keep its outputs bitwise equal to the paged kernel's.
//
// Everything lives in shared memory and every thread of the block calls
// the routine (it synchronises internally).  Work is split over
// blockDim.x threads with strided loops, so any block size works.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace flash {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// _dequant_tile for kv8: (bs, D) int8 + (bs,) scales -> bf16-valued floats,
// row stride `ld` in the output (padding avoids shared-memory bank
// conflicts in the score loop).
template <int D>
__device__ __forceinline__ void dequant_tile(const int8_t* t, const float* sc,
                                             float* out, int ld, int bs) {
  for (int i = threadIdx.x; i < bs * D; i += blockDim.x) {
    const int j = i / D, c = i % D;
    out[j * ld + c] = bf16_round(static_cast<float>(t[i]) * sc[j]);
  }
}

struct State {
  float* m;      // (rows,)   running max
  float* l;      // (rows,)   running denominator
  float* alpha;  // (rows,)   this tile's rescale factor (scratch)
  float* acc;    // (rows, D) running numerator
};

// q: (rows, D) bf16-valued floats; kt/vt: (bs, D) int8 tile; ks/vs: (bs,)
// scales; kd (bs, D+1), vd (bs, D), s (rows, bs): scratch.  Row r's causal
// frontier is qpos[r]; its window keeps kpos > qpos[r] - window.  `base`
// is the logical position of the tile's first token.
template <int D>
__device__ void flash_block_update(const float* q, const int8_t* kt,
                                   const float* ks, const int8_t* vt,
                                   const float* vs, float* kd, float* vd,
                                   float* s, const int* qpos, int window,
                                   int base, int rows, int bs, State st) {
  constexpr int KLD = D + 1;
  dequant_tile<D>(kt, ks, kd, KLD, bs);
  dequant_tile<D>(vt, vs, vd, D, bs);
  __syncthreads();

  const float inv_sqrt_d = 1.0f / sqrtf(static_cast<float>(D));
  for (int i = threadIdx.x; i < rows * bs; i += blockDim.x) {
    const int r = i / bs, j = i % bs;
    float dot = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) dot = fmaf(q[r * D + c], kd[j * KLD + c], dot);
    const int kpos = base + j;
    const bool ok = kpos <= qpos[r] && kpos > qpos[r] - window;
    s[i] = ok ? dot * inv_sqrt_d : NEG_INF;
  }
  __syncthreads();

  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const float m_prev = st.m[r];
    float m_new = m_prev;
    for (int j = 0; j < bs; ++j) m_new = fmaxf(m_new, s[r * bs + j]);
    const float alpha = expf(m_prev - m_new);
    float sum = 0.f;
    for (int j = 0; j < bs; ++j) {
      const int kpos = base + j;
      const bool ok = kpos <= qpos[r] && kpos > qpos[r] - window;
      const float p = ok ? expf(s[r * bs + j] - m_new) : 0.f;
      sum += p;
      s[r * bs + j] = bf16_round(p);
    }
    st.m[r] = m_new;
    st.l[r] = st.l[r] * alpha + sum;
    st.alpha[r] = alpha;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    float pv = 0.f;
    for (int j = 0; j < bs; ++j) pv = fmaf(s[r * bs + j], vd[j * D + c], pv);
    st.acc[i] = st.acc[i] * st.alpha[r] + pv;
  }
  __syncthreads();
}

// flash_store: out = bf16(acc / max(l, 1e-20)), row r at out + r * ld.
template <int D>
__device__ void flash_store(__nv_bfloat16* out, long ld, int rows, State st) {
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    out[r * ld + c] = __float2bfloat16_rn(st.acc[i] / fmaxf(st.l[r], 1e-20f));
  }
}

}  // namespace flash
