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
// The dense-slab kernel (kvattn.cu) and the paged kernel (paged_kvattn.cu)
// call the same routine with the same block shape, which is what keeps
// their outputs bitwise equal on the same logical contents.
//
// Everything lives in shared memory and every thread of the block calls
// the routine (it synchronises internally).  Work is split over
// blockDim.x threads with strided loops, so any block size works.
// decode_rows below is the whole block program of both kernels: the tile
// walk, the staging of each stored tile and the final store.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The four KV storage formats.  Each stores a token row of one head in
// ROW_BYTES = D * BITS / 8 bytes (kv4: two nibbles per byte along d).
enum class Fmt : int { kv8 = 0, kv4 = 1, kvfp8 = 2, kv16 = 3 };

template <Fmt F>
__host__ __device__ constexpr int row_bytes(int D) {
  return F == Fmt::kv4 ? D / 2 : (F == Fmt::kv16 ? 2 * D : D);
}

// Stored element c of a token row -> float (exact for every format).
template <Fmt F>
__device__ __forceinline__ float load_elem(const uint8_t* row, int c) {
  if constexpr (F == Fmt::kv8) {
    return static_cast<float>(static_cast<int8_t>(row[c]));
  } else if constexpr (F == Fmt::kv4) {
    // low nibble = even d, high nibble = odd d; both sign-extended
    const uint8_t b = row[c >> 1];
    const int8_t nib = static_cast<int8_t>((c & 1) ? b : uint8_t(b << 4));
    return static_cast<float>(nib >> 4);
  } else if constexpr (F == Fmt::kvfp8) {
    __nv_fp8_e5m2 e;
    e.__x = row[c];
    return static_cast<float>(e);
  } else {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(row)[c]);
  }
}

// _dequant_tile: (bs, ROW_BYTES) stored tile + (bs,) scales -> bf16-valued
// floats bf16(float(q) * scale), row stride `ld` in the output (padding
// avoids shared-memory bank conflicts in the score loop).
template <Fmt F, int D>
__device__ __forceinline__ void dequant_tile(const uint8_t* t, const float* sc,
                                             float* out, int ld, int bs) {
  constexpr int RB = row_bytes<F>(D);
  for (int i = threadIdx.x; i < bs * D; i += blockDim.x) {
    const int j = i / D, c = i % D;
    out[j * ld + c] = bf16_round(load_elem<F>(t + j * RB, c) * sc[j]);
  }
}

struct State {
  float* m;      // (rows,)   running max
  float* l;      // (rows,)   running denominator
  float* alpha;  // (rows,)   this tile's rescale factor (scratch)
  float* acc;    // (rows, D) running numerator
};

// q: (rows, D) bf16-valued floats; kt/vt: (bs, ROW_BYTES) stored tiles;
// ks/vs: (bs,) scales; kd (bs, D+1), vd (bs, D), s (rows, bs): scratch.
// Row r's causal frontier is qpos[r]; its window keeps kpos > qpos[r] -
// window.  `base` is the logical position of the tile's first token.
template <Fmt F, int D>
__device__ void flash_block_update(const float* q, const uint8_t* kt,
                                   const float* ks, const uint8_t* vt,
                                   const float* vs, float* kd, float* vd,
                                   float* s, const int* qpos, int window,
                                   int base, int rows, int bs, State st) {
  constexpr int KLD = D + 1;
  dequant_tile<F, D>(kt, ks, kd, KLD, bs);
  dequant_tile<F, D>(vt, vs, vd, D, bs);
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

// ---------------------------------------------------------------------------
// The block program both attention kernels run
// ---------------------------------------------------------------------------

constexpr int ROW_TILE = 16;   // query rows per block
constexpr int THREADS = 128;   // threads per block
constexpr int MAX_SMEM = 232448;   // bytes of shared memory a block may use
constexpr int ERR_SMEM = -1;   // launch refused: the tile needs more

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

struct Smem {
  size_t kt, vt, ks, vs, q, acc, kd, vd, s, m, l, alpha, qpos, total;
};

// Shared-memory layout for D-wide heads stored in `rb` bytes per token
// row, bs-token tiles and rt query rows.
__host__ __device__ inline Smem smem_layout(int D, int rb, int bs, int rt) {
  Smem o;
  size_t off = 0;
  o.kt = off;    off = align16(off + size_t(bs) * rb);
  o.vt = off;    off = align16(off + size_t(bs) * rb);
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

// Block (b, h, z) of a (B, Hkv, ceil(R / ROW_TILE)) grid: query rows
// [z * ROW_TILE, ...) of slot b, kv-head h, against n_tiles KV tiles of bs
// tokens.  Tile s sits at logical positions s * bs + j and at flat token
// rows tile_tok0(s) + j of the store k/v (tokens, Hkv, ROW_BYTES), scales
// (tokens, Hkv): a dense slab (B * S tokens) and a paged pool (n_blocks *
// bs tokens) flatten alike, so the two kernels differ only in tile_tok0.
// Rows are token-major (r = t * rep + g): row r's frontier is
// pos[b] + r / rep.  Tiles are staged with 16-byte loads (ROW_BYTES is a
// multiple of 16 for every format at D in {32, 64, 128}).
template <Fmt F, int D, class TileTok>
__device__ void decode_rows(const __nv_bfloat16* __restrict__ q,
                            const uint8_t* __restrict__ k,
                            const float* __restrict__ k_scale,
                            const uint8_t* __restrict__ v,
                            const float* __restrict__ v_scale,
                            const int* __restrict__ pos,
                            __nv_bfloat16* __restrict__ out, int Hkv, int R,
                            int rep, int bs, int n_tiles, int window,
                            TileTok tile_tok0) {
  constexpr int RB = row_bytes<F>(D);
  constexpr int VEC = RB / 16;           // 16-byte chunks per token row
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = smem_layout(D, RB, bs, ROW_TILE);
  uint8_t* kt = smem + L.kt;
  uint8_t* vt = smem + L.vt;
  float* ks = reinterpret_cast<float*>(smem + L.ks);
  float* vs = reinterpret_cast<float*>(smem + L.vs);
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* kd = reinterpret_cast<float*>(smem + L.kd);
  float* vd = reinterpret_cast<float*>(smem + L.vd);
  float* sc = reinterpret_cast<float*>(smem + L.s);
  int* qpos = reinterpret_cast<int*>(smem + L.qpos);
  State st{reinterpret_cast<float*>(smem + L.m),
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
    st.m[r] = NEG_INF;
    st.l[r] = 0.f;
    qpos[r] = pos[b] + (row0 + r) / rep;
  }
  __syncthreads();

  for (int s = 0; s < n_tiles; ++s) {
    const size_t tok0 = tile_tok0(s);
    for (int i = threadIdx.x; i < bs * VEC; i += blockDim.x) {
      const int j = i / VEC, c = i % VEC;
      const size_t g = ((tok0 + j) * Hkv + h) * RB + c * 16;
      reinterpret_cast<int4*>(kt)[i] = *reinterpret_cast<const int4*>(k + g);
      reinterpret_cast<int4*>(vt)[i] = *reinterpret_cast<const int4*>(v + g);
    }
    for (int j = threadIdx.x; j < bs; j += blockDim.x) {
      ks[j] = k_scale[(tok0 + j) * Hkv + h];
      vs[j] = v_scale[(tok0 + j) * Hkv + h];
    }
    __syncthreads();
    flash_block_update<F, D>(qs, kt, ks, vt, vs, kd, vd, sc, qpos, window,
                             s * bs, rows, bs, st);
  }
  flash_store<D>(out + q_off * D, D, rows, st);
}

// Launch `kern` on a (B, Hkv, ceil(R / ROW_TILE)) grid with the shared
// memory of (D, ROW_BYTES, bs).  Returns ERR_SMEM when that exceeds what a
// block may use, else the CUDA error of the launch (0 on success).
template <Fmt F, int D, class Kern, class... Args>
int launch_rows(Kern kern, int B, int Hkv, int R, int bs, cudaStream_t st,
                Args... args) {
  const Smem L = smem_layout(D, row_bytes<F>(D), bs, ROW_TILE);
  if (L.total > size_t(MAX_SMEM)) return ERR_SMEM;
  if (L.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L.total));
    if (e != cudaSuccess) return int(e);
  }
  dim3 grid(B, Hkv, (R + ROW_TILE - 1) / ROW_TILE);
  kern<<<grid, THREADS, L.total, st>>>(args...);
  return int(cudaGetLastError());
}

// Runtime (format, head dim) -> fn.template run<F, D>(); anything else is
// cudaErrorInvalidValue.
template <Fmt F, class Fn>
int dispatch_d(int D, const Fn& fn) {
  switch (D) {
    case 32: return fn.template run<F, 32>();
    case 64: return fn.template run<F, 64>();
    case 128: return fn.template run<F, 128>();
    default: return int(cudaErrorInvalidValue);
  }
}

template <class Fn>
int dispatch(int fmt, int D, const Fn& fn) {
  switch (fmt) {
    case int(Fmt::kv8): return dispatch_d<Fmt::kv8>(D, fn);
    case int(Fmt::kv4): return dispatch_d<Fmt::kv4>(D, fn);
    case int(Fmt::kvfp8): return dispatch_d<Fmt::kvfp8>(D, fn);
    case int(Fmt::kv16): return dispatch_d<Fmt::kv16>(D, fn);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace flash
