// The block program of both decode-attention kernels (kvattn.cu over the
// dense slab, paged_kvattn.cu over the block pool): multi-query flash
// decode of a 64-row query tile against the stored K/V tiles of one
// (slot, kv-head), split over a cluster of 8 blocks.
//
// Replaces repro/kernels/kvattn.py:53-112 (_dequant_tile,
// flash_block_update, flash_store), whose numerics it keeps:
//   * K and V are dequantized element by element, bf16(float(q) * scale),
//     before the dots (the code's order, not the kvattn.py docstring's);
//   * scores are a bf16 x bf16 dot accumulated in f32, then x 1/sqrt(D);
//   * masked scores are NEG_INF = -1e30, never -INFINITY (-inf - -inf is
//     NaN), and p is zeroed under the mask, so a fully masked tile leaves
//     (m, l, acc) exactly unchanged: alpha = exp(0) = 1, p = 0;
//   * p is rounded to bf16 before the PV dot; l sums the unrounded p;
//   * the final store divides by max(l, 1e-20).
//
// What bounds it on an H100: bytes — the live tiles' stored K/V and two
// f32 scales per token, against 4 * D flops per (row, key) — but at the
// serve's sizes (a few hundred keys per slot) the real limit is latency:
// a block that walks its tiles in series waits on one load and one
// reduction after another.  The design therefore spreads the walk:
//   * Frontier skip.  A block visits only the tiles that can hold a kept
//     key of its rows: tile s with s * bs <= the last row's frontier and
//     (s + 1) * bs - 1 > the first row's frontier - window.  A skipped
//     tile is an exact no-op of the online softmax.
//   * Split-KV in a cluster.  Grid (SPLITS, Hkv, B * ceil(R / 64)) with
//     clusters of SPLITS = 8 blocks along x: block c walks the tiles s with
//     s % 8 == c.  The split depends on the logical tile index alone —
//     never on S, n_live, the batch or the frontier — so a row's bits
//     depend on its own keys only: the dense and paged kernels agree bit
//     for bit, and so do a slot's rows whatever its batch-mates, n_live,
//     or how its prompt was cut into chunks.  The eight partial (m, l,
//     acc) are combined through distributed shared memory in rank order
//     0..7 in the same launch: w_c = exp(m_c - max m), l = sum l_c w_c,
//     acc = sum acc_c w_c.  A split with no kept key (m = -1e30, l = 0,
//     acc = 0) gets w = 0 exactly: a no-op of the combine.
//   * Tensor cores.  Each arrived tile is dequantized into bf16 rows in
//     shared memory; each warp owns 16 query rows (Q fragments held in
//     registers) and runs S = Q K^T and O += P V with mma.sync m16n8k16,
//     fragments by ldmatrix (.trans for V), softmax reduced in registers
//     across the row quad.
//   * Asynchronous copies.  The stored K/V bytes and scales come through a
//     two-stage cp.async ring: tile i + 8's bytes are in flight while tile
//     i is dequantized and multiplied.
// Every thread of the block calls decode_rows; it synchronises internally
// and all blocks of a cluster reach both cluster barriers.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_tile.cuh"

namespace flash {

namespace cg = cooperative_groups;
using ptx::NEG_INF;
using bf16 = __nv_bfloat16;

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
    return __bfloat162float(reinterpret_cast<const bf16*>(row)[c]);
  }
}

constexpr int ROW_TILE = 64;       // query rows per block: 4 warps x 16
constexpr int THREADS = 128;       // threads per block
constexpr int SPLITS = 8;          // blocks per cluster; tile s -> s % 8
constexpr int STAGES = 2;          // cp.async ring depth
constexpr int KSL = 64;            // keys per online-softmax update
constexpr int PAD = 8;             // bf16 padding per shared-memory row
constexpr int MAX_SMEM = 232448;   // bytes of shared memory a block may use
constexpr int ERR_SMEM = -1;       // launch refused: the tile needs more

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// Shared-memory layout for D-wide heads stored in `rb` bytes per token
// row and bs-token tiles: a STAGES-deep ring of stored tiles (K rows, V
// rows, K scales, V scales), the dequantized bf16 K and V (bs rounded up to
// 16 rows, the padding rows zero) and the Q tile, rows padded by PAD.
// After the walk the partial (m, l, acc) of the 64 rows alias offset 0.
struct Smem {
  size_t stage, kd, vd, q, total;
};

__host__ __device__ inline Smem smem_layout(int D, int rb, int bs) {
  const size_t n16 = size_t(bs + 15) / 16 * 16;
  Smem o;
  o.stage = align16(2 * size_t(bs) * rb + 2 * sizeof(float) * bs);
  o.kd = STAGES * o.stage;
  o.vd = o.kd + align16(n16 * (D + PAD) * sizeof(bf16));
  o.q = o.vd + align16(n16 * (D + PAD) * sizeof(bf16));
  const size_t end = o.q + align16(size_t(ROW_TILE) * (D + PAD) * sizeof(bf16));
  const size_t part = sizeof(float) * ROW_TILE * (D + 2);
  o.total = end > part ? end : part;
  return o;
}

// Block (c, h, z) of the grid: query rows [row0, row0 + 64) of slot b =
// z / ceil(R / 64), kv-head h, split c, against the KV tiles s < n_tiles of
// bs tokens.  Tile s sits at logical positions s * bs + j and at flat
// token rows tile_tok0(b, s) + j of the store k/v (tokens, Hkv, ROW_BYTES),
// scales (tokens, Hkv): a dense slab (B * S tokens) and a paged pool
// (n_blocks * bs tokens) flatten alike, so the two kernels differ only in
// tile_tok0 and n_tiles.  Rows are token-major (r = t * rep + g): row r's
// frontier is pos[b] + r / rep.  Stored rows are copied as 16-byte words
// (ROW_BYTES is a multiple of 16 for every format at D in {32, 64, 128}).
template <Fmt F, int D, class TileTok>
__device__ void decode_rows(const bf16* __restrict__ q,
                            const uint8_t* __restrict__ k,
                            const float* __restrict__ k_scale,
                            const uint8_t* __restrict__ v,
                            const float* __restrict__ v_scale,
                            const int* __restrict__ pos,
                            bf16* __restrict__ out, int Hkv, int R, int rep,
                            int bs, int n_tiles, int window,
                            TileTok tile_tok0) {
  constexpr int RB = row_bytes<F>(D);
  constexpr int VEC = RB / 16;           // 16-byte words per stored row
  constexpr int LD = D + PAD;
  constexpr int NT = D / 8;              // n8 tiles of an output row
  constexpr int NJ = KSL / 8;            // n8 score tiles of a slice
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = smem_layout(D, RB, bs);
  const int n16 = (bs + 15) / 16 * 16;
  bf16* kd = reinterpret_cast<bf16*>(smem + L.kd);
  bf16* vd = reinterpret_cast<bf16*>(smem + L.vd);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.q);

  cg::cluster_group cluster = cg::this_cluster();
  const int c = int(cluster.block_rank());
  const int h = blockIdx.y;
  const int nz = (R + ROW_TILE - 1) / ROW_TILE;
  const int b = blockIdx.z / nz, row0 = (blockIdx.z % nz) * ROW_TILE;
  const int rows = min(ROW_TILE, R - row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t q_off = (size_t(b) * Hkv + h) * R + row0;   // in rows
  const int p0 = pos[b];

  // tiles that can hold a kept key of rows [row0, row0 + rows), and the
  // first of them that belongs to split c
  const int f_lo = p0 + row0 / rep, f_hi = p0 + (row0 + rows - 1) / rep;
  const int s_lo = max(0, f_lo - window + 1) / bs;
  const int s_hi = min(n_tiles - 1, f_hi / bs);
  const int s_first = s_lo + ((c - s_lo % SPLITS) + SPLITS) % SPLITS;

  auto load_tile = [&](int s, int stage) {
    unsigned char* base = smem + stage * L.stage;
    float* ks = reinterpret_cast<float*>(base + 2 * bs * RB);
    const size_t tok0 = tile_tok0(b, s);
    for (int i = threadIdx.x; i < bs * VEC; i += THREADS) {
      const int j = i / VEC, w = i % VEC;
      const size_t off = ((tok0 + j) * Hkv + h) * RB + w * 16;
      ptx::cp_async16(base + i * 16, k + off);
      ptx::cp_async16(base + bs * RB + i * 16, v + off);
    }
    for (int j = threadIdx.x; j < bs; j += THREADS) {
      ptx::cp_async4(ks + j, k_scale + (tok0 + j) * Hkv + h);
      ptx::cp_async4(ks + bs + j, v_scale + (tok0 + j) * Hkv + h);
    }
  };

  // Q rows (zeros past R), then the split's first tile
  for (int i = threadIdx.x; i < ROW_TILE * (D / 8); i += THREADS) {
    const int r = i / (D / 8), w = i % (D / 8);
    const bool ok = r < rows;
    ptx::cp_async16(qs + r * LD + w * 8, q + (q_off + (ok ? r : 0)) * D + w * 8,
                    ok ? 16 : 0);
  }
  ptx::cp_commit();
  if (s_first <= s_hi) load_tile(s_first, 0);
  ptx::cp_commit();
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int i = threadIdx.x; i < (n16 - bs) * LD; i += THREADS) {
    kd[bs * LD + i] = zero;                // padding keys: zero and masked
    vd[bs * LD + i] = zero;
  }
  ptx::cp_wait<1>();                       // Q has arrived
  __syncthreads();

  const int wrow = warp * 16;
  const bool active = wrow < rows;         // warp-uniform
  uint32_t qf[D / 16][4];
  if (active) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ptx::load_a(qf[kk], qs + wrow * LD + kk * 16, LD, lane);
  }
  const int qa = p0 + (row0 + wrow + g) / rep;       // frontier of row g
  const int qb = p0 + (row0 + wrow + g + 8) / rep;   // and of row g + 8
  const float inv_sqrt_d = 1.0f / sqrtf(static_cast<float>(D));

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  int stage = 0;
  for (int s = s_first; s <= s_hi; s += SPLITS) {
    if (s + SPLITS <= s_hi) load_tile(s + SPLITS, stage ^ 1);
    ptx::cp_commit();
    ptx::cp_wait<1>();                     // tile s has arrived
    __syncthreads();                       // ... for every thread; kd/vd free

    // _dequant_tile: bf16(float(q) * scale), 8 elements a thread-step
    const unsigned char* base = smem + stage * L.stage;
    const float* ks = reinterpret_cast<const float*>(base + 2 * bs * RB);
    for (int i = threadIdx.x; i < bs * (D / 8); i += THREADS) {
      const int j = i / (D / 8), c0 = (i % (D / 8)) * 8;
      const uint8_t* kr = base + j * RB;
      const uint8_t* vr = base + bs * RB + j * RB;
      const float sk = ks[j], sv = ks[bs + j];
      uint32_t kw[4], vw[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        kw[e] = ptx::pack_bf16(load_elem<F>(kr, c0 + 2 * e) * sk,
                               load_elem<F>(kr, c0 + 2 * e + 1) * sk);
        vw[e] = ptx::pack_bf16(load_elem<F>(vr, c0 + 2 * e) * sv,
                               load_elem<F>(vr, c0 + 2 * e + 1) * sv);
      }
      *reinterpret_cast<uint4*>(kd + j * LD + c0) =
          make_uint4(kw[0], kw[1], kw[2], kw[3]);
      *reinterpret_cast<uint4*>(vd + j * LD + c0) =
          make_uint4(vw[0], vw[1], vw[2], vw[3]);
    }
    __syncthreads();

    if (active) {
      for (int k0 = 0; k0 < n16; k0 += KSL) {
        const int nk = min(KSL, n16 - k0) / 16;     // k16 steps of the slice
        float sc[NJ][4];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[j][i] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
          for (int j = 0; j < NJ / 2; ++j) {
            if (j >= nk) break;
            uint32_t bf[4];
            ptx::load_b_rows(bf, kd + (k0 + 16 * j) * LD + kk * 16, LD, lane);
            ptx::mma_bf16(sc[2 * j], qf[kk], bf);
            ptx::mma_bf16(sc[2 * j + 1], qf[kk], bf + 2);
          }
        const int kbase = s * bs + k0;               // logical key of column 0
        ptx::softmax_update<NJ, NT>(
            sc, inv_sqrt_d,
            [&](int j, int i) {
              const int col = k0 + 8 * j + 2 * t + (i & 1);
              const int kpos = kbase + 8 * j + 2 * t + (i & 1);
              const int qp = i < 2 ? qa : qb;
              return col < bs && kpos <= qp && kpos > qp - window;
            },
            m, l, acc);
        ptx::pv_update<NJ, NT>(sc, vd + k0 * LD, LD, lane, nk, acc);
      }
    }
    stage ^= 1;
  }
  ptx::cp_wait<0>();
  __syncthreads();                         // ring and tiles free: partials

  // this block's partial (m, l, acc) of its 64 rows, then the combine
  float* pm = reinterpret_cast<float*>(smem);
  float* pl = pm + ROW_TILE;
  float* pa = pl + ROW_TILE;               // (ROW_TILE, D)
  if (active) {
    const int ra = wrow + g, rb = ra + 8;
    if (t == 0) {
      pm[ra] = m[0];
      pl[ra] = l[0];
      pm[rb] = m[1];
      pl[rb] = l[1];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = n * 8 + 2 * t;
      pa[ra * D + d] = acc[n][0];
      pa[ra * D + d + 1] = acc[n][1];
      pa[rb * D + d] = acc[n][2];
      pa[rb * D + d + 1] = acc[n][3];
    }
  }
  cluster.sync();
  // block c finishes rows c, c + 8, ...: splits combined in rank order
  for (int i = threadIdx.x; i < ROW_TILE / SPLITS * D; i += THREADS) {
    const int r = c + SPLITS * (i / D), d = i % D;
    if (r >= rows) continue;
    float mx = NEG_INF;
#pragma unroll
    for (int p = 0; p < SPLITS; ++p)
      mx = fmaxf(mx, cluster.map_shared_rank(pm, p)[r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int p = 0; p < SPLITS; ++p) {
      const float* rp = cluster.map_shared_rank(pm, p);
      const float w = expf(rp[r] - mx);
      lsum += rp[ROW_TILE + r] * w;
      a += rp[2 * ROW_TILE + r * D + d] * w;
    }
    out[(q_off + r) * D + d] = __float2bfloat16_rn(a / fmaxf(lsum, 1e-20f));
  }
  cluster.sync();                          // partials read by every block
}

// Launch `kern` on a (SPLITS, Hkv, B * ceil(R / ROW_TILE)) grid in
// clusters of SPLITS blocks along x, with the shared memory of (D,
// ROW_BYTES, bs).  Returns ERR_SMEM when that exceeds what a block may
// use, else the CUDA error of the launch (0 on success; a refused cluster
// launch returns its error).
template <Fmt F, int D, class... KArgs, class... Args>
int launch_rows(void (*kern)(KArgs...), int B, int Hkv, int R, int bs,
                cudaStream_t st, Args... args) {
  const Smem L = smem_layout(D, row_bytes<F>(D), bs);
  if (L.total > size_t(MAX_SMEM)) return ERR_SMEM;
  if (L.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L.total));
    if (e != cudaSuccess) return int(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(SPLITS, Hkv, B * ((R + ROW_TILE - 1) / ROW_TILE));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SPLITS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return int(e);
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
