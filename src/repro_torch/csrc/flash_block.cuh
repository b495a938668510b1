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
//   * Wide heads (D > 128, gemma3's 288).  A warp's Q fragments (D / 4
//     registers) and output accumulator (D / 2) would not fit under the
//     255 registers a thread may hold: two warps share each 16-row group
//     (256 threads), each computes the same S and softmax (same
//     instructions on the same operands: the same bits) and keeps the
//     output of its half of D; Q fragments are re-read from shared
//     memory by ldmatrix at every k16 step instead of held.  The rows'
//     arithmetic is the narrow heads', so their bits follow the same rule.
//   * Asynchronous copies.  The stored K/V bytes and scales come through a
//     two-stage cp.async ring: tile i + 8's bytes are in flight while tile
//     i is dequantized and multiplied.
//   * Sub-tiles.  A bs-token tile whose staging needs more than the 227 KB
//     a block may use is walked as sub-tiles of sub_rows(D, ROW_BYTES, bs)
//     = 64 tokens (one softmax slice; the last one of a tile ragged), so
//     a large tile spreads over all eight splits; a sub-tile never
//     straddles a tile, so never a pool block.  The walk, the frontier
//     skip, the ring and the split (sub-tile u -> u % 8) then run in
//     sub-tile units.  The cut is a fixed function of (D, format, bs), so
//     a row's bits still depend on its frontier and bs alone.  The kernel
//     is instantiated twice (SUB): a tile that fits runs the whole-tile
//     walk, its own single sub-tile with the unit arithmetic folded away.
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
constexpr int THREADS = 128;       // threads per block at D <= 128
constexpr int SPLITS = 8;          // blocks per cluster; sub-tile u -> u % 8
constexpr int STAGES = 2;          // cp.async ring depth
constexpr int KSL = 64;            // keys per online-softmax update
constexpr int PAD = 8;             // bf16 padding per shared-memory row
constexpr int MAX_SMEM = 232448;   // bytes of shared memory a block may use
constexpr int ERR_SMEM = -1;       // launch refused: not even 16 tokens fit

// Warps sharing one 16-row group, each keeping the output of D / d_warps
// columns, and the block's threads.
__host__ __device__ constexpr int d_warps(int D) { return D > 128 ? 2 : 1; }
__host__ __device__ constexpr int threads(int D) {
  return THREADS * d_warps(D);
}

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// Shared-memory layout for D-wide heads stored in `rb` bytes per token
// row and sub-token (sub-)tiles: a STAGES-deep ring of stored sub-tiles (K
// rows, V rows, K scales, V scales), the dequantized bf16 K and V (sub
// rounded up to 16 rows, the padding rows zero) and the Q tile, rows padded
// by PAD.  After the walk the partial (m, l, acc) of the 64 rows alias
// offset 0.
struct Smem {
  size_t stage, kd, vd, q, total;
};

__host__ __device__ inline Smem smem_layout(int D, int rb, int sub) {
  const size_t n16 = size_t(sub + 15) / 16 * 16;
  Smem o;
  o.stage = align16(2 * size_t(sub) * rb + 2 * sizeof(float) * sub);
  o.kd = STAGES * o.stage;
  o.vd = o.kd + align16(n16 * (D + PAD) * sizeof(bf16));
  o.q = o.vd + align16(n16 * (D + PAD) * sizeof(bf16));
  const size_t end = o.q + align16(size_t(ROW_TILE) * (D + PAD) * sizeof(bf16));
  const size_t part = sizeof(float) * ROW_TILE * (D + 2);
  o.total = end > part ? end : part;
  return o;
}

// Tokens per sub-tile of a bs-token tile: bs when its layout fits in
// MAX_SMEM; else the largest of 64, 48, 32, 16 that fits (the last
// sub-tile of a tile is ragged), 0 when none does.  Every format at D <=
// 128 fits 64: e.g. the 500-token tile at D 64 kv8 is 7 x 64 + 52; at D
// 288 kv16 fits 48 (a 64-token block is 48 + 16).  The combine's partial
// (m, l, acc) area, 64 x (D + 2) f32 (74 KB at D 288), is in the total.
__host__ __device__ inline int sub_rows(int D, int rb, int bs) {
  if (smem_layout(D, rb, bs).total <= size_t(MAX_SMEM)) return bs;
  for (int sub = KSL; sub >= 16; sub -= 16)
    if (smem_layout(D, rb, sub).total <= size_t(MAX_SMEM)) return sub;
  return 0;
}

// Block (c, h, z) of the grid: query rows [row0, row0 + 64) of slot b =
// z / ceil(R / 64), kv-head h, split c, against the KV tiles s < n_tiles of
// bs tokens.  Tile s sits at logical positions s * bs + j and at flat
// token rows tile_tok0(b, s) + j of the store k/v (tokens, Hkv, ROW_BYTES),
// scales (tokens, Hkv): a dense slab (B * S tokens) and a paged pool
// (n_blocks * bs tokens) flatten alike, so the two kernels differ only in
// tile_tok0 and n_tiles.  With SUB the walk visits the tiles' sub-tiles
// (sub_rows): sub-tile u is tokens [j0, j0 + len) of tile u / nsub, j0 =
// (u % nsub) * sub; without it (the tile fits) u is the tile itself.
// Rows are token-major (r = t * rep + g): row r's frontier is pos[b] + r
// / rep, an absolute position; the tiles hold the keys from absolute
// position key0 on (a rank's range of a sequence-sharded slab: key0 > 0
// shifts every frontier by -key0, and a frontier before key0 keeps
// nothing).  With lse non-null each row's log-sum-exp of its kept scaled
// scores, mx + log(l) in f32, goes to lse[row] ((B, Hkv, R)), -inf for a
// row that keeps no key (its output is then 0), and the output goes
// unrounded to out32 (f32) instead of out, so partial results over
// disjoint key ranges combine exactly and are rounded once.  Stored rows
// are copied as 16-byte words (ROW_BYTES is a multiple of 16 for every
// format at D in {32, 64, 128, 288}).
template <Fmt F, int D, bool SUB, class TileTok>
__device__ void decode_rows(const bf16* __restrict__ q,
                            const uint8_t* __restrict__ k,
                            const float* __restrict__ k_scale,
                            const uint8_t* __restrict__ v,
                            const float* __restrict__ v_scale,
                            const int* __restrict__ pos,
                            bf16* __restrict__ out, int Hkv, int R, int rep,
                            int bs, int n_tiles, int window,
                            TileTok tile_tok0, int key0 = 0,
                            float* __restrict__ lse = nullptr,
                            float* __restrict__ out32 = nullptr) {
  constexpr int RB = row_bytes<F>(D);
  constexpr int VEC = RB / 16;           // 16-byte words per stored row
  constexpr int LD = D + PAD;
  constexpr int NT = D / 8;              // n8 tiles of an output row
  constexpr int NJ = KSL / 8;            // n8 score tiles of a slice
  constexpr int WD = d_warps(D);         // warps per 16-row group
  constexpr int NTW = NT / WD;           // n8 output tiles a warp keeps
  constexpr int NTHR = threads(D);
  constexpr bool QREG = WD == 1;         // Q fragments held in registers
  extern __shared__ __align__(16) unsigned char smem[];
  const int sub = SUB ? sub_rows(D, RB, bs) : bs;   // > 0: launch_rows
  const int nsub = SUB ? (bs + sub - 1) / sub : 1;    // sub-tiles a tile
  const Smem L = smem_layout(D, RB, sub);
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
  // the warp's 16-row group and its part of D
  const int wgrp = WD == 1 ? warp : warp % (ROW_TILE / 16);
  const int dpart = WD == 1 ? 0 : warp / (ROW_TILE / 16);
  const int g = lane >> 2, t = lane & 3;
  const size_t q_off = (size_t(b) * Hkv + h) * R + row0;   // in rows
  const int p0 = pos[b] - key0;            // frontiers in tile positions

  // sub-tiles that can hold a kept key of rows [row0, row0 + rows), and
  // the first of them that belongs to split c
  const int f_lo = p0 + row0 / rep, f_hi = p0 + (row0 + rows - 1) / rep;
  auto unit_of = [&](int key) {
    return SUB ? key / bs * nsub + key % bs / sub : key / bs;
  };
  const int u_lo = unit_of(max(0, f_lo - window + 1));
  // (a frontier before the first key: the rows keep nothing here)
  const int u_hi = f_hi < 0 ? -1 : min(n_tiles * nsub - 1, unit_of(f_hi));
  const int u_first = u_lo + ((c - u_lo % SPLITS) + SPLITS) % SPLITS;

  auto load_tile = [&](int u, int stage) {
    unsigned char* base = smem + stage * L.stage;
    float* ks = reinterpret_cast<float*>(base + 2 * sub * RB);
    const int j0 = SUB ? u % nsub * sub : 0;
    const int len = SUB ? min(sub, bs - j0) : bs;
    const size_t tok0 = tile_tok0(b, SUB ? u / nsub : u) + j0;
    for (int i = threadIdx.x; i < len * VEC; i += NTHR) {
      const int j = i / VEC, w = i % VEC;
      const size_t off = ((tok0 + j) * Hkv + h) * RB + w * 16;
      ptx::cp_async16(base + i * 16, k + off);
      ptx::cp_async16(base + sub * RB + i * 16, v + off);
    }
    for (int j = threadIdx.x; j < len; j += NTHR) {
      ptx::cp_async4(ks + j, k_scale + (tok0 + j) * Hkv + h);
      ptx::cp_async4(ks + sub + j, v_scale + (tok0 + j) * Hkv + h);
    }
  };

  // Q rows (zeros past R), then the split's first tile
  for (int i = threadIdx.x; i < ROW_TILE * (D / 8); i += NTHR) {
    const int r = i / (D / 8), w = i % (D / 8);
    const bool ok = r < rows;
    ptx::cp_async16(qs + r * LD + w * 8, q + (q_off + (ok ? r : 0)) * D + w * 8,
                    ok ? 16 : 0);
  }
  ptx::cp_commit();
  if (u_first <= u_hi) load_tile(u_first, 0);
  ptx::cp_commit();
  const bf16 zero = __float2bfloat16_rn(0.f);
  const int n16 = (sub + 15) / 16 * 16;
  for (int i = threadIdx.x; i < (n16 - sub) * LD; i += NTHR) {
    kd[sub * LD + i] = zero;               // padding keys: zero and masked
    vd[sub * LD + i] = zero;
  }
  ptx::cp_wait<1>();                       // Q has arrived
  __syncthreads();

  const int wrow = wgrp * 16;
  const bool active = wrow < rows;         // warp-uniform
  uint32_t qf[QREG ? D / 16 : 1][4];
  if constexpr (QREG) {
    if (active) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ptx::load_a(qf[kk], qs + wrow * LD + kk * 16, LD, lane);
    }
  }
  const int qa = p0 + (row0 + wrow + g) / rep;       // frontier of row g
  const int qb = p0 + (row0 + wrow + g + 8) / rep;   // and of row g + 8
  const float inv_sqrt_d = 1.0f / sqrtf(static_cast<float>(D));

  float acc[NTW][4];
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  int stage = 0;
  for (int u = u_first; u <= u_hi; u += SPLITS) {
    if (u + SPLITS <= u_hi) load_tile(u + SPLITS, stage ^ 1);
    ptx::cp_commit();
    ptx::cp_wait<1>();                     // sub-tile u has arrived
    __syncthreads();                       // ... for every thread; kd/vd free

    // tokens [j0, j0 + len) of tile u / nsub; a ragged last sub-tile's
    // rows [len, len16) are zeroed here (a full one's were zeroed above)
    const int j0 = SUB ? u % nsub * sub : 0;
    const int len = SUB ? min(sub, bs - j0) : bs;
    const int len16 = len == sub ? n16 : (len + 15) / 16 * 16;
    const int dq_rows = len == sub ? len : len16;

    // _dequant_tile: bf16(float(q) * scale), 8 elements a thread-step
    const unsigned char* base = smem + stage * L.stage;
    const float* ks = reinterpret_cast<const float*>(base + 2 * sub * RB);
    for (int i = threadIdx.x; i < dq_rows * (D / 8); i += NTHR) {
      const int j = i / (D / 8), c0 = (i % (D / 8)) * 8;
      uint32_t kw[4] = {0u, 0u, 0u, 0u}, vw[4] = {0u, 0u, 0u, 0u};
      if (!SUB || j < len) {
        const uint8_t* kr = base + j * RB;
        const uint8_t* vr = base + sub * RB + j * RB;
        const float sk = ks[j], sv = ks[sub + j];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          kw[e] = ptx::pack_bf16(load_elem<F>(kr, c0 + 2 * e) * sk,
                                 load_elem<F>(kr, c0 + 2 * e + 1) * sk);
          vw[e] = ptx::pack_bf16(load_elem<F>(vr, c0 + 2 * e) * sv,
                                 load_elem<F>(vr, c0 + 2 * e + 1) * sv);
        }
      }
      *reinterpret_cast<uint4*>(kd + j * LD + c0) =
          make_uint4(kw[0], kw[1], kw[2], kw[3]);
      *reinterpret_cast<uint4*>(vd + j * LD + c0) =
          make_uint4(vw[0], vw[1], vw[2], vw[3]);
    }
    __syncthreads();

    if (active) {
      for (int k0 = 0; k0 < len16; k0 += KSL) {
        const int nk = min(KSL, len16 - k0) / 16;   // k16 steps of the slice
        float sc[NJ][4];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[j][i] = 0.f;
        if constexpr (QREG) {
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
            for (int j = 0; j < NJ / 2; ++j) {
              if (j >= nk) break;
              uint32_t bf[4];
              ptx::load_b_rows(bf, kd + (k0 + 16 * j) * LD + kk * 16, LD,
                               lane);
              ptx::mma_bf16(sc[2 * j], qf[kk], bf);
              ptx::mma_bf16(sc[2 * j + 1], qf[kk], bf + 2);
            }
        } else {                           // Q fragments re-read per k16
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t qk[4];
            ptx::load_a(qk, qs + wrow * LD + kk * 16, LD, lane);
#pragma unroll
            for (int j = 0; j < NJ / 2; ++j) {
              if (j >= nk) break;
              uint32_t bf[4];
              ptx::load_b_rows(bf, kd + (k0 + 16 * j) * LD + kk * 16, LD,
                               lane);
              ptx::mma_bf16(sc[2 * j], qk, bf);
              ptx::mma_bf16(sc[2 * j + 1], qk, bf + 2);
            }
          }
        }
        const int kbase = (SUB ? u / nsub : u) * bs + j0 + k0;   // column 0
        ptx::softmax_update<NJ, NTW>(
            sc, inv_sqrt_d,
            [&](int j, int i) {
              const int col = k0 + 8 * j + 2 * t + (i & 1);
              const int kpos = kbase + 8 * j + 2 * t + (i & 1);
              const int qp = i < 2 ? qa : qb;
              return col < len && kpos <= qp && kpos > qp - window;
            },
            m, l, acc);
        ptx::pv_update<NJ, NTW>(sc, vd + k0 * LD + dpart * (D / WD), LD,
                                lane, nk, acc);
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
    if (t == 0 && dpart == 0) {
      pm[ra] = m[0];
      pl[ra] = l[0];
      pm[rb] = m[1];
      pl[rb] = l[1];
    }
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      const int d = dpart * (D / WD) + n * 8 + 2 * t;
      pa[ra * D + d] = acc[n][0];
      pa[ra * D + d + 1] = acc[n][1];
      pa[rb * D + d] = acc[n][2];
      pa[rb * D + d + 1] = acc[n][3];
    }
  }
  cluster.sync();
  // block c finishes rows c, c + 8, ...: splits combined in rank order
  for (int i = threadIdx.x; i < ROW_TILE / SPLITS * D; i += NTHR) {
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
    const float o = a / fmaxf(lsum, 1e-20f);
    if (lse == nullptr) {
      out[(q_off + r) * D + d] = __float2bfloat16_rn(o);
    } else {
      out32[(q_off + r) * D + d] = o;
      if (d == 0) lse[q_off + r] = lsum > 0.f ? mx + logf(lsum) : -INFINITY;
    }
  }
  cluster.sync();                          // partials read by every block
}

// Launch `whole` (a bs-token tile fits) or `subtiled` (decode_rows with
// SUB) on a (SPLITS, Hkv, B * ceil(R / ROW_TILE)) grid in clusters of
// SPLITS blocks along x, with the shared memory of (D, ROW_BYTES)
// (sub-)tiles.  Returns ERR_SMEM when not even a 16-token sub-tile fits
// (no head dim the kernels take), else the CUDA error of the launch (0 on
// success; a refused cluster launch returns its error).
template <Fmt F, int D, class... KArgs, class... Args>
int launch_rows(void (*whole)(KArgs...), void (*subtiled)(KArgs...), int B,
                int Hkv, int R, int bs, cudaStream_t st, Args... args) {
  const int sub = sub_rows(D, row_bytes<F>(D), bs);
  if (sub == 0) return ERR_SMEM;
  void (*kern)(KArgs...) = sub == bs ? whole : subtiled;
  const Smem L = smem_layout(D, row_bytes<F>(D), sub);
  if (L.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L.total));
    if (e != cudaSuccess) return int(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(SPLITS, Hkv, B * ((R + ROW_TILE - 1) / ROW_TILE));
  cfg.blockDim = dim3(threads(D));
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
    case 288: return fn.template run<F, 288>();
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
