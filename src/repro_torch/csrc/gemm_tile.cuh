// The mainloop of both mixed-precision GEMMs (mpgemm.cu: bf16 activations,
// mpgemm_int8.cu: int8 activations): y (M, N) bf16 = x (M, K) @ W, W packed
// at bits 4 or 8 in the kernel's fragment order (core/packing.py
// to_kernel_layout: frag_a16 or frag_a8), data (N/16, K/64, 32 lanes,
// 4 * BITS bytes), scales (K/group, N) f32.
//
// What bounds it on an H100: the weights' bytes at decode (M = 4: 8 flops
// per 4-bit weight byte; group 32 adds 1 f32 scale per 32 weights, 25 % of
// the 4-bit bytes), operations and bytes alike at M = 128.  The design:
//   * Swapped operands, y^T = W^T x^T: a warp owns 16 weight columns (the
//     MMA's 16 rows) and every token of the block as n8 tiles (1, 2, 4,
//     then 16; launch_bits), so one instruction, mma.sync m16n8k16
//     bf16 or m16n8k32 s8, serves every M and a decode step wastes no MMA
//     rows.  (wgmma with the weights as its register A operand was tried
//     and was slower at every measured shape.)
//   * Fragment-order weights: a lane's weights of one 64-deep chunk are
//     16 (bits 4) or 32 (bits 8) contiguous bytes, one or two shared loads;
//     bf16 weights come from nibbles or bytes by LOP3 into an f32 whose
//     exponent is 2^23 (the value is 2^23 + u exactly), FADD and FMUL by
//     the f32 scale, then one cvt to bf16x2 per pair: bf16(float(q) * s)
//     as the plain version computes it.  The s8 operand is the nibble
//     shifted to the high half of its byte (16 q, exact; the group scale
//     is divided by 16, exactly) or the byte itself.
//   * A cp.async ring of 4-8 chunks (weights, the chunk's scale rows and
//     the block's x rows); x fragments come from shared memory by
//     ldmatrix.
//   * Split-K over a cluster of S blocks, S fixed by the weight's shape
//     and the card, never by M (splits() below): block rank r owns a
//     contiguous run of K units of max(64, group), so a group is never
//     split, and the S partial tiles are added in rank order through
//     distributed shared memory in the same launch.  The same rows give
//     the same bits whatever M is.
// One block: 8 warps, one m16 column tile each (128 weight columns), x BM
// = 8 NT tokens.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_tile.cuh"

namespace gemm {

namespace cg = cooperative_groups;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BN = WARPS * 16;      // weight columns per block
constexpr int KC = 64;              // K depth of one chunk (ring stage)
constexpr int MAX_SPLITS = 16;     // > 8: non-portable cluster

// c += a b: m16n8k32, s8 inputs, s32 accumulators (exact).  Not volatile,
// as mma_bf16 below: pure register operations the compiler may schedule
// among the shared loads.
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b: m16n8k16, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// float(v) for |v| < 2^22, exactly: the bits of 1.5 * 2^23 + v, less
// 1.5 * 2^23 (two full-rate operations instead of a quarter-rate I2F).
__device__ __forceinline__ float s32_to_f32(int v) {
  return __fsub_rn(__int_as_float(v + 0x4B400000), 12582912.f);
}

// c += float(p) * (s, s, s8, s8), then p = 0: a group's exact s32 partial
// into the f32 accumulators.
__device__ __forceinline__ void flush_group(float* c, int* p, float s,
                                            float s8) {
  c[0] = __fmaf_rn(s32_to_f32(p[0]), s, c[0]);
  c[1] = __fmaf_rn(s32_to_f32(p[1]), s, c[1]);
  c[2] = __fmaf_rn(s32_to_f32(p[2]), s8, c[2]);
  c[3] = __fmaf_rn(s32_to_f32(p[3]), s8, c[3]);
  p[0] = p[1] = p[2] = p[3] = 0;
}

// float(q) * s for the field of `w` (offset binary: u = q + 2^(W-1)) under
// `mask` = (2^W - 1) << P, as (2^23 + u 2^P - 2^23 - 2^(W-1) 2^P) *
// (s 2^-P): both factors exact, so one rounding, the plain version's.
template <int W, int P>
__device__ __forceinline__ float deq(uint32_t w, float s) {
  constexpr uint32_t mask = ((1u << W) - 1u) << P;
  constexpr float bias = 8388608.f + float((1u << (W - 1)) << P);
  constexpr float down = 1.f / float(1u << P);
  const float f = __uint_as_float((w & mask) | 0x4B000000u);
  return __fmul_rn(__fsub_rn(f, bias), s * down);
}

template <bool A8>
struct XTraits {                     // x rows in shared memory
  static constexpr int BYTES = A8 ? KC : 2 * KC;    // one chunk of a row
  static constexpr int ROW = BYTES + 16;   // padded: ldmatrix conflict-free
};

// A block: WARPS warps, each one m16 column tile (16 weight columns) x NT
// n8 token tiles; a ring of STAGES chunks.
template <bool A8, int BITS, int NT, int STAGES>
struct Tile {
  static constexpr int BM = 8 * NT;                // tokens
  static constexpr int TILE_BYTES = 16 * KC * BITS / 8;   // one m16 tile
  static constexpr int W = WARPS * TILE_BYTES;
  static constexpr int S = 2 * BN * 4;             // two scale rows
  static constexpr int X = BM * XTraits<A8>::ROW;
  static constexpr int STAGE = W + S + X;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int PST = BN + 4;               // partial-tile row stride
  static constexpr int PART = BM * PST * 4;
  static constexpr int SMEM = RING > PART ? RING : PART;
};

struct Args {
  const void* x;          // (M, K) bf16 (A16) or int8 (A8)
  const float* xscale;    // (M,) per-token scales (A8 only)
  const int8_t* w;        // (N/16, K/64, 32, 4 * BITS) fragment order
  const float* scales;    // (K/group, N)
  __nv_bfloat16* y;       // (M, N)
  int M, K, N, group;
};

// The A operand (weights, 16 columns x 16 k) of k16 step (j, h) from a
// lane's chunk words (frag_a16 order: byte b of lane t holds k = 2t +
// 8 (b >> 1) + (b & 1)): bf16(float(q) * s), column g scaled by s_g,
// column g + 8 by s_g8.
template <int BITS>
__device__ __forceinline__ void a16_frag(uint32_t* fa, const uint32_t* wd,
                                         int j, int h, float s_g,
                                         float s_g8) {
  if constexpr (BITS == 4) {
    const uint32_t w = wd[2 * j + h] ^ 0x88888888u, wh = w >> 16;
    fa[0] = ptx::pack_bf16(deq<4, 0>(w, s_g), deq<4, 8>(w, s_g));
    fa[1] = ptx::pack_bf16(deq<4, 4>(w, s_g8), deq<4, 12>(w, s_g8));
    fa[2] = ptx::pack_bf16(deq<4, 0>(wh, s_g), deq<4, 8>(wh, s_g));
    fa[3] = ptx::pack_bf16(deq<4, 4>(wh, s_g8), deq<4, 12>(wh, s_g8));
  } else {
    const uint32_t w0 = wd[4 * j + 2 * h] ^ 0x80808080u;
    const uint32_t w1 = wd[4 * j + 2 * h + 1] ^ 0x80808080u;
    fa[0] = ptx::pack_bf16(deq<8, 0>(w0, s_g), deq<8, 8>(w0, s_g));
    fa[1] = ptx::pack_bf16(deq<8, 0>(w1, s_g8), deq<8, 8>(w1, s_g8));
    fa[2] = ptx::pack_bf16(deq<8, 0>(w0 >> 16, s_g),
                           deq<8, 8>(w0 >> 16, s_g));
    fa[3] = ptx::pack_bf16(deq<8, 0>(w1 >> 16, s_g8),
                           deq<8, 8>(w1 >> 16, s_g8));
  }
}

// The s8 A operand of k32 step j (frag_a8 order: byte b of lane t holds
// k = 4t + b of each 16-k half): 16 q (bits 4: the nibble in the high half
// of its byte) or q (bits 8).
template <int BITS>
__device__ __forceinline__ void a8_frag(uint32_t* fa, const uint32_t* wd,
                                        int j) {
  if constexpr (BITS == 4) {
    const uint32_t w0 = wd[2 * j], w1 = wd[2 * j + 1];
    fa[0] = (w0 << 4) & 0xF0F0F0F0u;
    fa[1] = w0 & 0xF0F0F0F0u;
    fa[2] = (w1 << 4) & 0xF0F0F0F0u;
    fa[3] = w1 & 0xF0F0F0F0u;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) fa[e] = wd[4 * j + e];
  }
}

// Grid (ceil(N / BN) * S, ceil(M / BM)), clusters of S blocks along x.
// LOCAL (A8): every group ends inside its chunk (group <= 64), so an n8
// tile's s32 partial lives in four registers instead of NT x 4.
template <bool A8, int BITS, int NT, int STAGES, bool LOCAL = false>
__global__ void __launch_bounds__(THREADS, A8 && !LOCAL ? 1 : 2)
gemm_kernel(Args a) {
  using L = Tile<A8, BITS, NT, STAGES>;
  using XT = XTraits<A8>;
  constexpr int BM = L::BM, PST = L::PST;
  constexpr int LANE = L::TILE_BYTES / 32;        // bytes a lane, a tile
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = int(cluster.num_blocks());
  const int rank = int(cluster.block_rank());
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int cb = blockIdx.x / S;                 // column block
  const int m0 = blockIdx.y * BM;
  const int ct = cb * WARPS + warp;              // the warp's column tile
  const bool live = ct * 16 < a.N;
  const int nchunk = a.K / KC;
  const int unit = a.group > KC ? a.group / KC : 1;   // chunks per unit
  const int nunit = nchunk / unit;
  const int c0 = rank * nunit / S * unit, c1 = (rank + 1) * nunit / S * unit;
  const int n_chunks = c1 - c0;
  const int srows = a.group == 32 ? 2 : 1;
  const int gshift = a.group == 32 ? 5 : a.group == 64 ? 6 : 7;

  auto stage = [&](int s) { return smem + s * L::STAGE; };
  auto load = [&](int i) {                       // chunk c0 + i -> its slot
    unsigned char* st = stage(i % STAGES);
    const int c = c0 + i;
    if (live) {
      const int8_t* src =
          a.w + (size_t(ct) * nchunk + c) * L::TILE_BYTES + lane * LANE;
      unsigned char* dst = st + threadIdx.x * LANE;
#pragma unroll
      for (int v = 0; v < LANE / 16; ++v)
        ptx::cp_async16(dst + 16 * v, src + 16 * v);
    }
    float* ssm = reinterpret_cast<float*>(st + L::W);
    constexpr int SQ = BN / 4;                   // 16-byte pieces a row
    for (int k = threadIdx.x; k < srows * SQ; k += THREADS) {
      const int r = k / SQ, col = cb * BN + (k % SQ) * 4;
      if (col < a.N)
        ptx::cp_async16(ssm + r * BN + (k % SQ) * 4,
                        a.scales + size_t(((c * KC) >> gshift) + r) * a.N +
                            col);
    }
    unsigned char* xsm = st + L::W + L::S;
    constexpr int PIECES = XT::BYTES / 16;
    const unsigned char* x = static_cast<const unsigned char*>(a.x);
    for (int k = threadIdx.x; k < BM * PIECES; k += THREADS) {
      const int r = k / PIECES, p = k % PIECES;
      const int tok = min(m0 + r, a.M - 1);
      ptx::cp_async16(xsm + r * XT::ROW + 16 * p,
                      x + (size_t(tok) * a.K + size_t(c) * KC) *
                              (A8 ? 1 : 2) + 16 * p,
                      m0 + r < a.M ? 16 : 0);
    }
  };

  float acc[NT][4];
  int part[A8 && !LOCAL ? NT : 1][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[n][e] = 0.f;
      if constexpr (A8 && !LOCAL) part[n][e] = 0;
    }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks) load(s);
    ptx::cp_commit();
  }
  for (int i = 0; i < n_chunks; ++i) {
    ptx::cp_wait<STAGES - 2>();
    __syncthreads();
    if (i + STAGES - 1 < n_chunks) load(i + STAGES - 1);
    ptx::cp_commit();
    if (!live) continue;
    const unsigned char* st = stage(i % STAGES);
    const float* ssm = reinterpret_cast<const float*>(st + L::W);
    const unsigned char* xsm = st + L::W + L::S;
    uint32_t wd[LANE / 4];
#pragma unroll
    for (int v = 0; v < LANE / 16; ++v) {
      const uint4 q =
          *reinterpret_cast<const uint4*>(st + threadIdx.x * LANE + 16 * v);
      wd[4 * v] = q.x;
      wd[4 * v + 1] = q.y;
      wd[4 * v + 2] = q.z;
      wd[4 * v + 3] = q.w;
    }
    if constexpr (!A8) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {              // k32 steps of the chunk
        const float* sr = ssm + (srows == 2 ? j : 0) * BN + warp * 16 + g;
        const float s_g = sr[0], s_g8 = sr[8];
        uint32_t fa[2][4];                       // its two k16 steps
        a16_frag<BITS>(fa[0], wd, j, 0, s_g, s_g8);
        a16_frag<BITS>(fa[1], wd, j, 1, s_g, s_g8);
        // x fragments of both steps for an n8 tile: four 8 x 8 matrices,
        // k 32 j + 8 m, m = lane / 8
        const unsigned char* xp =
            xsm + (lane & 7) * XT::ROW + (32 * j + 8 * (lane >> 3)) * 2;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t fb[4];
          ptx::ldsm_x4(fb, xp + n * 8 * XT::ROW);
          mma_bf16(acc[n], fa[0], fb);
          mma_bf16(acc[n], fa[1], fb + 2);
        }
      }
    } else {
      // both k32 steps, one n8 tile after another; a group's exact s32
      // partial goes into the accumulators, times its scale, where the
      // group ends: after each step (group 32), after the chunk (64) or
      // after every second chunk (128)
      constexpr float down = BITS == 4 ? 1.f / 16.f : 1.f;
      const float* sr0 = ssm + warp * 16 + g;
      const float* sr1 = sr0 + (srows == 2 ? BN : 0);
      const float s0 = sr0[0] * down, s08 = sr0[8] * down;
      const float s1 = sr1[0] * down, s18 = sr1[8] * down;
      const bool end0 = a.group == 32;
      const bool end1 = (((c0 + i + 1) * KC) & (a.group - 1)) == 0;
      uint32_t fa[2][4];
      a8_frag<BITS>(fa[0], wd, 0);
      a8_frag<BITS>(fa[1], wd, 1);
      // x fragments of both steps for an n8 tile: four 8 x 16-byte
      // matrices, k 16 m, m = lane / 8
      const unsigned char* xp =
          xsm + (lane & 7) * XT::ROW + 16 * (lane >> 3);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t fb[4];
        ptx::ldsm_x4(fb, xp + n * 8 * XT::ROW);
        int local[4] = {0, 0, 0, 0};
        int* p = LOCAL ? local : part[LOCAL ? 0 : n];
        mma_s8(p, fa[0], fb);
        if (end0) flush_group(acc[n], p, s0, s08);
        mma_s8(p, fa[1], fb + 2);
        if (end1) flush_group(acc[n], p, s1, s18);
      }
    }
  }

  // the partial tile [token][column] over the ring, then the cluster's
  // partials added in rank order; block `rank` finishes tokens rank,
  // rank + S, ...
  ptx::cp_wait<0>();
  __syncthreads();
  float* pt = reinterpret_cast<float*>(smem);
  if (live) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int r = n * 8 + 2 * t, col = warp * 16 + g;
      pt[r * PST + col] = acc[n][0];
      pt[(r + 1) * PST + col] = acc[n][1];
      pt[r * PST + col + 8] = acc[n][2];
      pt[(r + 1) * PST + col + 8] = acc[n][3];
    }
  }
  cluster.sync();
  // four columns a thread, the partials loaded four ranks at a time and
  // added in rank order
  constexpr int Q = BN / 4;
  const int my_rows = (BM - rank + S - 1) / S;
  for (int k = threadIdx.x; k < my_rows * Q; k += THREADS) {
    const int r = rank + S * (k / Q), col = (k % Q) * 4;
    const int m = m0 + r, n = cb * BN + col;
    if (m >= a.M || n >= a.N) continue;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    for (int p0 = 0; p0 < S; p0 += 4) {
      float4 v[4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
        if (p0 + p < S)
          v[p] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(pt + r * PST + col, p0 + p));
#pragma unroll
      for (int p = 0; p < 4; ++p)
        if (p0 + p < S) {
          sum[0] += v[p].x;
          sum[1] += v[p].y;
          sum[2] += v[p].z;
          sum[3] += v[p].w;
        }
    }
    if constexpr (A8) {
      const float xs = a.xscale[m];
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[e] *= xs;
    }
    *reinterpret_cast<uint2*>(a.y + size_t(m) * a.N + n) =
        make_uint2(ptx::pack_bf16(sum[0], sum[1]),
                   ptx::pack_bf16(sum[2], sum[3]));
  }
  cluster.sync();                      // partials read by every block
}

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// Blocks of the split: the power of two that gives each of the card's SMs
// a block, at most MAX_SPLITS, then clamped to the number of K units and
// to half the number of 64-deep chunks, rounded up (a block of one chunk
// has no load to overlap, and at M 128 its share of the combine costs more
// than its MMAs).  A function of the weight's shape and the card only.
inline int splits(int K, int N, int group) {
  const int sms = sm_count();
  const int nb = (N + BN - 1) / BN;
  const int nunit = K / (group > KC ? group : KC);
  const int half = (K / KC + 1) / 2;
  const int want = (sms + nb - 1) / nb;
  int s = 1;
  while (s < want && s < MAX_SPLITS) s *= 2;
  s = s < nunit ? s : nunit;
  s = s < half ? s : half;
  return s > 1 ? s : 1;
}

template <bool A8, int BITS, int NT, int STAGES, bool LOCAL = false>
int launch_tile(const Args& a, cudaStream_t st) {
  using L = Tile<A8, BITS, NT, STAGES>;
  auto kern = gemm_kernel<A8, BITS, NT, STAGES, LOCAL>;
  if (L::SMEM > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return int(e);
  }
  const int S = splits(a.K, a.N, a.group);
  if (S > 8) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return int(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((a.N + BN - 1) / BN) * S, (a.M + L::BM - 1) / L::BM);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
}

// The token tile by M: 8, 16 and 32 tokens, then 128, so that one pass
// covers a 128-token prefill chunk and each weight is read once.  A8 keeps
// 64 tokens up to M 64; past it too where a group spans two chunks (group
// 128: the s32 partials of every n8 tile live across chunks, twice the
// accumulator registers) or where the 128-token grid would leave more
// than half the SMs idle (then two 64-token rows of blocks beat reading
// each weight once).  The tile changes how many MMAs share a weight
// fragment, never a row's sum: the K split is the same at every M.
template <bool A8, int BITS>
int launch_bits(const Args& a, cudaStream_t st) {
  if (a.M <= 8) return launch_tile<A8, BITS, 1, 8>(a, st);
  if (a.M <= 16) return launch_tile<A8, BITS, 2, 8>(a, st);
  if (a.M <= 32) return launch_tile<A8, BITS, 4, 6>(a, st);
  if constexpr (A8) {
    const int blocks = (a.N + BN - 1) / BN * splits(a.K, a.N, a.group);
    if (a.M <= 64 || a.group > KC || 2 * blocks < sm_count())
      return launch_tile<A8, BITS, 8, 4>(a, st);
  }
  return launch_tile<A8, BITS, 16, 4, A8>(a, st);
}

// Shape checks shared by both entry points; then the launch.
template <bool A8>
int launch(const Args& a, int bits, cudaStream_t st) {
  if (a.M < 1 || a.K % KC || a.N % 16 ||
      (a.group != 32 && a.group != 64 && a.group != 128) ||
      a.K % a.group)
    return int(cudaErrorInvalidValue);
  if (bits == 4) return launch_bits<A8, 4>(a, st);
  if (bits == 8) return launch_bits<A8, 8>(a, st);
  return int(cudaErrorInvalidValue);
}

}  // namespace gemm
