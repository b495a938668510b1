// Backward pass of flash attention (csrc/flash_prefill.cu): dQ, dK and dV
// of causal, sliding-window or non-causal bf16 attention with
// grouped-query heads, for training.
//
// The reference has no Pallas kernel here: it differentiates its XLA walk
// (jax.vjp of repro/core/attention.py:92 flash_attention).  This kernel
// computes the same gradients from the forward's saved q, k, v, out and
// per-row log-sum-exp, with the forward's masks (kpos < seq, kpos <= qpos
// if causal, kpos > qpos - window; query row t at qpos = pos_offset + t)
// and its rounding habit (bf16 operands into the tensor cores, f32 sums):
//   P    = exp(S * rsqrt(D) - lse)          (0 under the mask)
//   D_i  = rowsum(dO o O)
//   dV   = sum_i bf16(P)^T dO
//   dP   = dO V^T
//   dS   = P o (dP - D_i)
//   dQ   = rsqrt(D) * bf16(dS) K,   dK = rsqrt(D) * sum_i bf16(dS)^T Q
// A KV head's dK and dV sum over its rep query heads: the rows r = t * rep
// + g of one KV head, packed token-major as in the forward.  The plain
// version is repro_torch/kernels/ref.py flash_prefill_bwd_ref.
//
// What bounds it on an H100: operations (5 products of 2 D flops per kept
// (query, key) pair, 2.5 times the forward's) at the training shapes.
// Without atomics dQ needs S and dP again, so the kernels do 7 products a
// kept pair at every head dim: S^T, dP^T, dV, dK in the key-parallel
// pass and S, dP, dQ in the row-parallel one.  The design:
//   * delta_kernel: D / 8 lanes a row (16 bytes each) compute D_i in f32
//     and store it with the row's lse * log2(e) as one float2 at the
//     row's packed index, so a dK/dV walk copies its step's pairs into
//     shared memory with the Q / dO rows and P = exp2(S rsqrt(D) log2(e)
//     - lse log2(e)).
//   * The work plan (kernels/flashprefill.py bwd_plan, a table the
//     kernels read): each walk — the rows a key tile sees, the keys a row
//     tile sees — is cut into splits of near-equal kept pairs, as many as
//     a simulated schedule of the card's resident blocks says fill the
//     SMs best, the longest first, so the causal triangle's long walks
//     spread over many SMs and a grid of few walks (cross attention: 6
//     dQ walks) fills the card.  A walk of one split writes bf16 itself;
//     each split of a longer walk writes an f32 partial to scratch, and
//     split_sum_kernel sums a walk's partials in split order, scales and
//     rounds: fixed order, no atomics, so the gradients repeat bit for
//     bit.
//   * dq_kernel runs on a second stream, joined before the call returns,
//     beside delta_kernel and dkdv_kernel on the caller's stream.  Where
//     the plan finds the dQ pass's schedule the longer (dq_first) it
//     starts with the call, its blocks summing their own rows' D_i; else
//     it forks after delta_kernel, reads D_i and is launched after
//     dkdv_kernel, whose longer walks then take the SMs first.
//   * dkdv_kernel: a block owns BK = 64 keys of one KV head and all D
//     columns and walks its split's packed rows in steps (64 rows up to D
//     64, else 32) through a three-stage cp.async ring.  Up to D 128, 4
//     warps of 16 keys each compute S^T = K Q^T and dP^T = V dO^T for the
//     step (mma.sync m16n8k16, f32 accumulators), form P^T and dS^T and
//     accumulate dV += P^T dO, dK += dS^T Q, the C fragments reused as A
//     fragments.  Above D 128 the accumulators of all D columns would not
//     fit a warp's registers: 8 warps, two per 16-key group, each
//     computing S^T / dP^T for half the step's rows once, storing bf16
//     P^T and dS^T in shared memory, and after a barrier accumulating
//     dV and dK for its half of the columns from there.
//   * dq_kernel: a block owns 64 packed rows and walks its split's key
//     slices (64 keys up to D 128, else 32) through a cp.async ring,
//     warps skipping slices masked for all their rows.  Up to D 128, 4
//     warps of 16 rows compute S, dP and dS and accumulate dQ += dS K in
//     registers.  Above, two warps share each 16-row group: each computes
//     S and dP for half the slice's keys, stores bf16 dS in shared memory
//     and, after a barrier, accumulates dQ for its half of the columns
//     over the whole slice.
//   * At D 64 the operands a warp reads every step from the same rows (K
//     / V in dK/dV, Q / dO in dQ) stay in registers for the walk; steps
//     whose tile every row and key keeps skip the mask arithmetic.
// wgmma and TMA are not used (both GEMM kernels measured slower with
// wgmma at these tile sizes).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int MAX_SMEM = 232448;     // bytes of shared memory a block may use
constexpr int PAD = 8;               // bf16 padding per shared-memory row
constexpr int BK = 64;               // keys of a dK/dV block
constexpr int QROWS = 64;            // packed rows of a dQ block
constexpr float LOG2E = 1.4426950408889634f;

// warps sharing each 16-key (dK/dV) or 16-row (dQ) group, each keeping
// D / cw(D) columns of the gradient
__host__ __device__ constexpr int cw(int D) { return D > 128 ? 2 : 1; }
__host__ __device__ constexpr int warps(int D) { return 4 * cw(D); }
// packed rows per step of a dK/dV walk, keys per step of a dQ walk
// (flashprefill.bwd_kv_step / bwd_q_step)
__host__ __device__ constexpr int kv_step(int D) { return D <= 64 ? 64 : 32; }
__host__ __device__ constexpr int q_step(int D) { return D <= 128 ? 64 : 32; }
// cp.async ring depths: three stages (a step's wait leaves the next
// copies in flight), two for dQ at D 128 (two blocks an SM)
__host__ __device__ constexpr int kv_stages(int D) { return 3; }
__host__ __device__ constexpr int q_stages(int D) { return D == 128 ? 2 : 3; }

__host__ __device__ constexpr size_t dkdv_smem(int D) {
  return size_t(2 * BK + kv_stages(D) * 2 * kv_step(D)) * (D + PAD) * 2 +
         size_t(kv_stages(D)) * kv_step(D) * sizeof(float2) +
         (cw(D) > 1 ? size_t(2) * BK * (kv_step(D) + PAD) * 2 : 0);
}
__host__ __device__ constexpr size_t dq_smem(int D) {
  return size_t(2 * QROWS + q_stages(D) * 2 * q_step(D)) * (D + PAD) * 2 +
         (cw(D) > 1 ? size_t(QROWS) * (q_step(D) + PAD) * 2 : 0);
}

__device__ __forceinline__ bool keep(int kpos, int qpos, int kv_len,
                                     bool causal, int window) {
  return kpos < kv_len && (!causal || kpos <= qpos) && kpos > qpos - window;
}

// 8 bytes global -> shared; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   ptx::smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// Store the bf16 pairs of a warp's C fragments (NJ n8 tiles of 16 rows)
// at `p` = &tile[row0][col0] of a row-major tile with stride ld.
template <int NJ>
__device__ __forceinline__ void store_c(bf16* p, int ld, const float (*c)[4],
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    *reinterpret_cast<uint32_t*>(p + g * ld + j * 8 + 2 * t) =
        ptx::pack_bf16(c[j][0], c[j][1]);
    *reinterpret_cast<uint32_t*>(p + (g + 8) * ld + j * 8 + 2 * t) =
        ptx::pack_bf16(c[j][2], c[j][3]);
  }
}

// lanes that share a row of delta_kernel: one 16-byte word each (D / 8
// words, rounded up to a power of two), at most a warp
__host__ __device__ constexpr int row_lanes(int D) {
  return D / 8 >= 32 ? 32 : D / 8 > 8 ? 16 : D / 8 > 4 ? 8 : 4;
}

// D_i = sum_d dO[i, d] * O[i, d] in f32, stored with lse * log2(e) at the
// row's packed index: rows (b, hk, t * rep + g).  Grid ceil(rows / (256
// / row_lanes)), 256 threads, row_lanes(D) a row reading 16 bytes each.
template <int D>
__global__ void __launch_bounds__(256)
delta_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
             const float* __restrict__ lse, float2* __restrict__ rows_out,
             int H, int Hkv, int Sq, int rows) {
  constexpr int L = row_lanes(D), VEC = D / 8;
  const int lane = threadIdx.x % L;
  const int row = blockIdx.x * (256 / L) + threadIdx.x / L;
  float s = 0.f;
  if (row < rows) {
#pragma unroll
    for (int w = lane; w < VEC; w += L) {
      const uint4 a =
          *reinterpret_cast<const uint4*>(out + size_t(row) * D + w * 8);
      const uint4 b =
          *reinterpret_cast<const uint4*>(dout + size_t(row) * D + w * 8);
      const uint32_t av[4] = {a.x, a.y, a.z, a.w};
      const uint32_t bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&av[i]));
        const float2 y = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&bv[i]));
        s += x.x * y.x + x.y * y.y;
      }
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (row < rows && lane == 0) {
    const int rep = H / Hkv, t = row % Sq, h = row / Sq % H, b = row / Sq / H;
    const size_t packed =
        (size_t(b) * Hkv + h / rep) * size_t(rep) * Sq + size_t(t) * rep +
        h % rep;
    rows_out[packed] = make_float2(lse[row] * LOG2E, s);
  }
}

// Grid (kv items, Hkv, B), warps(D) warps.  Item blockIdx.x of the plan:
// (key tile x, first row, end row, slot) — keys [64 x, 64 x + 64) of KV
// head blockIdx.y, packed rows [first, end) of its walk.  Writes bf16 dK
// / dV when slot < 0, else its f32 partials (slot, b, hk, 64, D) of
// part_k and part_v.
template <int D>
__global__ void __launch_bounds__(warps(D) * 32)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float2* __restrict__ rows_in, const int* __restrict__ items,
            bf16* __restrict__ dk, bf16* __restrict__ dv,
            float* __restrict__ part_k, float* __restrict__ part_v, int H,
            int Hkv, int Sq, int Sk, int kv_len, int causal, int window,
            int off) {
  constexpr int CW = cw(D), BQ = kv_step(D), ST = kv_stages(D);
  constexpr int LD = D + PAD, LDP = BQ + PAD;
  constexpr int DC = D / CW;         // columns a warp accumulates
  constexpr int NT = DC / 8;         // their n8 tiles
  constexpr int NJ = BQ / CW / 8;    // n8 tiles of the S^T a warp computes
  constexpr int VEC = D / 8;         // 16-byte words per row
  static_assert(DC % 16 == 0 && NJ % 2 == 0, "whole k16 column pairs");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BK * LD;
  bf16* ring = Vs + BK * LD;         // stage i: Q rows, then dO rows
  float2* lds = reinterpret_cast<float2*>(ring + ST * 2 * BQ * LD);
  bf16* Ps = reinterpret_cast<bf16*>(lds + ST * BQ);   // CW 2: P^T, dS^T
  bf16* dSs = Ps + BK * LDP;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kg = warp % 4, half = warp / 4;   // 16-key group, column half
  const int b = blockIdx.z, hk = blockIdx.y;
  const int* item = items + 4 * blockIdx.x;
  const int k0 = item[0] * BK, rb = item[1], re = item[2], slot = item[3];
  const int rep = H / Hkv;
  const size_t kvhead = (size_t(b) * Hkv + hk) * Sk * D;
  const float2* rows = rows_in + (size_t(b) * Hkv + hk) * size_t(rep) * Sq;
  auto row_idx = [&](int r) {
    return (size_t(b) * H + hk * rep + r % rep) * Sq + r / rep;
  };
  const int n_steps = re > rb ? (re - rb + BQ - 1) / BQ : 0;

  for (int i = threadIdx.x; i < BK * VEC; i += blockDim.x) {
    const int r = i / VEC, w = i % VEC;
    const bool ok = k0 + r < kv_len;        // past seq: zeros, masked
    const size_t src = kvhead + (ok ? size_t(k0 + r) * D : 0) + w * 8;
    ptx::cp_async16(Ks + r * LD + w * 8, k + src, ok ? 16 : 0);
    ptx::cp_async16(Vs + r * LD + w * 8, v + src, ok ? 16 : 0);
  }
  auto load_rows = [&](int step) {
    const int stage = step % ST;
    bf16* Qd = ring + stage * 2 * BQ * LD;
    bf16* Od = Qd + BQ * LD;
    const int rr0 = rb + step * BQ;
    for (int i = threadIdx.x; i < BQ * VEC; i += blockDim.x) {
      const int r = i / VEC, w = i % VEC;
      const bool ok = rr0 + r < re;
      const size_t src = (ok ? row_idx(rr0 + r) * D : 0) + w * 8;
      ptx::cp_async16(Qd + r * LD + w * 8, q + src, ok ? 16 : 0);
      ptx::cp_async16(Od + r * LD + w * 8, dout + src, ok ? 16 : 0);
    }
    for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
      const bool ok = rr0 + r < re;
      cp_async8(lds + stage * BQ + r, rows + (ok ? rr0 + r : 0), ok ? 8 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {        // K, V and the first rows
    if (s < n_steps) load_rows(s);
    ptx::cp_commit();
  }

  const float scale = rsqrtf(static_cast<float>(D));
  const float sl2 = scale * LOG2E;
  const bf16* Kw = Ks + kg * 16 * LD;
  const bf16* Vw = Vs + kg * 16 * LD;
  const int ka = k0 + kg * 16 + g, kb = ka + 8;   // fragment-row keys
  const int r_own = CW > 1 ? half * (BQ / CW) : 0;   // S^T rows a warp owns
  const int d0 = half * DC;
  float adk[NT][4], adv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;
  // at D 64 the warp's K / V A fragments stay in registers for the walk
  // (at D 32 they made ptxas spill)
  constexpr bool HOLD = D == 64;
  uint32_t hk_[HOLD ? D / 16 : 1][4], hv_[HOLD ? D / 16 : 1][4];

  for (int step = 0; step < n_steps; ++step) {
    ptx::cp_wait<ST - 2>();                 // this step's rows have arrived
    __syncthreads();                        // ... for all; the step ST - 1
    if (step + ST - 1 < n_steps) load_rows(step + ST - 1);   // back is free
    ptx::cp_commit();
    const int stage = step % ST;
    const bf16* Qd = ring + stage * 2 * BQ * LD;
    const bf16* Od = Qd + BQ * LD;
    const float2* ldw = lds + stage * BQ + r_own;
    const int rr0 = rb + step * BQ;
    const int rw0 = rr0 + r_own;            // first row of the warp's S^T

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ / CW rows a warp
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    if (HOLD && step == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        ptx::load_a(hk_[kk], Kw + kk * 16, LD, lane);
        ptx::load_a(hv_[kk], Vw + kk * 16, LD, lane);
      }
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      if (HOLD) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ak[e] = hk_[kk][e], av[e] = hv_[kk][e];
      } else {
        ptx::load_a(ak, Kw + kk * 16, LD, lane);
        ptx::load_a(av, Vw + kk * 16, LD, lane);
      }
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        uint32_t bq[4], bo[4];
        ptx::load_b_rows(bq, Qd + (r_own + j * 8) * LD + kk * 16, LD, lane);
        ptx::mma_bf16(s[j], ak, bq);
        ptx::mma_bf16(s[j + 1], ak, bq + 2);
        ptx::load_b_rows(bo, Od + (r_own + j * 8) * LD + kk * 16, LD, lane);
        ptx::mma_bf16(dp[j], av, bo);
        ptx::mma_bf16(dp[j + 1], av, bo + 2);
      }
    }
    // P^T (into s) and dS^T (into dp); column c of tile j is packed row
    // rw0 + 8 j + 2 t + c, at position off + its token.  A step every row
    // and key of the block keeps needs no mask.
    const int t_first = off + rr0 / rep, t_last = off + (rr0 + BQ - 1) / rep;
    const bool full = rr0 + BQ <= re && k0 + BK <= kv_len &&
                      (!causal || k0 + BK - 1 <= t_first) &&
                      k0 > t_last - window;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float2 ld = ldw[j * 8 + 2 * t + c];
        const int rr = rw0 + j * 8 + 2 * t + c;
        const int tok = full ? 0 : off + rr / rep;
#pragma unroll
        for (int h = 0; h < 2; ++h) {      // fragment rows g, g + 8
          const int e = 2 * h + c;
          const bool ok = full || (rr < re && keep(h ? kb : ka, tok, kv_len,
                                                   causal, window));
          const float p = ok ? exp2f(s[j][e] * sl2 - ld.x) : 0.f;
          dp[j][e] = p * (dp[j][e] - ld.y);
          s[j][e] = p;
        }
      }
    if constexpr (CW == 1) {
      // dV += bf16(P^T) dO and dK += bf16(dS^T) Q: the C fragments of two
      // n8 tiles are the A fragment of one k16 step
#pragma unroll
      for (int kk = 0; kk < NJ / 2; ++kk) {
        const uint32_t ap[4] = {
            ptx::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            ptx::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            ptx::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            ptx::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const uint32_t as[4] = {
            ptx::pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
            ptx::pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
            ptx::pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
            ptx::pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t bo[4], bq[4];
          ptx::load_b_cols(bo, Od + kk * 16 * LD + n * 8, LD, lane);
          ptx::mma_bf16(adv[n], ap, bo);
          ptx::mma_bf16(adv[n + 1], ap, bo + 2);
          ptx::load_b_cols(bq, Qd + kk * 16 * LD + n * 8, LD, lane);
          ptx::mma_bf16(adk[n], as, bq);
          ptx::mma_bf16(adk[n + 1], as, bq + 2);
        }
      }
    } else {
      // bf16 P^T / dS^T of the whole 64 x BQ step through shared memory;
      // each warp then accumulates its 16 keys x DC columns over BQ rows
      store_c<NJ>(Ps + kg * 16 * LDP + r_own, LDP, s, lane);
      store_c<NJ>(dSs + kg * 16 * LDP + r_own, LDP, dp, lane);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t ap[4], as[4];
        ptx::load_a(ap, Ps + kg * 16 * LDP + kk * 16, LDP, lane);
        ptx::load_a(as, dSs + kg * 16 * LDP + kk * 16, LDP, lane);
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t bo[4], bq[4];
          ptx::load_b_cols(bo, Od + kk * 16 * LD + d0 + n * 8, LD, lane);
          ptx::mma_bf16(adv[n], ap, bo);
          ptx::mma_bf16(adv[n + 1], ap, bo + 2);
          ptx::load_b_cols(bq, Qd + kk * 16 * LD + d0 + n * 8, LD, lane);
          ptx::mma_bf16(adk[n], as, bq);
          ptx::mma_bf16(adk[n + 1], as, bq + 2);
        }
      }
    }
  }
  ptx::cp_wait<0>();

  if (slot < 0) {
    // keys past seq (but inside Sk) get zeros: nothing was accumulated
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = d0 + n * 8 + 2 * t;
      if (ka < Sk) {
        const size_t o = kvhead + size_t(ka) * D + d;
        *reinterpret_cast<uint32_t*>(dk + o) =
            ptx::pack_bf16(adk[n][0] * scale, adk[n][1] * scale);
        *reinterpret_cast<uint32_t*>(dv + o) =
            ptx::pack_bf16(adv[n][0], adv[n][1]);
      }
      if (kb < Sk) {
        const size_t o = kvhead + size_t(kb) * D + d;
        *reinterpret_cast<uint32_t*>(dk + o) =
            ptx::pack_bf16(adk[n][2] * scale, adk[n][3] * scale);
        *reinterpret_cast<uint32_t*>(dv + o) =
            ptx::pack_bf16(adv[n][2], adv[n][3]);
      }
    }
    return;
  }
  const size_t base =
      ((size_t(slot) * gridDim.z + b) * Hkv + hk) * BK * D;
  float* pk = part_k + base;
  float* pv = part_v + base;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int d = d0 + n * 8 + 2 * t;
    const int ra = kg * 16 + g;
    *reinterpret_cast<float2*>(pk + ra * D + d) =
        make_float2(adk[n][0], adk[n][1]);
    *reinterpret_cast<float2*>(pv + ra * D + d) =
        make_float2(adv[n][0], adv[n][1]);
    *reinterpret_cast<float2*>(pk + (ra + 8) * D + d) =
        make_float2(adk[n][2], adk[n][3]);
    *reinterpret_cast<float2*>(pv + (ra + 8) * D + d) =
        make_float2(adv[n][2], adv[n][3]);
  }
}

// Grid (q items, Hkv, B), warps(D) warps.  Item blockIdx.x: (row tile y,
// first key, end key, slot) — packed rows [64 y, 64 y + 64) of KV head
// blockIdx.y against keys [first, end) (whole slices).  Writes bf16 dQ
// when slot < 0, else its f32 partial (slot, b, hk, 64, D) of part_q.
// blocks an SM must hold: dq_kernel at D 64 fits three in 170 registers
__host__ __device__ constexpr int dq_min_blocks(int D) {
  return D == 64 ? 3 : 1;
}

template <int D>
__global__ void __launch_bounds__(warps(D) * 32, dq_min_blocks(D))
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ out,
          const bf16* __restrict__ dout, const float* __restrict__ lse,
          const float2* __restrict__ rows_in,
          const int* __restrict__ items, bf16* __restrict__ dq,
          float* __restrict__ part_q, int H, int Hkv, int Sq, int Sk,
          int kv_len, int causal, int window, int off) {
  constexpr int CW = cw(D), SL = q_step(D), ST = q_stages(D);
  constexpr int LD = D + PAD, LDS = SL + PAD;
  constexpr int KW = SL / CW;        // keys of a slice a warp scores
  constexpr int NJ = KW / 8;
  constexpr int DC = D / CW;         // columns of dQ a warp keeps
  constexpr int NT = DC / 8;
  constexpr int VEC = D / 8;
  static_assert(DC % 16 == 0 && NJ % 2 == 0, "whole k16 column pairs");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Os = Qs + QROWS * LD;
  bf16* ring = Os + QROWS * LD;      // stage i: K slice, then V slice
  bf16* dSs = ring + ST * 2 * SL * LD;   // CW 2: the slice's bf16 dS

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % 4, half = warp / 4;   // 16-row group, key/col half
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int* item = items + 4 * blockIdx.x;
  const int r0 = item[0] * QROWS, kbeg = item[1], kend = item[2];
  const int slot = item[3];
  const int rep = H / Hkv, NR = rep * Sq;
  const size_t kvhead = (size_t(b) * Hkv + hk) * Sk * D;
  auto row_idx = [&](int r) {
    return (size_t(b) * H + hk * rep + r % rep) * Sq + r / rep;
  };
  const int n_steps = (kend - kbeg) / SL;

  for (int i = threadIdx.x; i < QROWS * VEC; i += blockDim.x) {
    const int r = i / VEC, w = i % VEC;
    const bool ok = r0 + r < NR;
    const size_t src = (ok ? row_idx(r0 + r) * D : 0) + w * 8;
    ptx::cp_async16(Qs + r * LD + w * 8, q + src, ok ? 16 : 0);
    ptx::cp_async16(Os + r * LD + w * 8, dout + src, ok ? 16 : 0);
  }
  auto load_kv = [&](int step) {
    bf16* Kd = ring + (step % ST) * 2 * SL * LD;
    bf16* Vd = Kd + SL * LD;
    const int kp0 = kbeg + step * SL;
    for (int i = threadIdx.x; i < SL * VEC; i += blockDim.x) {
      const int r = i / VEC, w = i % VEC;
      const bool ok = kp0 + r < kv_len;
      const size_t src = kvhead + (ok ? size_t(kp0 + r) * D : 0) + w * 8;
      ptx::cp_async16(Kd + r * LD + w * 8, k + src, ok ? 16 : 0);
      ptx::cp_async16(Vd + r * LD + w * 8, v + src, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {        // Q, dO and the first slices
    if (s < n_steps) load_kv(s);
    ptx::cp_commit();
  }

  const int rw = r0 + rg * 16;
  const int ra = rw + g, rb = ra + 8;
  // positions of the fragment rows and of the group's first and last row
  const int qa = off + ra / rep, qb = off + rb / rep;
  const int tw0 = off + rw / rep, tw1 = off + (min(rw + 16, NR) - 1) / rep;
  // (lse log2(e), D_i) of rows ra and rb: delta_kernel's, or without
  // them (dq_first) the block sums its own rows' D_i, D / 4 columns a lane
  // of the row's quad, and starts without waiting for delta_kernel
  float2 la = make_float2(0.f, 0.f), lb = la;
  if (rows_in) {
    const float2* rows = rows_in + (size_t(b) * Hkv + hk) * size_t(NR);
    if (ra < NR) la = rows[ra];
    if (rb < NR) lb = rows[rb];
  } else {
    float da = 0.f, db = 0.f;
#pragma unroll 1
    for (int w = 0; w < D / 32; ++w) {
      const int c = t * (D / 4) + w * 8;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = h ? rb : ra;
        if (r >= NR) continue;
        const size_t o = row_idx(r) * D + c;
        const uint4 x = *reinterpret_cast<const uint4*>(out + o);
        const uint4 y = *reinterpret_cast<const uint4*>(dout + o);
        const uint32_t xv[4] = {x.x, x.y, x.z, x.w};
        const uint32_t yv[4] = {y.x, y.y, y.z, y.w};
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 a = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&xv[i]));
          const float2 e = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&yv[i]));
          sum += a.x * e.x + a.y * e.y;
        }
        (h ? db : da) += sum;
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      da += __shfl_xor_sync(0xffffffffu, da, off);
      db += __shfl_xor_sync(0xffffffffu, db, off);
    }
    if (ra < NR) la = make_float2(lse[row_idx(ra)] * LOG2E, da);
    if (rb < NR) lb = make_float2(lse[row_idx(rb)] * LOG2E, db);
  }
  const bf16* Qw = Qs + rg * 16 * LD;
  const bf16* Ow = Os + rg * 16 * LD;
  const float scale = rsqrtf(static_cast<float>(D));
  const float sl2 = scale * LOG2E;
  const int d0 = half * DC;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // at D 64 the warp's Q / dO A fragments stay in registers for the walk
  constexpr bool HOLD = D == 64;
  uint32_t hq_[HOLD ? D / 16 : 1][4], ho_[HOLD ? D / 16 : 1][4];

  for (int step = 0; step < n_steps; ++step) {
    ptx::cp_wait<ST - 2>();
    __syncthreads();
    if (step + ST - 1 < n_steps) load_kv(step + ST - 1);
    ptx::cp_commit();
    if (HOLD && step == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        ptx::load_a(hq_[kk], Qw + kk * 16, LD, lane);
        ptx::load_a(ho_[kk], Ow + kk * 16, LD, lane);
      }
    }
    const bf16* Kd = ring + (step % ST) * 2 * SL * LD;
    const bf16* Vd = Kd + SL * LD;
    const int kp0 = kbeg + step * SL;
    // the whole slice masked for all 16 rows of the group: nothing to add
    // (both warps of a group agree)
    const bool live = rw < NR && kp0 < kv_len && (!causal || kp0 <= tw1) &&
                      kp0 + SL - 1 > tw0 - window;
    const int kw0 = kp0 + half * KW;         // the keys this warp scores
    float s[NJ][4], dp[NJ][4];
    if (live) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      const bf16* Kh = Kd + half * KW * LD;
      const bf16* Vh = Vd + half * KW * LD;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t aq[4], ao[4];
        if (HOLD) {
#pragma unroll
          for (int e = 0; e < 4; ++e) aq[e] = hq_[kk][e], ao[e] = ho_[kk][e];
        } else {
          ptx::load_a(aq, Qw + kk * 16, LD, lane);
          ptx::load_a(ao, Ow + kk * 16, LD, lane);
        }
#pragma unroll
        for (int j = 0; j < NJ; j += 2) {
          uint32_t bk[4], bv[4];
          ptx::load_b_rows(bk, Kh + j * 8 * LD + kk * 16, LD, lane);
          ptx::mma_bf16(s[j], aq, bk);
          ptx::mma_bf16(s[j + 1], aq, bk + 2);
          ptx::load_b_rows(bv, Vh + j * 8 * LD + kk * 16, LD, lane);
          ptx::mma_bf16(dp[j], ao, bv);
          ptx::mma_bf16(dp[j + 1], ao, bv + 2);
        }
      }
      // dS (into s): element (j, e) is row e < 2 ? ra : rb, key kw0 + 8 j
      // + 2 t + (e & 1); a slice all 16 rows keep whole needs no mask
      const bool full = rw + 16 <= NR && kw0 + KW <= kv_len &&
                        (!causal || kw0 + KW - 1 <= tw0) &&
                        kw0 > tw1 - window;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool upper = e < 2;
          const int kpos = kw0 + j * 8 + 2 * t + (e & 1);
          const bool ok = full || ((upper ? ra : rb) < NR &&
                                   keep(kpos, upper ? qa : qb, kv_len,
                                        causal, window));
          const float2 l = upper ? la : lb;
          const float p = ok ? exp2f(s[j][e] * sl2 - l.x) : 0.f;
          s[j][e] = p * (dp[j][e] - l.y);
        }
    }
    if constexpr (CW == 1) {
      // dQ += bf16(dS) K: K read as the B operand of a [key][d] tile
      if (live) ptx::pv_update<NJ, NT>(s, Kd, LD, lane, NJ / 2, acc);
    } else {
      if (live) store_c<NJ>(dSs + rg * 16 * LDS + half * KW, LDS, s, lane);
      __syncthreads();
      if (live) {
#pragma unroll
        for (int kk = 0; kk < SL / 16; ++kk) {
          uint32_t a[4];
          ptx::load_a(a, dSs + rg * 16 * LDS + kk * 16, LDS, lane);
#pragma unroll
          for (int n = 0; n < NT; n += 2) {
            uint32_t bk[4];
            ptx::load_b_cols(bk, Kd + kk * 16 * LD + d0 + n * 8, LD, lane);
            ptx::mma_bf16(acc[n], a, bk);
            ptx::mma_bf16(acc[n + 1], a, bk + 2);
          }
        }
      }
    }
  }
  ptx::cp_wait<0>();

  if (slot < 0) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = d0 + n * 8 + 2 * t;
      if (ra < NR)
        *reinterpret_cast<uint32_t*>(dq + row_idx(ra) * D + d) =
            ptx::pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
      if (rb < NR)
        *reinterpret_cast<uint32_t*>(dq + row_idx(rb) * D + d) =
            ptx::pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
    }
    return;
  }
  float* pq = part_q + ((size_t(slot) * gridDim.z + b) * Hkv + hk) *
                           QROWS * D;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int d = d0 + n * 8 + 2 * t;
    const int la_ = rg * 16 + g;
    *reinterpret_cast<float2*>(pq + la_ * D + d) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(pq + (la_ + 8) * D + d) =
        make_float2(acc[n][2], acc[n][3]);
  }
}

// Sum a split walk's f32 partials in split order, scale and round to
// bf16.  Grid (tiles * 64 / RROWS, Hkv, B), 128 threads, 4 columns a
// thread: block x takes rows [RROWS x, RROWS x + RROWS) of tile x * RROWS
// / 64; tiles (splits, first slot) from the plan, walks of one split
// skipped.  KV: rows are keys of dK (scaled) and dV; else packed rows of
// dQ (scaled).
constexpr int RROWS = 8;
template <int D, bool KV>
__global__ void __launch_bounds__(128)
split_sum_kernel(const int* __restrict__ tiles, const float* __restrict__ pa,
              const float* __restrict__ pb, bf16* __restrict__ oa,
              bf16* __restrict__ ob, int H, int Hkv, int Sq, int Sk) {
  const int tile = blockIdx.x / (64 / RROWS);
  const int n = tiles[2 * tile], first = tiles[2 * tile + 1];
  if (n < 2) return;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int rep = H / Hkv, NR = rep * Sq;
  const size_t stride = size_t(gridDim.z) * Hkv * 64 * D;   // one slot
  const size_t base = ((size_t(first) * gridDim.z + b) * Hkv + hk) * 64 * D;
  const int i0 = (blockIdx.x % (64 / RROWS)) * RROWS * D;
  const float scale = rsqrtf(static_cast<float>(D));
  for (int i = i0 + threadIdx.x * 4; i < i0 + RROWS * D; i += 128 * 4) {
    const int r = tile * 64 + i / D, d = i % D;
    if (r >= (KV ? Sk : NR)) break;
    float4 sa = make_float4(0.f, 0.f, 0.f, 0.f), sb = sa;
#pragma unroll 4
    for (int s = 0; s < n; ++s) {                 // in split order
      const float4 x =
          *reinterpret_cast<const float4*>(pa + base + s * stride + i);
      sa.x += x.x; sa.y += x.y; sa.z += x.z; sa.w += x.w;
      if (KV) {
        const float4 y =
            *reinterpret_cast<const float4*>(pb + base + s * stride + i);
        sb.x += y.x; sb.y += y.y; sb.z += y.z; sb.w += y.w;
      }
    }
    const size_t o = KV ? ((size_t(b) * Hkv + hk) * Sk + r) * D + d
                        : ((size_t(b) * H + hk * rep + r % rep) * Sq +
                           r / rep) * D + d;
    *reinterpret_cast<uint2*>(oa + o) =
        make_uint2(ptx::pack_bf16(sa.x * scale, sa.y * scale),
                   ptx::pack_bf16(sa.z * scale, sa.w * scale));
    if (KV)
      *reinterpret_cast<uint2*>(ob + o) =
          make_uint2(ptx::pack_bf16(sb.x, sb.y), ptx::pack_bf16(sb.z, sb.w));
  }
}

template <class Kern>
int set_smem(Kern kern, size_t smem) {
  if (smem > size_t(MAX_SMEM)) return int(cudaErrorInvalidValue);
  if (smem > 48 * 1024)
    return int(cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
  return 0;
}

template <int D>
int occupancy(int* out) {
  int err;
  if ((err = set_smem(dkdv_kernel<D>, dkdv_smem(D)))) return err;
  if ((err = set_smem(dq_kernel<D>, dq_smem(D)))) return err;
  if ((err = int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           out, dkdv_kernel<D>, warps(D) * 32, dkdv_smem(D)))))
    return err;
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 1, dq_kernel<D>, warps(D) * 32, dq_smem(D)));
}

// A second stream per device for the dQ pass, which needs only D_i and
// so runs beside dK/dV; forked from and joined back to the caller's
// stream by events, so the call stays ordered on it (and a CUDA graph
// captures both).  One host thread drives a device's backward at a time.
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
};

int side_stream(Side** out) {
  static Side sides[64];
  int dev, err;
  if ((err = int(cudaGetDevice(&dev)))) return err;
  if (dev >= 64) return int(cudaErrorInvalidDevice);
  Side& s = sides[dev];
  if (!s.stream) {
    if ((err = int(cudaStreamCreateWithFlags(&s.stream,
                                             cudaStreamNonBlocking))) ||
        (err = int(cudaEventCreateWithFlags(&s.fork,
                                            cudaEventDisableTiming))) ||
        (err = int(cudaEventCreateWithFlags(&s.join,
                                            cudaEventDisableTiming))))
      return err;
  }
  *out = &s;
  return 0;
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* out,
           const float* lse, const bf16* dout, bf16* dq, bf16* dk, bf16* dv,
           float2* rows, const int* plan, float* part_kv, float* part_q,
           int B, int H, int Hkv, int Sq, int Sk, int seq, int causal,
           int window, int off, int n_kv, int kv_slots, int n_q, int q_slots,
           int dq_first, cudaStream_t stream) {
  const int kv_len = seq < Sk ? seq : Sk;
  const int n_kv_tiles = (Sk + BK - 1) / BK;
  const int n_q_tiles = (H / Hkv * Sq + QROWS - 1) / QROWS;
  const int* kv_items = plan;
  const int* kv_tiles = kv_items + 4 * n_kv;
  const int* q_items = kv_tiles + 2 * n_kv_tiles;
  const int* q_tiles = q_items + 4 * n_q;
  const size_t slot_kv = size_t(B) * Hkv * BK * D;
  float* part_v = part_kv ? part_kv + size_t(kv_slots) * slot_kv : nullptr;

  Side* side;
  int err = side_stream(&side);
  if (err) return err;
  // dq_first: the dQ pass takes the SMs first, its blocks summing their
  // own D_i; else it forks after delta_kernel, reads its D_i, and is
  // launched after dK/dV, filling what dK/dV leaves free
  auto launch_dq = [&](const float2* dq_rows) {
    int e;
    if ((e = int(cudaStreamWaitEvent(side->stream, side->fork, 0))) ||
        (e = set_smem(dq_kernel<D>, dq_smem(D))))
      return e;
    dq_kernel<D><<<dim3(n_q, Hkv, B), warps(D) * 32, dq_smem(D),
                   side->stream>>>(q, k, v, out, dout, lse, dq_rows, q_items,
                                   dq, part_q, H, Hkv, Sq, Sk, kv_len, causal,
                                   window, off);
    return int(cudaGetLastError());
  };
  if (dq_first && ((err = int(cudaEventRecord(side->fork, stream))) ||
                   (err = launch_dq(nullptr))))
    return err;
  const int n_rows = B * H * Sq;
  constexpr int per_block = 256 / row_lanes(D);
  delta_kernel<D><<<(n_rows + per_block - 1) / per_block, 256, 0, stream>>>(
      out, dout, lse, rows, H, Hkv, Sq, n_rows);
  if ((err = int(cudaGetLastError()))) return err;
  if (!dq_first && (err = int(cudaEventRecord(side->fork, stream))))
    return err;
  if ((err = set_smem(dkdv_kernel<D>, dkdv_smem(D)))) return err;
  dkdv_kernel<D><<<dim3(n_kv, Hkv, B), warps(D) * 32, dkdv_smem(D),
                   stream>>>(q, k, v, dout, rows, kv_items, dk, dv, part_kv,
                             part_v, H, Hkv, Sq, Sk, kv_len, causal, window,
                             off);
  if ((err = int(cudaGetLastError()))) return err;
  if (!dq_first && (err = launch_dq(rows))) return err;

  if (kv_slots) {
    split_sum_kernel<D, true>
        <<<dim3(n_kv_tiles * (BK / RROWS), Hkv, B), 128, 0, stream>>>(
        kv_tiles, part_kv, part_v, dk, dv, H, Hkv, Sq, Sk);
    if ((err = int(cudaGetLastError()))) return err;
  }
  if (q_slots) {
    split_sum_kernel<D, false>
        <<<dim3(n_q_tiles * (QROWS / RROWS), Hkv, B), 128, 0,
            side->stream>>>(q_tiles, part_q, nullptr, dq, nullptr, H, Hkv,
                            Sq, Sk);
    if ((err = int(cudaGetLastError()))) return err;
  }
  if ((err = int(cudaEventRecord(side->join, side->stream))))
    return err;
  return int(cudaStreamWaitEvent(stream, side->join, 0));
}

}  // namespace

// q / out / dout / dq (B, H, Sq, D), k / v / dk / dv (B, Hkv, Sk, D), all
// bf16 and contiguous; lse (B, H, Sq) f32 from the forward; rows (B, H,
// Sq) float2 scratch; plan the int32 table of flashprefill.bwd_plan
// (BwdPlan.table: n_kv dK/dV items, the key tiles, n_q dQ items, the row
// tiles); part_kv 2 * kv_slots and part_q q_slots f32 partials of (B,
// Hkv, 64, D) each (null when 0); dq_first as BwdPlan's.  H a multiple
// of Hkv; query row t at position pos_offset + t (>= 0); keys at or past
// seq (<= Sk) masked; window = 1 << 30 for none.  D in {32, 64, 128,
// 256, 288}.  Launches the kernels in order on `stream`; returns the
// first CUDA error (0 on success).
extern "C" int flash_prefill_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* rows, const void* plan, void* part_kv, void* part_q, int B, int H,
    int Hkv, int Sq, int Sk, int D, int seq, int causal, int window,
    int pos_offset, int n_kv, int kv_slots, int n_q, int q_slots,
    int dq_first, void* stream) {
  if (Hkv < 1 || H % Hkv || seq > Sk || seq < 1 || Sq < 1 || Sk < 1 ||
      B < 1 || pos_offset < 0 || n_kv < 1 ||
      n_q < 1 || (kv_slots && !part_kv) || (q_slots && !part_q))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto c = [](const void* p) { return static_cast<const bf16*>(p); };
  auto m = [](void* p) { return static_cast<bf16*>(p); };
  const float* l = static_cast<const float*>(lse);
  float2* r = static_cast<float2*>(rows);
  const int* pl = static_cast<const int*>(plan);
  float* pkv = static_cast<float*>(part_kv);
  float* pq = static_cast<float*>(part_q);
#define FP_BWD_CASE(DIM)                                                    \
  case DIM:                                                                 \
    return launch<DIM>(c(q), c(k), c(v), c(out), l, c(dout), m(dq), m(dk), \
                       m(dv), r, pl, pkv, pq, B, H, Hkv, Sq, Sk, seq,       \
                       causal, window, pos_offset, n_kv, kv_slots, n_q,     \
                       q_slots, dq_first, st);
  switch (D) {
    FP_BWD_CASE(32)
    FP_BWD_CASE(64)
    FP_BWD_CASE(128)
    FP_BWD_CASE(256)
    FP_BWD_CASE(288)
    default:
      return int(cudaErrorInvalidValue);
  }
#undef FP_BWD_CASE
}

// Blocks of the dK/dV and dQ kernels one SM holds at head dim D (out[0],
// out[1]), for the plan; returns a CUDA error.
extern "C" int flash_prefill_bwd_occupancy(int* out, int D) {
  switch (D) {
    case 32: return occupancy<32>(out);
    case 64: return occupancy<64>(out);
    case 128: return occupancy<128>(out);
    case 256: return occupancy<256>(out);
    case 288: return occupancy<288>(out);
    default: return int(cudaErrorInvalidValue);
  }
}
