// Backward pass of flash attention (csrc/flash_prefill.cu): dQ, dK and dV
// of causal, sliding-window or non-causal bf16 attention with
// grouped-query heads, for training.
//
// The reference has no Pallas kernel here: it differentiates its XLA walk
// (jax.vjp of repro/core/attention.py:92 flash_attention).  This kernel
// computes the same gradients from the forward's saved q, k, v, out and
// per-row log-sum-exp, with the forward's masks (kpos < seq, kpos <= qpos
// if causal, kpos > qpos - window; Sq != Sk only without either) and its
// rounding habit (bf16 operands into the tensor cores, f32 sums):
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
// The design is the simple deterministic one, correct before fast:
//   * delta_kernel: one warp per row computes D_i in f32.
//   * dkdv_kernel: key-parallel.  A block owns BK = 64 keys of one KV head
//     (16 a warp) and walks, in steps of BQ = 32 rows, exactly the packed
//     rows that can see one of its keys (from the first key's token on if
//     causal, up to the last key's token + window - 1), so tiles wholly
//     masked are never loaded.  Per step it recomputes S^T = K Q^T and
//     dP^T = V dO^T in registers (mma.sync m16n8k16, bf16 in, f32
//     accumulators), forms P^T and dS^T, and accumulates dV += P^T dO and
//     dK += dS^T Q, the C fragments of P^T / dS^T reused as A fragments.
//     The Q / dO rows stream through a two-stage cp.async ring.  Above D
//     128 the dK / dV accumulators would need D floats a thread, so the
//     output columns are split over D / DV blocks (dv_cols: DV = 128 of
//     D 256, 144 of D 288), which each recompute S^T and dP^T.
//   * dq_kernel: row-parallel, as the forward: a block owns 64 packed rows
//     and walks the key slices that can hold a kept key (warps skip
//     slices masked for all their rows), recomputing S and dP and
//     accumulating dQ += dS K in registers; K / V slices through a
//     two-stage cp.async ring.  At D 288 dQ's 144 floats a thread would
//     not fit beside S and dP: two warps share each 16-row group
//     (dq_warps), both compute the same S, dP and dS (the same bits) and
//     each keeps dQ's columns of its half of D.
// Each output element is written by one thread of one block, in a fixed
// order: no atomics, so the gradients repeat bit for bit.  wgmma and TMA
// are not used.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using ptx::NEG_INF;
constexpr int NO_WINDOW = 1 << 30;   // window operand: no sliding window
constexpr int MAX_SMEM = 232448;     // bytes of shared memory a block may use
constexpr int PAD = 8;               // bf16 padding per shared-memory row
constexpr int WARPS = 4;
constexpr int BK = WARPS * 16;       // keys of a dK/dV block
constexpr int BQ = 32;               // packed rows per step of its walk
constexpr int QROWS = WARPS * 16;    // packed rows of a dQ block

// output columns a dK/dV block accumulates: all of D up to 128, else half
// of it (a multiple of 16, so each warp owns whole k16 column pairs)
__host__ __device__ constexpr int dv_cols(int D) { return D > 128 ? D / 2 : D; }
// warps sharing one 16-row group of the dQ walk, each keeping dQ's columns
// of D / dq_warps
__host__ __device__ constexpr int dq_warps(int D) { return D > 256 ? 2 : 1; }
// keys per step of the dQ walk (the registers hold dQ's D / 2 floats)
__host__ __device__ constexpr int dq_slice(int D) { return D > 128 ? 32 : 64; }

__host__ __device__ constexpr size_t dkdv_smem(int D) {
  return size_t(2 * BK + 2 * 2 * BQ) * (D + PAD) * sizeof(bf16);
}
__host__ __device__ constexpr size_t dq_smem(int D) {
  return size_t(2 * QROWS + 2 * 2 * dq_slice(D)) * (D + PAD) * sizeof(bf16);
}

__device__ __forceinline__ bool keep(int kpos, int qpos, int kv_len,
                                     bool causal, int window) {
  return kpos < kv_len && (!causal || kpos <= qpos) && kpos > qpos - window;
}

// D_i = sum_d dO[i, d] * O[i, d] in f32.  Grid ceil(rows / 8), 8 warps.
template <int D>
__global__ void __launch_bounds__(256)
delta_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
             float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* o = out + size_t(row) * D;
  const bf16* d = dout + size_t(row) * D;
  float s = 0.f;
#pragma unroll
  for (int c = lane * 2; c < D; c += 64) {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + c));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(d + c));
    s += a.x * b.x + a.y * b.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// Grid (ceil(Sk / BK), Hkv * D / DV, B), WARPS warps.  Block (x, y, b)
// owns keys [x BK, x BK + BK) of KV head y / (D / DV) and output columns
// [DV (y % (D / DV)), + DV) of dK and dV.
template <int D>
__global__ void __launch_bounds__(WARPS * 32)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Hkv,
            int Sq, int Sk, int kv_len, int causal, int window) {
  constexpr int LD = D + PAD;
  constexpr int DV = dv_cols(D);
  constexpr int NS = D / DV;         // column splits
  static_assert(D % DV == 0 && DV % 16 == 0,
                "the column splits cover D in whole k16 column pairs");
  constexpr int NJ = BQ / 8;         // n8 tiles of a step's S^T
  constexpr int NT = DV / 8;         // n8 tiles of the accumulated columns
  constexpr int VEC = D / 8;         // 16-byte words per row
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BK * LD;
  bf16* ring = Vs + BK * LD;         // stage i: Q rows, then dO rows

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, hk = blockIdx.y / NS, d0 = (blockIdx.y % NS) * DV;
  const int k0 = blockIdx.x * BK;
  const int rep = H / Hkv;
  const size_t kvhead = (size_t(b) * Hkv + hk) * Sk * D;
  auto row_idx = [&](int r) {
    return (size_t(b) * H + hk * rep + r % rep) * Sq + r / rep;
  };

  // packed rows [r_lo, r_hi) whose token can see a key of [k0, k_last]
  const int k_last = min(k0 + BK, kv_len) - 1;
  const int t_lo = causal ? k0 : 0;
  const int t_hi = window < NO_WINDOW ? min(Sq - 1, k_last + window - 1)
                                      : Sq - 1;
  const int r_lo = t_lo * rep;
  const int r_hi = (k0 < kv_len && t_lo <= t_hi) ? (t_hi + 1) * rep : r_lo;
  const int n_steps = (r_hi - r_lo + BQ - 1) / BQ;

  for (int i = threadIdx.x; i < BK * VEC; i += blockDim.x) {
    const int r = i / VEC, w = i % VEC;
    const bool ok = k0 + r < kv_len;        // past seq: zeros, masked
    const size_t src = kvhead + (ok ? size_t(k0 + r) * D : 0) + w * 8;
    ptx::cp_async16(Ks + r * LD + w * 8, k + src, ok ? 16 : 0);
    ptx::cp_async16(Vs + r * LD + w * 8, v + src, ok ? 16 : 0);
  }
  auto load_rows = [&](int step, int stage) {
    bf16* Qd = ring + stage * 2 * BQ * LD;
    bf16* Od = Qd + BQ * LD;
    const int rr0 = r_lo + step * BQ;
    for (int i = threadIdx.x; i < BQ * VEC; i += blockDim.x) {
      const int r = i / VEC, w = i % VEC;
      const bool ok = rr0 + r < r_hi;
      const size_t src = (ok ? row_idx(rr0 + r) * D : 0) + w * 8;
      ptx::cp_async16(Qd + r * LD + w * 8, q + src, ok ? 16 : 0);
      ptx::cp_async16(Od + r * LD + w * 8, dout + src, ok ? 16 : 0);
    }
  };
  if (n_steps > 0) load_rows(0, 0);
  ptx::cp_commit();                         // K, V and the first rows

  const float scale = rsqrtf(static_cast<float>(D));
  const bf16* Kw = Ks + warp * 16 * LD;
  const bf16* Vw = Vs + warp * 16 * LD;
  const int ka = k0 + warp * 16 + g, kb = ka + 8;   // fragment-row keys
  float adk[NT][4], adv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    ptx::cp_wait<0>();                      // this step's rows have arrived
    __syncthreads();                        // ... for all; other stage free
    if (step + 1 < n_steps) load_rows(step + 1, (step + 1) % 2);
    ptx::cp_commit();
    const bf16* Qd = ring + (step % 2) * 2 * BQ * LD;
    const bf16* Od = Qd + BQ * LD;
    const int rr0 = r_lo + step * BQ;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ rows a warp
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      ptx::load_a(ak, Kw + kk * 16, LD, lane);
      ptx::load_a(av, Vw + kk * 16, LD, lane);
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        uint32_t bq[4], bo[4];
        ptx::load_b_rows(bq, Qd + j * 8 * LD + kk * 16, LD, lane);
        ptx::mma_bf16(s[j], ak, bq);
        ptx::mma_bf16(s[j + 1], ak, bq + 2);
        ptx::load_b_rows(bo, Od + j * 8 * LD + kk * 16, LD, lane);
        ptx::mma_bf16(dp[j], av, bo);
        ptx::mma_bf16(dp[j + 1], av, bo + 2);
      }
    }
    // P^T (into s) and dS^T (into dp); column c of tile j is packed row
    // rr0 + 8 j + 2 t + (e & 1)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int rr = rr0 + j * 8 + 2 * t + c;
        float l = 0.f, dl = 0.f;
        if (rr < r_hi) {
          const size_t ri = row_idx(rr);
          l = lse[ri];
          dl = delta[ri];
        }
        const int tok = rr / rep;
#pragma unroll
        for (int h = 0; h < 2; ++h) {      // fragment rows g, g + 8
          const int e = 2 * h + c;
          const bool ok = rr < r_hi &&
                          keep(h ? kb : ka, tok, kv_len, causal, window);
          const float p = ok ? expf(s[j][e] * scale - l) : 0.f;
          dp[j][e] = p * (dp[j][e] - dl);
          s[j][e] = p;
        }
      }
    // dV += bf16(P^T) dO and dK += bf16(dS^T) Q over the step's rows
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk) {
      const uint32_t ap[4] = {ptx::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
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
        ptx::load_b_cols(bo, Od + kk * 16 * LD + d0 + n * 8, LD, lane);
        ptx::mma_bf16(adv[n], ap, bo);
        ptx::mma_bf16(adv[n + 1], ap, bo + 2);
        ptx::load_b_cols(bq, Qd + kk * 16 * LD + d0 + n * 8, LD, lane);
        ptx::mma_bf16(adk[n], as, bq);
        ptx::mma_bf16(adk[n + 1], as, bq + 2);
      }
    }
  }
  ptx::cp_wait<0>();

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
}

// Grid (ceil(rep * Sq / QROWS), Hkv, B), WARPS * dq_warps(D) warps: each
// 16 packed rows by D / dq_warps(D) columns of dQ.
template <int D>
__global__ void __launch_bounds__(WARPS * 32 * dq_warps(D))
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, int H, int Hkv, int Sq, int Sk, int kv_len,
          int causal, int window) {
  constexpr int LD = D + PAD;
  constexpr int SLICE = dq_slice(D);
  constexpr int NJ = SLICE / 8;
  constexpr int WD = dq_warps(D);
  constexpr int NT = D / 8 / WD;     // n8 tiles of dQ a warp keeps
  constexpr int VEC = D / 8;
  static_assert(D % (16 * WD) == 0, "each warp keeps whole k16 column pairs");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Os = Qs + QROWS * LD;
  bf16* ring = Os + QROWS * LD;      // stage i: K slice, then V slice

  const int warp = threadIdx.x / 32 % WARPS, lane = threadIdx.x % 32;
  const int dcol = WD == 1 ? 0 : threadIdx.x / 32 / WARPS * (D / WD);
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, hk = blockIdx.y, r0 = blockIdx.x * QROWS;
  const int rep = H / Hkv, NR = rep * Sq;
  const size_t kvhead = (size_t(b) * Hkv + hk) * Sk * D;
  auto row_idx = [&](int r) {
    return (size_t(b) * H + hk * rep + r % rep) * Sq + r / rep;
  };

  // key slices that can hold a kept key of tokens [tq0, tq1]
  const int tq0 = r0 / rep, tq1 = (min(r0 + QROWS, NR) - 1) / rep;
  int hi = kv_len;
  if (causal) hi = min(hi, tq1 + 1);
  const int lo = max(0, tq0 - window + 1);
  const int t0 = lo / SLICE, t1 = (hi + SLICE - 1) / SLICE;

  for (int i = threadIdx.x; i < QROWS * VEC; i += blockDim.x) {
    const int r = i / VEC, w = i % VEC;
    const bool ok = r0 + r < NR;
    const size_t src = (ok ? row_idx(r0 + r) * D : 0) + w * 8;
    ptx::cp_async16(Qs + r * LD + w * 8, q + src, ok ? 16 : 0);
    ptx::cp_async16(Os + r * LD + w * 8, dout + src, ok ? 16 : 0);
  }
  auto load_kv = [&](int tile, int stage) {
    bf16* Kd = ring + stage * 2 * SLICE * LD;
    bf16* Vd = Kd + SLICE * LD;
    const int kp0 = tile * SLICE;
    for (int i = threadIdx.x; i < SLICE * VEC; i += blockDim.x) {
      const int r = i / VEC, w = i % VEC;
      const bool ok = kp0 + r < kv_len;
      const size_t src = kvhead + (ok ? size_t(kp0 + r) * D : 0) + w * 8;
      ptx::cp_async16(Kd + r * LD + w * 8, k + src, ok ? 16 : 0);
      ptx::cp_async16(Vd + r * LD + w * 8, v + src, ok ? 16 : 0);
    }
  };
  if (t0 < t1) load_kv(t0, 0);
  ptx::cp_commit();                         // Q, dO and the first slice

  const int rw = r0 + warp * 16;
  const int ra = rw + g, rb = ra + 8;
  const int qa = ra / rep, qb = rb / rep;
  const int tw0 = rw / rep, tw1 = (rw + 15) / rep;
  float la = 0.f, lb = 0.f, da = 0.f, db = 0.f;
  if (ra < NR) { la = lse[row_idx(ra)]; da = delta[row_idx(ra)]; }
  if (rb < NR) { lb = lse[row_idx(rb)]; db = delta[row_idx(rb)]; }
  const bf16* Qw = Qs + warp * 16 * LD;
  const bf16* Ow = Os + warp * 16 * LD;
  const float scale = rsqrtf(static_cast<float>(D));
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int tile = t0; tile < t1; ++tile) {
    const int i = tile - t0;
    ptx::cp_wait<0>();
    __syncthreads();
    if (tile + 1 < t1) load_kv(tile + 1, (i + 1) % 2);
    ptx::cp_commit();
    const bf16* Kd = ring + (i % 2) * 2 * SLICE * LD;
    const bf16* Vd = Kd + SLICE * LD;
    const int kp0 = tile * SLICE;
    // the whole slice masked for all 16 rows of the warp: nothing to add
    if (kp0 >= hi || (causal && kp0 > tw1) ||
        kp0 + SLICE - 1 <= tw0 - window || rw >= NR)
      continue;

    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ao[4];
      ptx::load_a(aq, Qw + kk * 16, LD, lane);
      ptx::load_a(ao, Ow + kk * 16, LD, lane);
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        uint32_t bk[4], bv[4];
        ptx::load_b_rows(bk, Kd + j * 8 * LD + kk * 16, LD, lane);
        ptx::mma_bf16(s[j], aq, bk);
        ptx::mma_bf16(s[j + 1], aq, bk + 2);
        ptx::load_b_rows(bv, Vd + j * 8 * LD + kk * 16, LD, lane);
        ptx::mma_bf16(dp[j], ao, bv);
        ptx::mma_bf16(dp[j + 1], ao, bv + 2);
      }
    }
    // dS (into s): element (j, e) is row e < 2 ? ra : rb, key kp0 + 8 j +
    // 2 t + (e & 1)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool upper = e < 2;
        const int kpos = kp0 + j * 8 + 2 * t + (e & 1);
        const bool ok = (upper ? ra : rb) < NR &&
                        keep(kpos, upper ? qa : qb, kv_len, causal, window);
        const float p = ok ? expf(s[j][e] * scale - (upper ? la : lb)) : 0.f;
        s[j][e] = p * (dp[j][e] - (upper ? da : db));
      }
    // dQ += bf16(dS) K: K read as the B operand of a [key][d] tile
    ptx::pv_update<NJ, NT>(s, Kd + dcol, LD, lane, NJ / 2, acc);
  }
  ptx::cp_wait<0>();

#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int d = dcol + n * 8 + 2 * t;
    if (ra < NR)
      *reinterpret_cast<uint32_t*>(dq + row_idx(ra) * D + d) =
          ptx::pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
    if (rb < NR)
      *reinterpret_cast<uint32_t*>(dq + row_idx(rb) * D + d) =
          ptx::pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
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
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* out,
           const float* lse, const bf16* dout, bf16* dq, bf16* dk, bf16* dv,
           float* delta, int B, int H, int Hkv, int Sq, int Sk, int seq,
           int causal, int window, cudaStream_t stream) {
  const int kv_len = seq < Sk ? seq : Sk;
  const int rows = B * H * Sq;
  delta_kernel<D><<<(rows + 7) / 8, 256, 0, stream>>>(out, dout, delta, rows);
  int err = int(cudaGetLastError());
  if (err) return err;

  const size_t s1 = dkdv_smem(D);
  if ((err = set_smem(dkdv_kernel<D>, s1))) return err;
  dim3 g1((Sk + BK - 1) / BK, Hkv * (D / dv_cols(D)), B);
  dkdv_kernel<D><<<g1, WARPS * 32, s1, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, H, Hkv, Sq, Sk, kv_len, causal,
      window);
  if ((err = int(cudaGetLastError()))) return err;

  const size_t s2 = dq_smem(D);
  if ((err = set_smem(dq_kernel<D>, s2))) return err;
  dim3 g2((H / Hkv * Sq + QROWS - 1) / QROWS, Hkv, B);
  dq_kernel<D><<<g2, WARPS * 32 * dq_warps(D), s2, stream>>>(
      q, k, v, dout, lse, delta, dq, H, Hkv, Sq, Sk, kv_len, causal, window);
  return int(cudaGetLastError());
}

}  // namespace

// q / out / dout / dq (B, H, Sq, D), k / v / dk / dv (B, Hkv, Sk, D), all
// bf16 and contiguous; lse (B, H, Sq) f32 from the forward; delta (B, H,
// Sq) f32 scratch.  H a multiple of Hkv; Sq == Sk unless causal = 0 and
// window = NO_WINDOW; keys at or past seq (<= Sk) masked; window = 1 <<
// 30 for none.  D in {32, 64, 128, 256, 288}.  Launches the three kernels in
// order on `stream`; returns the first CUDA error (0 on success).
extern "C" int flash_prefill_bwd(const void* q, const void* k, const void* v,
                                 const void* out, const void* lse,
                                 const void* dout, void* dq, void* dk,
                                 void* dv, void* delta, int B, int H,
                                 int Hkv, int Sq, int Sk, int D, int seq,
                                 int causal, int window, void* stream) {
  if (Hkv < 1 || H % Hkv || seq > Sk || seq < 1 || Sq < 1 || Sk < 1 ||
      B < 1 || (Sq != Sk && (causal || window < NO_WINDOW)))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto c = [](const void* p) { return static_cast<const bf16*>(p); };
  auto m = [](void* p) { return static_cast<bf16*>(p); };
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
#define FP_BWD_CASE(DIM)                                                    \
  case DIM:                                                                 \
    return launch<DIM>(c(q), c(k), c(v), c(out), l, c(dout), m(dq), m(dk), \
                       m(dv), dl, B, H, Hkv, Sq, Sk, seq, causal, window,   \
                       st);
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
