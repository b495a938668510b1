// Flash attention for one-shot prefill and the training forward: causal,
// sliding-window or non-causal, bf16 Q/K/V, grouped-query heads.
//
// Replaces repro/kernels/flashprefill.py:82 flash_prefill (kernel body
// _flash_kernel, :33), whose contract and numerics it keeps:
//   * q (B, H, Sq, D), k/v (B, Hkv, Sk, D) bf16; head h reads KV head
//     h / rep (:111); query row t sits at position qpos = pos_offset + t
//     (repro/core/attention.py:140: a rank's rows of sequence-parallel
//     prefill; 0 on the serve and training paths);
//   * a key is kept when kpos < seq, kpos <= qpos if causal and
//     kpos > qpos - window (:56-61; window = NO_WINDOW turns it off);
//   * scores are bf16 x bf16 products summed in f32, times rsqrt(D) (:53);
//     masked scores are NEG_INF = -1e30 and p is zeroed under the mask,
//     so a fully masked key slice leaves (m, l, acc) exactly unchanged;
//   * the online softmax keeps f32 m and l; l sums the unrounded p, p is
//     rounded to bf16 before the PV product (:70);
//   * out = bf16(acc / max(l, 1e-20)) (:75); for training, optionally
//     each row's f32 log-sum-exp m + log(l) (NEG_INF for a row with no
//     kept key), from which csrc/flash_prefill_bwd.cu recomputes p.
// It is not a block-for-block copy: the TPU kernel's 512 x 512 tiles do
// not fit in a block's 227 KB of shared memory at D 256, and its grid
// walks every KV block of a row in order.  Any S works: rows past Sq are
// neither loaded nor stored, keys past seq are copied as zeros (cp.async
// with a source size of 0) and masked, so the caller passes no padded copy.
//
// What bounds it on an H100: operations at long S (4 * D flops per kept
// (query, key) pair against 2 * D bytes per key read once), bytes at the
// short serve prompts — and below both, keeping the tensor cores fed.
// The design:
//   * Rows packed across the query heads of one KV head.  A block owns
//     block_q consecutive rows r = t * rep + g of KV head h (token t,
//     query head h * rep + g), so each K/V tile it loads serves all rep
//     heads (recurrentgemma: 10 heads on one KV head).  A warp owns 16
//     rows.  The block loops over the block_k-key tiles that can hold a
//     kept key of its rows: tiles wholly above the diagonal (causal) or
//     before the window are never loaded, a warp skips a slice (128 keys,
//     64 above D 128) masked for all its rows, and a slice kept whole for
//     them skips the per-score mask.  The wrapper picks the tile from the
//     shapes.
//   * An asynchronous K/V ring: two tiles in shared memory, filled by
//     cp.async 16-byte copies; the copies of tile i + 1 are in flight
//     while tile i is multiplied.
//   * Fragments by ldmatrix: Q and K with ldmatrix.x4, V with
//     ldmatrix.x4.trans; Q's fragments stay in registers across the walk
//     at D <= 128 (at D 256 they would cost 64 more registers a thread
//     beside the 128 of the output) and are reloaded from shared memory
//     per slice above D 128.  Rows are padded by 16 bytes, so the eight rows
//     of each 8 x 8 matrix fall in distinct banks.
//   * Tensor cores: mma.sync m16n8k16 bf16 with f32 accumulators — S = Q
//     K^T for a slice in registers (the C fragments are reused as
//     the A fragments of P), the softmax reduced across the four lanes of
//     a row quad, O accumulated in registers (D / 2 floats a thread, D / 4
//     at D 288).  wgmma is not used; PERF.md records what was measured
//     without it.
//   * Wide heads (D > 256, gemma3's 288).  A warp's whole output row
//     would take 144 floats a thread, 176 with the 64-key score slice,
//     before fragments and addresses, of the 255 registers a thread may
//     hold (D 256's 160 already leave little): two warps share each 16-row
//     group (d_warps, as csrc/flash_block.cuh does for decode), both
//     compute the same S and softmax (same instructions on the same
//     operands: the same bits) and each keeps the output of its half of
//     D.  The block keeps at most 256 threads, so its row tile is at most
//     64 rows there (max_rows).
//
// A tile that needs more than the 227 KB of shared memory a block may use
// is refused with ERR_SMEM (the wrapper raises), never split.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using ptx::NEG_INF;
constexpr int MAX_SMEM = 232448;   // bytes of shared memory a block may use
constexpr int ERR_SMEM = -1;       // launch refused: the tile needs more
constexpr int STAGES = 2;          // K/V tiles in the ring
constexpr int PAD = 8;             // bf16 padding per shared-memory row

constexpr int MAX_WARPS = 8;       // threads per block <= 256

// warps sharing one 16-row group, each keeping the output of D / d_warps
// columns, and the largest row tile (block_q) of a block
__host__ __device__ constexpr int d_warps(int D) { return D > 256 ? 2 : 1; }
__host__ __device__ constexpr int max_rows(int D) {
  return MAX_WARPS / d_warps(D) * 16;
}

// keys per online-softmax update: 128 (16 n8 score tiles a warp, 64
// floats a thread) where the registers allow, 64 above D 128
__host__ __device__ constexpr int slice_keys(int D) {
  return D > 128 ? 64 : 128;
}

__host__ __device__ constexpr size_t smem_bytes(int D, int bq, int bk) {
  return size_t(bq + 2 * STAGES * bk) * (D + PAD) * sizeof(bf16);
}

__device__ __forceinline__ bool keep(int kpos, int qpos, int seq, bool causal,
                                     int window) {
  return kpos < seq && (!causal || kpos <= qpos) && kpos > qpos - window;
}

// Grid (ceil(rep * Sq / bq), Hkv, B), block bq / 16 * d_warps(D) warps.
template <int D>
__global__ void __launch_bounds__(MAX_WARPS * 32)
flash_prefill_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int H, int Hkv, int Sq, int Sk,
                     int seq, int causal, int window, int off, int bk) {
  constexpr int LD = D + PAD;
  constexpr int WD = d_warps(D);     // warps per 16-row group
  constexpr int NT = D / 8 / WD;     // n8 tiles of the output a warp keeps
  constexpr int SLICE = slice_keys(D);
  constexpr int NJ = SLICE / 8;      // n8 tiles of a slice's scores
  constexpr int ST = STAGES;
  constexpr bool QREG = D <= 128;    // Q fragments held in registers
  constexpr int VEC = D / 8;         // 16-byte words per row
  static_assert(D % (16 * WD) == 0, "each warp keeps whole k16 column pairs");
  extern __shared__ __align__(16) unsigned char smem[];
  const int groups = blockDim.x / 32 / WD;   // 16-row groups of the block
  const int bq = groups * 16;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = Qs + bq * LD;         // stage i: K rows, then V rows

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the warp's 16-row group and its part of D (columns dcol, + D / WD)
  const int wgrp = WD == 1 ? warp : warp % groups;
  const int dcol = WD == 1 ? 0 : warp / groups * (D / WD);
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, hk = blockIdx.y, r0 = blockIdx.x * bq;
  const int rep = H / Hkv, NR = rep * Sq;
  const int kv_len = min(seq, Sk);
  const size_t kvhead = (size_t(b) * Hkv + hk) * Sk * D;
  // row r of KV head hk -> its (b, h, t) index: times D, its q / out row
  auto row_idx = [&](int r) {
    return (size_t(b) * H + hk * rep + r % rep) * Sq + r / rep;
  };
  auto row_off = [&](int r) { return row_idx(r) * D; };

  // KV tiles that can hold a kept key of positions [tq0, tq1]
  const int tq0 = off + r0 / rep, tq1 = off + (min(r0 + bq, NR) - 1) / rep;
  int hi = kv_len;
  if (causal) hi = min(hi, tq1 + 1);
  const int lo = max(0, tq0 - window + 1);
  const int t0 = lo / bk, t1 = (hi + bk - 1) / bk;

  for (int i = threadIdx.x; i < bq * VEC; i += blockDim.x) {
    const int r = i / VEC, w = i % VEC;
    const bool ok = r0 + r < NR;
    ptx::cp_async16(Qs + r * LD + w * 8, q + (ok ? row_off(r0 + r) : 0) + w * 8,
                    ok ? 16 : 0);
  }
  ptx::cp_commit();
  auto load_kv = [&](int tile, int stage) {
    bf16* Kd = ring + stage * 2 * bk * LD;
    bf16* Vd = Kd + bk * LD;
    const int k0 = tile * bk;
    for (int i = threadIdx.x; i < bk * VEC; i += blockDim.x) {
      const int r = i / VEC, w = i % VEC;
      const bool ok = k0 + r < kv_len;     // past seq: zeros, masked
      const size_t src = kvhead + (ok ? size_t(k0 + r) * D : 0) + w * 8;
      ptx::cp_async16(Kd + r * LD + w * 8, k + src, ok ? 16 : 0);
      ptx::cp_async16(Vd + r * LD + w * 8, v + src, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (t0 + i < t1) load_kv(t0 + i, i);
    ptx::cp_commit();
  }
  ptx::cp_wait<ST - 1>();                  // Q has arrived
  __syncthreads();

  const int rw = r0 + wgrp * 16;           // this warp's first row
  // the positions of the warp's fragment rows and of its first and last row
  const int qa = off + (rw + g) / rep, qb = off + (rw + g + 8) / rep;
  const int tw0 = off + rw / rep, tw1 = off + (rw + 15) / rep;
  const bf16* Qw = Qs + wgrp * 16 * LD;
  const float inv_sqrt_d = rsqrtf(static_cast<float>(D));
  uint32_t qf[QREG ? D / 16 : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ptx::load_a(qf[kk], Qw + kk * 16, LD, lane);
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int tile = t0; tile < t1; ++tile) {
    const int i = tile - t0;
    ptx::cp_wait<ST - 2>();                // tile has arrived
    __syncthreads();                       // ... for all; stage i - 1 free
    if (tile + ST - 1 < t1) load_kv(tile + ST - 1, (i + ST - 1) % ST);
    ptx::cp_commit();
    const bf16* Kd = ring + (i % ST) * 2 * bk * LD;
    const bf16* Vd = Kd + bk * LD;
    const int k0 = tile * bk;

    for (int ks0 = 0; ks0 < bk; ks0 += SLICE) {
      const int kp0 = k0 + ks0;            // first key of the slice
      // the whole slice masked for all 16 rows of the warp: exact no-op
      if (kp0 >= hi || (causal && kp0 > tw1) ||
          kp0 + SLICE - 1 <= tw0 - window)
        continue;

      // every key of the slice kept for all 16 rows: no per-score mask
      const bool full = kp0 + SLICE <= kv_len &&
                        (!causal || kp0 + SLICE - 1 <= tw0) &&
                        kp0 > tw1 - window;
      float s[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        if constexpr (QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
        } else {
          ptx::load_a(a, Qw + kk * 16, LD, lane);
        }
#pragma unroll
        for (int j = 0; j < NJ; j += 2) {
          uint32_t bf[4];
          ptx::load_b_rows(bf, Kd + (ks0 + j * 8) * LD + kk * 16, LD, lane);
          ptx::mma_bf16(s[j], a, bf);
          ptx::mma_bf16(s[j + 1], a, bf + 2);
        }
      }
      if (full)
        ptx::softmax_update<NJ, NT>(
            s, inv_sqrt_d, [](int, int) { return true; }, m, l, acc);
      else
        ptx::softmax_update<NJ, NT>(
            s, inv_sqrt_d,
            [&](int j, int e) {
              return keep(kp0 + j * 8 + 2 * t + (e & 1), e < 2 ? qa : qb,
                          seq, causal, window);
            },
            m, l, acc);
      ptx::pv_update<NJ, NT>(s, Vd + ks0 * LD + dcol, LD, lane, NJ / 2,
                             acc);
    }
  }
  ptx::cp_wait<0>();

  // out = bf16(acc / max(l, 1e-20)); m and l are quad-reduced already
  const float inv[2] = {1.f / fmaxf(l[0], 1e-20f), 1.f / fmaxf(l[1], 1e-20f)};
  const int ra = rw + g, rb = ra + 8;
  if (lse != nullptr && t == 0 && dcol == 0) {
    if (ra < NR) lse[row_idx(ra)] = l[0] > 0.f ? m[0] + logf(l[0]) : NEG_INF;
    if (rb < NR) lse[row_idx(rb)] = l[1] > 0.f ? m[1] + logf(l[1]) : NEG_INF;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int d = dcol + n * 8 + 2 * t;
    if (ra < NR)
      *reinterpret_cast<uint32_t*>(out + row_off(ra) + d) =
          ptx::pack_bf16(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    if (rb < NR)
      *reinterpret_cast<uint32_t*>(out + row_off(rb) + d) =
          ptx::pack_bf16(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int H, int Hkv, int Sq, int Sk, int seq, int causal,
           int window, int off, int bq, int bk, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, bq, bk);
  if (smem > size_t(MAX_SMEM)) return ERR_SMEM;
  auto kern = flash_prefill_kernel<D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  const int rows = H / Hkv * Sq;             // token-major rows a KV head
  dim3 grid((rows + bq - 1) / bq, Hkv, B);
  kern<<<grid, bq * 2 * d_warps(D), smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), lse, H, Hkv, Sq, Sk, seq, causal,
      window, off, bk);
  return int(cudaGetLastError());
}

}  // namespace

// q (B, H, Sq, D), k/v (B, Hkv, Sk, D), out (B, H, Sq, D), all bf16 and
// contiguous; H a multiple of Hkv; query row t at position pos_offset + t
// (>= 0); keys at or past seq (<= Sk) masked; window = 1 << 30 for
// none.  lse: (B, H, Sq) f32 log-sum-exp of each row, or null (the serve
// path: nothing written, out unchanged).  bq: token-major rows (t * rep +
// g) per block, a multiple of 16 up to max_rows(D) (128; 64 at D 288);
// bk: keys per tile of the ring, a multiple of the slice (128 keys, 64
// above D 128).  D in {32, 64, 128, 256, 288}.  Returns the CUDA error of
// the launch (0 on success), or ERR_SMEM when the (bq, bk) tile does not
// fit in shared memory.
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             void* out, void* lse, int B, int H, int Hkv,
                             int Sq, int Sk, int D, int seq, int causal,
                             int window, int pos_offset, int bq, int bk,
                             void* stream) {
  if (bq < 16 || bq > max_rows(D) || bq % 16 || bk < 1 ||
      bk % slice_keys(D) || Hkv < 1 || H % Hkv || seq > Sk || Sq < 1 ||
      Sk < 1 || pos_offset < 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 32:
      return launch<32>(q, k, v, out, l, B, H, Hkv, Sq, Sk, seq, causal,
                        window, pos_offset, bq, bk, st);
    case 64:
      return launch<64>(q, k, v, out, l, B, H, Hkv, Sq, Sk, seq, causal,
                        window, pos_offset, bq, bk, st);
    case 128:
      return launch<128>(q, k, v, out, l, B, H, Hkv, Sq, Sk, seq, causal,
                         window, pos_offset, bq, bk, st);
    case 256:
      return launch<256>(q, k, v, out, l, B, H, Hkv, Sq, Sk, seq, causal,
                         window, pos_offset, bq, bk, st);
    case 288:
      return launch<288>(q, k, v, out, l, B, H, Hkv, Sq, Sk, seq, causal,
                         window, pos_offset, bq, bk, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}
