// Flash attention for one-shot prefill: causal, sliding-window or
// non-causal, bf16 Q/K/V, grouped-query heads.
//
// Replaces repro/kernels/flashprefill.py:82 flash_prefill (kernel body
// _flash_kernel, :33), whose contract and numerics it keeps:
//   * q (B, H, S, D), k/v (B, Hkv, S, D) bf16; head h reads KV head
//     h / rep (:111);
//   * a key is kept when kpos < seq, kpos <= qpos if causal and
//     kpos > qpos - window (:56-61; window = NO_WINDOW turns it off);
//   * scores are bf16 x bf16 products summed in f32, times rsqrt(D) (:53);
//     masked scores are NEG_INF = -1e30 and p is zeroed under the mask,
//     so a fully masked key slice leaves (m, l, acc) exactly unchanged;
//   * the online softmax keeps f32 m and l; l sums the unrounded p, p is
//     rounded to bf16 before the PV product (:70);
//   * out = bf16(acc / max(l, 1e-20)) (:75).
// It is not a block-for-block copy: the TPU kernel's 512 x 512 tiles do
// not fit in a block's 227 KB of shared memory at D 256, and its grid
// walks every KV block of a row in order.  Any S works: rows past S are
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
//     64 at D 256) masked for all its rows, and a slice kept whole for
//     them skips the per-score mask.  The wrapper picks the tile from the
//     shapes.
//   * An asynchronous K/V ring: two tiles in shared memory, filled by
//     cp.async 16-byte copies; the copies of tile i + 1 are in flight
//     while tile i is multiplied.
//   * Fragments by ldmatrix: Q and K with ldmatrix.x4, V with
//     ldmatrix.x4.trans; Q's fragments stay in registers across the walk
//     at D <= 128 (at D 256 they would cost 64 more registers a thread
//     beside the 128 of the output) and are reloaded from shared memory
//     per slice at D 256.  Rows are padded by 16 bytes, so the eight rows
//     of each 8 x 8 matrix fall in distinct banks.
//   * Tensor cores: mma.sync m16n8k16 bf16 with f32 accumulators — S = Q
//     K^T for a slice in registers (the C fragments are reused as
//     the A fragments of P), the softmax reduced across the four lanes of
//     a row quad, O accumulated in registers (D / 2 floats a thread).
//     wgmma is not used; PERF.md records what was measured without it.
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

constexpr int MAX_WARPS = 8;       // block_q <= 128

// keys per online-softmax update: 128 (16 n8 score tiles a warp, 64
// floats a thread) where the registers allow, 64 at D 256
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

// Grid (ceil(rep * S / bq), Hkv, B), block bq / 16 warps.
template <int D>
__global__ void __launch_bounds__(MAX_WARPS * 32)
flash_prefill_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     int H, int Hkv, int S, int seq, int causal, int window,
                     int bk) {
  constexpr int LD = D + PAD;
  constexpr int NT = D / 8;          // n8 tiles of the output row
  constexpr int SLICE = slice_keys(D);
  constexpr int NJ = SLICE / 8;      // n8 tiles of a slice's scores
  constexpr int ST = STAGES;
  constexpr bool QREG = D <= 128;    // Q fragments held in registers
  constexpr int VEC = D / 8;         // 16-byte words per row
  extern __shared__ __align__(16) unsigned char smem[];
  const int bq = blockDim.x / 32 * 16;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = Qs + bq * LD;         // stage i: K rows, then V rows

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, hk = blockIdx.y, r0 = blockIdx.x * bq;
  const int rep = H / Hkv, NR = rep * S;
  const int kv_len = min(seq, S);
  const size_t kvhead = (size_t(b) * Hkv + hk) * S * D;
  // row r of KV head hk -> offset of its q / out row
  auto row_off = [&](int r) {
    return ((size_t(b) * H + hk * rep + r % rep) * S + r / rep) * D;
  };

  // KV tiles that can hold a kept key of tokens [tq0, tq1]
  const int tq0 = r0 / rep, tq1 = (min(r0 + bq, NR) - 1) / rep;
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

  const int rw = r0 + warp * 16;           // this warp's first row
  const int qa = (rw + g) / rep, qb = (rw + g + 8) / rep;   // row tokens
  const int tw0 = rw / rep, tw1 = (rw + 15) / rep;
  const bf16* Qw = Qs + warp * 16 * LD;
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
      ptx::pv_update<NJ, NT>(s, Vd + ks0 * LD, LD, lane, NJ / 2, acc);
    }
  }
  ptx::cp_wait<0>();

  // out = bf16(acc / max(l, 1e-20)); l is quad-reduced already
  const float inv[2] = {1.f / fmaxf(l[0], 1e-20f), 1.f / fmaxf(l[1], 1e-20f)};
  const int ra = rw + g, rb = ra + 8;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int d = n * 8 + 2 * t;
    if (ra < NR)
      *reinterpret_cast<uint32_t*>(out + row_off(ra) + d) =
          ptx::pack_bf16(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    if (rb < NR)
      *reinterpret_cast<uint32_t*>(out + row_off(rb) + d) =
          ptx::pack_bf16(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Hkv, int S, int seq, int causal, int window, int bq,
           int bk, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, bq, bk);
  if (smem > size_t(MAX_SMEM)) return ERR_SMEM;
  auto kern = flash_prefill_kernel<D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  const int rows = H / Hkv * S;              // token-major rows a KV head
  dim3 grid((rows + bq - 1) / bq, Hkv, B);
  kern<<<grid, bq * 2, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), H, Hkv, S, seq, causal, window, bk);
  return int(cudaGetLastError());
}

}  // namespace

// q (B, H, S, D), k/v (B, Hkv, S, D), out (B, H, S, D), all bf16 and
// contiguous; H a multiple of Hkv; keys at or past seq (<= S) masked;
// window = 1 << 30 for none.  bq: token-major rows (t * rep + g) per
// block, a multiple of 16 up to 128; bk: keys per tile of the ring, a
// multiple of the slice (128 keys, 64 at D 256).  D in {32, 64,
// 128, 256}.  Returns the CUDA error of the launch (0 on success), or
// ERR_SMEM when the (bq, bk) tile does not fit in shared memory.
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             void* out, int B, int H, int Hkv, int S, int D,
                             int seq, int causal, int window, int bq, int bk,
                             void* stream) {
  if (bq < 16 || bq > MAX_WARPS * 16 || bq % 16 || bk < 1 ||
      bk % slice_keys(D) || Hkv < 1 || H % Hkv || seq > S || S < 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(q, k, v, out, B, H, Hkv, S, seq, causal, window, bq,
                        bk, st);
    case 64:
      return launch<64>(q, k, v, out, B, H, Hkv, S, seq, causal, window, bq,
                        bk, st);
    case 128:
      return launch<128>(q, k, v, out, B, H, Hkv, S, seq, causal, window, bq,
                         bk, st);
    case 256:
      return launch<256>(q, k, v, out, B, H, Hkv, S, seq, causal, window, bq,
                         bk, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}
