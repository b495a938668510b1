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
// walks every KV block of a row in order.  Here one block of
// block_q / 16 warps owns block_q query rows of one (b, h) and loops over
// the KV tiles that can hold a kept key: tiles wholly above the diagonal
// (causal) or wholly before the window are never loaded.  Any S works:
// rows past S are neither loaded nor stored, keys past seq are staged as
// zeros and masked, so the caller passes no padded copy.
//
// What bounds it on an H100: operations at long S (4 * D flops per kept
// (query, key) pair against 2 * D bytes per key read once), bytes at the
// short serve prompts.  The design is the simple correct one, as the port
// takes its kernels: mma.sync m16n8k16 bf16 with f32 accumulators, each
// warp owning 16 query rows — S = Q K^T for a 64-key slice in registers
// (the C fragments are reused as the A fragments of P), the softmax
// reduced across the four lanes of a row quad, O accumulated in registers
// (D / 2 floats a thread).  Q and one block_k-key K/V tile sit in shared
// memory, rows padded by 16 bytes so the fragment loads hit 32 distinct
// banks; the tile is staged with 16-byte loads, not pipelined.  wgmma,
// TMA and a cp.async ring are later work.
//
// A tile that needs more than the 227 KB of shared memory a block may use
// is refused with ERR_SMEM (the wrapper raises), never split.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_SMEM = 232448;   // bytes of shared memory a block may use
constexpr int ERR_SMEM = -1;       // launch refused: the tile needs more
constexpr int MAX_WARPS = 8;       // block_q <= 128
constexpr int SLICE = 64;          // keys per online-softmax update
constexpr int PAD = 8;             // bf16 padding per shared-memory row

__host__ __device__ constexpr size_t smem_bytes(int D, int bq, int bk) {
  return size_t(bq + 2 * bk) * (D + PAD) * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Rows [row0, row0 + rows) of a (S, D) head into shared memory (row stride
// D + PAD); rows at or past `valid` are written as zeros.
template <int D>
__device__ __forceinline__ void stage(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, int row0,
                                      int rows, int valid) {
  constexpr int VEC = D / 8;         // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * VEC; i += blockDim.x) {
    const int r = i / VEC, c = i % VEC;
    int4 val = make_int4(0, 0, 0, 0);
    if (row0 + r < valid)
      val = *reinterpret_cast<const int4*>(src + size_t(row0 + r) * D + c * 8);
    *reinterpret_cast<int4*>(dst + r * (D + PAD) + c * 8) = val;
  }
}

__device__ __forceinline__ bool keep(int kpos, int qpos, int seq, bool causal,
                                     int window) {
  return kpos < seq && (!causal || kpos <= qpos) && kpos > qpos - window;
}

// Grid (ceil(S / bq), H, B), block bq / 16 warps.
template <int D>
__global__ void __launch_bounds__(MAX_WARPS * 32)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, int H, int Hkv, int S,
                     int seq, int causal, int window, int bk) {
  constexpr int LD = D + PAD;
  constexpr int NT = D / 8;          // n8 tiles of the output row
  extern __shared__ __align__(16) unsigned char smem[];
  const int bq = blockDim.x / 32 * 16;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + bq * LD;
  __nv_bfloat16* Vs = Ks + bk * LD;
  const unsigned short* Vu = reinterpret_cast<const unsigned short*>(Vs);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * bq;
  const int rep = H / Hkv;
  const size_t qhead = (size_t(b) * H + h) * S * D;
  const size_t kvhead = (size_t(b) * Hkv + h / rep) * S * D;
  const int rw = q0 + warp * 16;             // this warp's first row
  const int qa = rw + g, qb = rw + g + 8;    // this thread's two rows
  const float inv_sqrt_d = rsqrtf(static_cast<float>(D));

  stage<D>(Qs, q + qhead, q0, bq, S);

  // KV tiles that can hold a kept key of rows [q0, q0 + bq)
  int hi = min(seq, S);
  if (causal) hi = min(hi, q0 + bq);
  const int lo = max(0, q0 - window + 1);
  const int t0 = lo / bk, t1 = (hi + bk - 1) / bk;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int tile = t0; tile < t1; ++tile) {
    const int k0 = tile * bk;
    __syncthreads();                         // previous tile consumed
    stage<D>(Ks, k + kvhead, k0, bk, min(seq, S));
    stage<D>(Vs, v + kvhead, k0, bk, min(seq, S));
    __syncthreads();

    for (int ks0 = 0; ks0 < bk; ks0 += SLICE) {
      const int kp0 = k0 + ks0;              // first key of the slice
      // the whole slice masked for all 16 rows of the warp: exact no-op
      if (kp0 >= hi || (causal && kp0 > rw + 15) ||
          kp0 + SLICE - 1 <= rw - window)
        continue;

      float s[SLICE / 8][4];
#pragma unroll
      for (int j = 0; j < SLICE / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* qr = Qs + (warp * 16 + g) * LD + kk * 16 + 2 * t;
        const uint32_t a[4] = {ld32(qr), ld32(qr + 8 * LD), ld32(qr + 8),
                               ld32(qr + 8 * LD + 8)};
#pragma unroll
        for (int j = 0; j < SLICE / 8; ++j) {
          const __nv_bfloat16* kr = Ks + (ks0 + j * 8 + g) * LD + kk * 16 +
                                    2 * t;
          const uint32_t bf[2] = {ld32(kr), ld32(kr + 8)};
          mma_bf16(s[j], a, bf);
        }
      }

      // scale, mask, row max (rows qa: s[.][0..1], qb: s[.][2..3])
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < SLICE / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kpos = kp0 + j * 8 + 2 * t + (i & 1);
          const int qpos = i < 2 ? qa : qb;
          s[j][i] = keep(kpos, qpos, seq, causal, window)
                        ? s[j][i] * inv_sqrt_d : NEG_INF;
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
      for (int j = 0; j < SLICE / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kpos = kp0 + j * 8 + 2 * t + (i & 1);
          const int qpos = i < 2 ? qa : qb;
          const float p = keep(kpos, qpos, seq, causal, window)
                              ? expf(s[j][i] - mx[i >> 1]) : 0.f;
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

      // acc += bf16(P) V: the C fragments of two n8 score tiles are the A
      // fragment of one k16 step
#pragma unroll
      for (int kk = 0; kk < SLICE / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const int key = ks0 + kk * 16 + 2 * t;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int d = n * 8 + g;
          const uint32_t bf[2] = {
              uint32_t(Vu[key * LD + d]) |
                  uint32_t(Vu[(key + 1) * LD + d]) << 16,
              uint32_t(Vu[(key + 8) * LD + d]) |
                  uint32_t(Vu[(key + 9) * LD + d]) << 16};
          mma_bf16(acc[n], a, bf);
        }
      }
    }
  }

  // out = bf16(acc / max(l, 1e-20)); rows quad-reduced l already
  const float inv[2] = {1.f / fmaxf(l[0], 1e-20f), 1.f / fmaxf(l[1], 1e-20f)};
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int d = n * 8 + 2 * t;
    if (qa < S)
      *reinterpret_cast<uint32_t*>(out + qhead + size_t(qa) * D + d) =
          pack_bf16(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    if (qb < S)
      *reinterpret_cast<uint32_t*>(out + qhead + size_t(qb) * D + d) =
          pack_bf16(acc[n][2] * inv[1], acc[n][3] * inv[1]);
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
  dim3 grid((S + bq - 1) / bq, H, B);
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
// window = 1 << 30 for none.  bq: query rows per block, a multiple of 16
// up to 128; bk: keys per staged tile, a multiple of 64.  D in {32, 64,
// 128, 256}.  Returns the CUDA error of the launch (0 on success), or
// ERR_SMEM when the (bq, bk) tile does not fit in shared memory.
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             void* out, int B, int H, int Hkv, int S, int D,
                             int seq, int causal, int window, int bq, int bk,
                             void* stream) {
  if (bq < 16 || bq > MAX_WARPS * 16 || bq % 16 || bk < SLICE ||
      bk % SLICE || Hkv < 1 || H % Hkv || seq > S || S < 1)
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
