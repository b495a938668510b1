// W4A16 / W8A16 mixed-precision GEMM over tile-major packed weights.
//
// Replaces repro/kernels/mpgemm.py:137 mpgemm_2d (kernel body
// _mpgemm_kernel :45, nibble unpack _unpack_nibbles_tile :34), bits 4 and
// 8: y (M, N) bf16 = x (M, K) bf16 @ W, W stored as (K/bk, N/bn, bk_store,
// bn) int8 tiles — bits 4: bk_store = bk/2, two nibbles per byte along K,
// low nibble = even k; bits 8: bk_store = bk, one value per byte — with
// per-(group, column) f32 scales, group == bk.  (wfp8 weights take bits 8:
// the JAX package stores them as per-group int8.)
//
// What bounds it on an H100: bytes at decode, both at prefill.  At M = 4
// the product does 8 flops per 4-bit weight byte read (4 per 8-bit byte),
// so the weights' bytes set the floor; at M = 128 operations and bytes
// take about the same time.  The design keeps W in its stored width until
// it is in shared memory and spreads
// its bytes over as many SMs as the shape allows:
//   * a block owns a 32-column slice of one bn-wide packed tile and
//     16 (M <= 16) or 64 rows of M, so even a 320-wide weight gives 10
//     blocks and a 2560-wide one 80;
//   * its 8 warps split the K tiles between them (warp w takes tiles
//     w, w + 8, ...), each prefetching its next tile's bytes with 16-byte
//     loads while it multiplies the current one; the partial sums are
//     added at the end in warp order, so every output is the same sum in
//     the same order whatever M is (batch-composition independent);
//   * in the warp, the values (nibbles unpacked with signed shifts) are
//     scaled by the group scale and rounded to bf16 — the Pallas kernel's
//     I2F + scale — straight into mma.sync m16n8k16 bf16 B fragments; the
//     product accumulates in f32 on the tensor cores.
// Ragged M is masked in the kernel (no bm = 1 fallback).  wgmma, TMA and
// the paper's ldmatrix fragment layout (which would drop the byte gathers
// from shared memory) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;          // warps per block (split K)
constexpr int SLICE = 32;      // N columns per block (4 mma n8 tiles)

__device__ __forceinline__ uint32_t bf16_pair(int lo, int hi, float s) {
  __nv_bfloat162 h = __floats2bfloat162_rn(static_cast<float>(lo) * s,
                                           static_cast<float>(hi) * s);
  return *reinterpret_cast<uint32_t*>(&h);
}

// B fragment word of (k, k + 1) at one column, scaled: bits 4 reads the
// byte row k / 2 (low nibble = even k, both sign-extended), bits 8 the
// byte rows k and k + 1 of the warp's (bk_store, SLICE) tile.
template <int BITS>
__device__ __forceinline__ uint32_t frag_pair(const uint8_t* wsm, int k,
                                              int col, float s) {
  if constexpr (BITS == 4) {
    const uint8_t byte = wsm[(k / 2) * SLICE + col];
    const int lo = static_cast<int8_t>(static_cast<uint8_t>(byte << 4)) >> 4;
    const int hi = static_cast<int8_t>(byte) >> 4;
    return bf16_pair(lo, hi, s);
  } else {
    return bf16_pair(static_cast<int8_t>(wsm[k * SLICE + col]),
                     static_cast<int8_t>(wsm[(k + 1) * SLICE + col]), s);
  }
}

__device__ __forceinline__ uint32_t ld_x(const __nv_bfloat16* x, int row,
                                         int M, size_t off) {
  return row < M ? __ldg(reinterpret_cast<const unsigned int*>(x + off)) : 0u;
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BITS, int BK, int MT>
constexpr size_t smem_bytes() {
  return size_t(NW) * (BK * BITS / 8) * SLICE +
         size_t(NW) * 16 * MT * SLICE * 4;
}

// BITS: 4 or 8; BK: K rows per packed tile (== quant group); MT: m16
// tiles per block.
template <int BITS, int BK, int MT>
__global__ void __launch_bounds__(NW * 32)
mpgemm_a16_kernel(const __nv_bfloat16* __restrict__ x,
                  const int8_t* __restrict__ w,
                  const float* __restrict__ scales,
                  __nv_bfloat16* __restrict__ y, int M, int K, int N,
                  int bn) {
  constexpr int WROWS = BK * BITS / 8; // stored byte rows per tile
  constexpr int CH = WROWS / 16;       // 16-byte chunks per lane per tile
  constexpr int BM = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  uint8_t* wsm = smem + warp * WROWS * SLICE;
  float* red = reinterpret_cast<float*>(smem + NW * WROWS * SLICE);

  const int m0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * SLICE;            // first output column
  const int j = col0 / bn, c_in = col0 % bn;      // packed tile, offset
  const int Nt = N / bn, Kt = K / BK;

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  uint4 pre[CH];
  float spre[4];
  auto prefetch = [&](int kt) {
    const int8_t* base = w + (size_t(kt) * Nt + j) * WROWS * bn + c_in;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int idx = lane + 32 * c;             // row idx/2, half idx%2
      pre[c] = __ldg(reinterpret_cast<const uint4*>(
          base + size_t(idx >> 1) * bn + (idx & 1) * 16));
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      spre[nt] = __ldg(scales + size_t(kt) * N + col0 + nt * 8 + g);
  };

  if (warp < Kt) prefetch(warp);
  for (int kt = warp; kt < Kt; kt += NW) {
    __syncwarp();
#pragma unroll
    for (int c = 0; c < CH; ++c)
      reinterpret_cast<uint4*>(wsm)[lane + 32 * c] = pre[c];
    float sc[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) sc[nt] = spre[nt];
    __syncwarp();
    if (kt + NW < Kt) prefetch(kt + NW);

#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const size_t kcol = size_t(kt) * BK + ks * 16 + tig * 2;
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r0 = m0 + mt * 16 + g, r1 = r0 + 8;
        a[mt][0] = ld_x(x, r0, M, size_t(r0) * K + kcol);
        a[mt][1] = ld_x(x, r1, M, size_t(r1) * K + kcol);
        a[mt][2] = ld_x(x, r0, M, size_t(r0) * K + kcol + 8);
        a[mt][3] = ld_x(x, r1, M, size_t(r1) * K + kcol + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t b[2];
        const int k = ks * 16 + tig * 2, col = nt * 8 + g;
        b[0] = frag_pair<BITS>(wsm, k, col, sc[nt]);
        b[1] = frag_pair<BITS>(wsm, k + 8, col, sc[nt]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], a[mt], b);
      }
    }
  }

  // fixed-order reduction of the 8 warps' partial sums
  float* mine = red + warp * BM * SLICE;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r = mt * 16 + g, c = nt * 8 + tig * 2;
      mine[r * SLICE + c] = acc[mt][nt][0];
      mine[r * SLICE + c + 1] = acc[mt][nt][1];
      mine[(r + 8) * SLICE + c] = acc[mt][nt][2];
      mine[(r + 8) * SLICE + c + 1] = acc[mt][nt][3];
    }
  __syncthreads();
  for (int o = threadIdx.x; o < BM * SLICE; o += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < NW; ++v) s += red[v * BM * SLICE + o];
    const int m = m0 + o / SLICE;
    if (m < M) y[size_t(m) * N + col0 + o % SLICE] = __float2bfloat16_rn(s);
  }
}

template <int BITS, int BK, int MT>
int launch(const void* x, const void* w, const void* scales, void* y, int M,
           int K, int N, int bn, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<BITS, BK, MT>();
  auto kern = mpgemm_a16_kernel<BITS, BK, MT>;
  if (smem > 48 * 1024) {
    static bool attr_set = false;        // once per instantiation
    if (!attr_set) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
      if (e != cudaSuccess) return int(e);
      attr_set = true;
    }
  }
  dim3 grid((M + 16 * MT - 1) / (16 * MT), N / SLICE);
  kern<<<grid, NW * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scales), static_cast<__nv_bfloat16*>(y), M, K,
      N, bn);
  return int(cudaGetLastError());
}

template <int BITS, int BK>
int launch_m(const void* x, const void* w, const void* scales, void* y, int M,
             int K, int N, int bn, cudaStream_t stream) {
  return M <= 16 ? launch<BITS, BK, 1>(x, w, scales, y, M, K, N, bn, stream)
                 : launch<BITS, BK, 4>(x, w, scales, y, M, K, N, bn, stream);
}

template <int BITS>
int launch_bk(const void* x, const void* w, const void* scales, void* y,
              int M, int K, int N, int bk, int bn, cudaStream_t st) {
  switch (bk) {
    case 32:
      return launch_m<BITS, 32>(x, w, scales, y, M, K, N, bn, st);
    case 64:
      return launch_m<BITS, 64>(x, w, scales, y, M, K, N, bn, st);
    case 128:
      return launch_m<BITS, 128>(x, w, scales, y, M, K, N, bn, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (M, K) bf16; w (K/bk, N/bn, bk * bits / 8, bn) int8; scales (K/bk, N)
// f32; y (M, N) bf16.  Takes bits in {4, 8}, bk in {32, 64, 128} and bn a
// multiple of 32.  Returns the CUDA error of the launch (0 on success).
extern "C" int mpgemm_a16(const void* x, const void* w, const void* scales,
                          void* y, int bits, int M, int K, int N, int bk,
                          int bn, void* stream) {
  if (bn % SLICE || K % bk || N % bn || M < 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 4) return launch_bk<4>(x, w, scales, y, M, K, N, bk, bn, st);
  if (bits == 8) return launch_bk<8>(x, w, scales, y, M, K, N, bk, bn, st);
  return int(cudaErrorInvalidValue);
}
