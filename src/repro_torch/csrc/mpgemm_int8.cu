// W4A8 / W8A8 GEMM on the int8 tensor cores over tile-major packed
// weights.
//
// Replaces repro/kernels/mpgemm.py:96 mpgemm_int8_2d (kernel body
// _mpgemm_int8_kernel :69): y (M, N) bf16 = (xq (M, K) int8 @ W) with
// per-token activation scales xscale (M, 1) f32 and W as in mpgemm.cu —
// (K/bk, N/bn, bk_store, bn) int8 tiles, bits 4 (bk_store = bk/2, low
// nibble = even k) or 8, per-(group, column) f32 scales, group == bk.  Per
// K tile the exact s32 partial product is multiplied by the group scale
// into an f32 accumulator; xscale multiplies at the store.  The
// activations are quantized outside the kernel (plain torch ops), as the
// JAX package quantizes them outside its Pallas kernel.
//
// What bounds it on an H100: bytes at decode (M = 4: 8 int8 ops per 4-bit
// weight byte), both at prefill (M = 128), against the card's int8
// tensor-core peak.  The design is mpgemm.cu's: a block owns a 32-column
// slice of one bn-wide tile and 16 (M <= 16) or 64 rows; its 8 warps split
// the K tiles (warp w takes tiles w, w + 8, ...), prefetching the next
// tile's bytes with 16-byte loads while they multiply the current one.
// Each warp builds s8 B fragments from the tile in shared memory (W4
// nibbles sign-extended to s8, which is exact) for mma.sync m16n8k32
// s8.s8.s32, and A fragments straight from xq.  The 8 warps' f32 partial
// sums are added at the end in warp order: no atomics, no split-K in a
// varying order, so every output is the same sum whatever M is.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;          // warps per block (split K)
constexpr int SLICE = 32;      // N columns per block (4 mma n8 tiles)

__device__ __forceinline__ uint32_t ld_x(const int8_t* x, int row, int M,
                                         size_t off) {
  return row < M ? __ldg(reinterpret_cast<const unsigned int*>(x + off)) : 0u;
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t(a) & 0xff) | ((uint32_t(b) & 0xff) << 8) |
         ((uint32_t(c) & 0xff) << 16) | ((uint32_t(d) & 0xff) << 24);
}

// B fragment word: s8 values of rows k..k+3 at one column of the warp's
// (bk_store, SLICE) tile, lowest k in the lowest byte.
template <int BITS>
__device__ __forceinline__ uint32_t frag_quad(const uint8_t* wsm, int k,
                                              int col) {
  if constexpr (BITS == 4) {
    const uint8_t b0 = wsm[(k / 2) * SLICE + col];
    const uint8_t b1 = wsm[(k / 2 + 1) * SLICE + col];
    auto lo = [](uint8_t b) {
      return static_cast<int8_t>(static_cast<uint8_t>(b << 4)) >> 4;
    };
    auto hi = [](uint8_t b) { return static_cast<int8_t>(b) >> 4; };
    return pack4(lo(b0), hi(b0), lo(b1), hi(b1));
  } else {
    return pack4(wsm[k * SLICE + col], wsm[(k + 1) * SLICE + col],
                 wsm[(k + 2) * SLICE + col], wsm[(k + 3) * SLICE + col]);
  }
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
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
mpgemm_int8_kernel(const int8_t* __restrict__ x,
                   const float* __restrict__ xscale,
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
  float spre[4][2];
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
#pragma unroll
      for (int e = 0; e < 2; ++e)
        spre[nt][e] =
            __ldg(scales + size_t(kt) * N + col0 + nt * 8 + tig * 2 + e);
  };

  if (warp < Kt) prefetch(warp);
  for (int kt = warp; kt < Kt; kt += NW) {
    __syncwarp();
#pragma unroll
    for (int c = 0; c < CH; ++c)
      reinterpret_cast<uint4*>(wsm)[lane + 32 * c] = pre[c];
    float sc[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      sc[nt][0] = spre[nt][0];
      sc[nt][1] = spre[nt][1];
    }
    __syncwarp();
    if (kt + NW < Kt) prefetch(kt + NW);

    int part[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0;

#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      const int kl = ks * 32 + tig * 4;           // tile-local k of frags
      const size_t kcol = size_t(kt) * BK + kl;
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r0 = m0 + mt * 16 + g, r1 = r0 + 8;
        a[mt][0] = ld_x(x, r0, M, size_t(r0) * K + kcol);
        a[mt][1] = ld_x(x, r1, M, size_t(r1) * K + kcol);
        a[mt][2] = ld_x(x, r0, M, size_t(r0) * K + kcol + 16);
        a[mt][3] = ld_x(x, r1, M, size_t(r1) * K + kcol + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = nt * 8 + g;
        uint32_t b[2];
        b[0] = frag_quad<BITS>(wsm, kl, col);
        b[1] = frag_quad<BITS>(wsm, kl + 16, col);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_s8(part[mt][nt], a[mt], b);
      }
    }
    // the K tile's exact s32 partial times its group scale, into f32
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[mt][nt][i] += static_cast<float>(part[mt][nt][i]) *
                            sc[nt][i & 1];
  }

  // fixed-order reduction of the 8 warps' partial sums, xscale at the store
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
    if (m < M)
      y[size_t(m) * N + col0 + o % SLICE] = __float2bfloat16_rn(s * xscale[m]);
  }
}

template <int BITS, int BK, int MT>
int launch(const void* x, const void* xs, const void* w, const void* scales,
           void* y, int M, int K, int N, int bn, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<BITS, BK, MT>();
  auto kern = mpgemm_int8_kernel<BITS, BK, MT>;
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
      static_cast<const int8_t*>(x), static_cast<const float*>(xs),
      static_cast<const int8_t*>(w), static_cast<const float*>(scales),
      static_cast<__nv_bfloat16*>(y), M, K, N, bn);
  return int(cudaGetLastError());
}

template <int BITS, int BK>
int launch_m(const void* x, const void* xs, const void* w, const void* sc,
             void* y, int M, int K, int N, int bn, cudaStream_t st) {
  return M <= 16 ? launch<BITS, BK, 1>(x, xs, w, sc, y, M, K, N, bn, st)
                 : launch<BITS, BK, 4>(x, xs, w, sc, y, M, K, N, bn, st);
}

template <int BITS>
int launch_bk(const void* x, const void* xs, const void* w, const void* sc,
              void* y, int M, int K, int N, int bk, int bn, cudaStream_t st) {
  switch (bk) {
    case 32:
      return launch_m<BITS, 32>(x, xs, w, sc, y, M, K, N, bn, st);
    case 64:
      return launch_m<BITS, 64>(x, xs, w, sc, y, M, K, N, bn, st);
    case 128:
      return launch_m<BITS, 128>(x, xs, w, sc, y, M, K, N, bn, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// xq (M, K) int8; xscale (M,) f32; w (K/bk, N/bn, bk * bits / 8, bn) int8;
// scales (K/bk, N) f32; y (M, N) bf16.  Takes bits in {4, 8}, bk in
// {32, 64, 128}, bn a multiple of 32 and K a multiple of 4.  Returns the
// CUDA error of the launch (0 on success).
extern "C" int mpgemm_int8(const void* x, const void* xs, const void* w,
                           const void* scales, void* y, int bits, int M,
                           int K, int N, int bk, int bn, void* stream) {
  if (bn % SLICE || K % bk || N % bn || M < 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 4)
    return launch_bk<4>(x, xs, w, scales, y, M, K, N, bk, bn, st);
  if (bits == 8)
    return launch_bk<8>(x, xs, w, scales, y, M, K, N, bk, bn, st);
  return int(cudaErrorInvalidValue);
}
