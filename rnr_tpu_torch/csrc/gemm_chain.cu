// P1: a chain of matrix products summed in one accumulator,
//     y = bf16( sum over t < T of x . w[t] ),
// x [M, K] bf16, w [T, K, N] bf16, f32 accumulation, y [M, N] bf16.
//
// Replaces: tools/tpu_probe_r5.py  gemm_chain_pallas (:81) /
//   _gemm_chain_kernel (:67), the probe of section A that runs the 3x3
//   conv kernels' geometry (M = slab rows, T back-to-back products per
//   tile, as the 9 taps) as a bare GEMM chain.  It lies on no path of the
//   package; chip_smoke.py's kernels phase runs it at section A's shapes.
//   The TPU kernel keeps one [rows, K] x tile in VMEM per grid step and
//   the whole w; here a block stages x per 32-deep slice of K and w[t]'s
//   matching slice per product.
//
// Bound on the H100: tensor-core throughput and device memory about
//   equally at section A's shapes (2 M K N T operations against
//   2 (M K + T K N + M N) bytes: 0.010-0.040 ms a shape).
// Design: WMMA bf16 fragments, f32 accumulators.  A block owns a 128 x 64
//   output tile; for each 32-deep slice of K it stages x's [128, 32]
//   slice once and then, for each t, w[t]'s [32, 64] slice, so the x tile
//   serves all T products; 8 warps (4 x 2) each accumulate a 32 x 32 tile
//   over every t and every slice.  The epilogue goes through shared
//   memory, casts once to bf16 and stores coalesced along N.
//   Single-buffered, without TMA or wgmma: a right, simple first version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int BM = 128;       // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // depth per K step
constexpr int LDA = BK + 8;   // bf16 elements; multiple of 8 for WMMA
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;   // f32 elements; multiple of 4 for WMMA
constexpr int THREADS = 256;

constexpr int SMEM_AB = (BM * LDA + BK * LDB) * 2;
constexpr int SMEM_C = BM * LDC * 4;
constexpr int SMEM = SMEM_AB > SMEM_C ? SMEM_AB : SMEM_C;

// 8 consecutive bf16 values of row `row` (< rows; length `len`) from
// column `col`, zero outside.
template <bool VEC>
__device__ __forceinline__ void stage8(__nv_bfloat16* dst,
                                       const __nv_bfloat16* __restrict__ src,
                                       long long row, long long rows, int len,
                                       int col) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const bool ok = row < rows;
  if (VEC && ok && col + 8 <= len) {
    *reinterpret_cast<uint4*>(dst) =
        __ldg(reinterpret_cast<const uint4*>(src + row * len + col));
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      dst[k] = (ok && col + k < len) ? src[row * len + col + k] : zero;
  }
}

template <bool VA, bool VB>
__global__ void __launch_bounds__(THREADS)
gemm_chain_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ w,
                  __nv_bfloat16* __restrict__ y, int m, int k, int n,
                  int taps) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);   // [BM][LDA]
  __nv_bfloat16* Bs = As + BM * LDA;                             // [BK][LDB]
  float* Cs = reinterpret_cast<float*>(smem);                    // [BM][LDC]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;   // rows wm*32 .. +32
  const int wn = warp % 2;   // cols wn*32 .. +32
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < k; k0 += BK) {
    // ---- stage A: x's [BM, BK] slice, once for every t ----
    for (int e = tid; e < BM * (BK / 8); e += THREADS) {
      const int r = e / (BK / 8), col = (e % (BK / 8)) * 8;
      stage8<VA>(As + r * LDA + col, x, m0 + r, m, k, k0 + col);
    }
    for (int t = 0; t < taps; ++t) {
      // ---- stage B: w[t]'s [BK, BN] slice ----
      {
        const int r = tid / (BN / 8), col = (tid % (BN / 8)) * 8;
        stage8<VB>(Bs + r * LDB + col, w + (size_t)t * k * n, k0 + r, k, n,
                   n0 + col);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], Bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // ---- epilogue: accumulators -> shared -> one bf16 cast, coalesced ----
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN, col = e % BN;
    const long long row = m0 + r;
    const int oc = n0 + col;
    if (row < m && oc < n) y[row * n + oc] = __float2bfloat16(Cs[r * LDC + col]);
  }
}

}  // namespace

// x [M, K] bf16, w [T, K, N] bf16 -> y [M, N] bf16.
extern "C" int rnr_gemm_chain(const void* x, const void* w, void* y, int m,
                              int k, int n, int taps, cudaStream_t stream) {
  if (m < 1 || k < 1 || n < 1 || taps < 1) return (int)cudaErrorInvalidValue;
  const long long m_tiles = ((long long)m + BM - 1) / BM;
  const int n_tiles = (n + BN - 1) / BN;
  if (m_tiles > 0x7fffffffLL || n_tiles > 65535)
    return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)m_tiles, (unsigned)n_tiles);
  auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* wp = static_cast<const __nv_bfloat16*>(w);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  // 16-byte staging needs rows of 8-element multiples
  const bool va = k % 8 == 0, vb = n % 8 == 0;
  if (va && vb)
    gemm_chain_kernel<true, true><<<grid, THREADS, 0, stream>>>(xp, wp, yp, m, k, n, taps);
  else if (va)
    gemm_chain_kernel<true, false><<<grid, THREADS, 0, stream>>>(xp, wp, yp, m, k, n, taps);
  else if (vb)
    gemm_chain_kernel<false, true><<<grid, THREADS, 0, stream>>>(xp, wp, yp, m, k, n, taps);
  else
    gemm_chain_kernel<false, false><<<grid, THREADS, 0, stream>>>(xp, wp, yp, m, k, n, taps);
  return (int)cudaGetLastError();
}
