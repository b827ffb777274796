// Weight gradient of the 3x3 stride-1 convolution:
//     dW[dy, dx, c, o] = sum over n, h, w of  x_pad[n, h+dy, w+dx, c] * g[n, h, w, o]
// NHWC bf16 input x and output gradient g, f32 sums, f32 [3, 3, C, O]
// output.  x_pad is x under zero ("same") or reflect padding, taken by
// index arithmetic while the tile is staged (as csrc/conv3x3.cu does): no
// padded copy of x is made.
//
// Replaces: rnr_tpu/ops/conv_pallas.py  _conv3x3_wgrad_impl (:308) /
//   _wgrad_kernel (:272).  The TPU kernel adds every row tile into one
//   revisited [3, 3, C, O] output block across its sequential grid.
//   CUDA blocks run at the same time, so that accumulation becomes
//   split-K: each block sums its own slice of pixels into a partial, and
//   a second kernel adds the partials in a fixed order.  No atomics: two
//   runs on the same inputs give bitwise equal results.
//
// Bound on the H100: tensor-core throughput.  Per tap it is a GEMM with
//   M x N = C x O and a very deep K = N*H*W (262,144 at 512^2); the 14
//   weight gradients of a 512^2 frame are about 0.22 TFLOP against a
//   few hundred MB of activations.
// Design: WMMA bf16 fragments (mma.sync underneath), f32 accumulators.
//   Grid (C tiles, O tiles, 9 taps x splits).  A block owns a 64 x 64
//   tile of one tap's dW and walks its pixel slice 32 pixels at a time:
//   it stages the 32 shifted input rows (64 channels each, the padding
//   rule applied per pixel) and the 32 gradient rows (64 outputs each)
//   in shared memory; 4 warps (2 x 2) each accumulate a 32 x 32 tile.
//   The x tile is read as a column-major A operand, so no transpose is
//   staged.  Ragged C and O (108, 78 on the canonical frame) take scalar
//   staging.  Single-buffered, without TMA or wgmma: a right, simple
//   first version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int BM = 64;    // input channels per block (dW rows)
constexpr int BN = 64;    // output channels per block (dW columns)
constexpr int BK = 32;    // pixels per K step
constexpr int LDA = BM + 8;   // bf16 elements; multiple of 8 for WMMA
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;   // f32 elements; multiple of 4 for WMMA
constexpr int THREADS = 128;

constexpr int SMEM_AB = (BK * LDA + BK * LDB) * 2;
constexpr int SMEM_C = BM * LDC * 4;
constexpr int SMEM = SMEM_AB > SMEM_C ? SMEM_AB : SMEM_C;

__device__ __forceinline__ int pad_index(int i, int n, bool reflect) {
  // -1 -> 1 and n -> n-2 under reflect (jnp.pad mode="reflect");
  // -1 for "outside" under zero padding
  if (i >= 0 && i < n) return i;
  if (!reflect) return -1;
  return i < 0 ? -i : 2 * n - 2 - i;
}

// 16 consecutive bf16 values of row `row` (length `len`) from column
// `col`, zero past the row's end or for row < 0.
template <bool VEC>
__device__ __forceinline__ void stage16(__nv_bfloat16* dst,
                                        const __nv_bfloat16* __restrict__ src,
                                        long long row, int len, int col) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  if (VEC && row >= 0 && col + 16 <= len) {
    const uint4* s = reinterpret_cast<const uint4*>(src + row * len + col);
    uint4* d = reinterpret_cast<uint4*>(dst);
    d[0] = __ldg(s);
    d[1] = __ldg(s + 1);
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k)
      dst[k] = (row >= 0 && col + k < len) ? src[row * len + col + k] : zero;
  }
}

template <bool VA, bool VB>
__global__ void __launch_bounds__(THREADS)
wgrad_kernel(const __nv_bfloat16* __restrict__ x,
             const __nv_bfloat16* __restrict__ g, float* __restrict__ part,
             int n, int h, int wd, int c, int o, int reflect, int chunk) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);   // [BK][LDA]
  __nv_bfloat16* Bs = As + BK * LDA;                             // [BK][LDB]
  float* Cs = reinterpret_cast<float*>(smem);                    // [BM][LDC]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;   // dW rows wm*32 .. +32
  const int wn = warp % 2;   // dW cols wn*32 .. +32
  const int c0 = blockIdx.x * BM;
  const int o0 = blockIdx.y * BN;
  const int tap = blockIdx.z % 9;
  const int split = blockIdx.z / 9;
  const int dy = tap / 3, dx = tap % 3;
  const long long p_total = (long long)n * h * wd;
  const long long p_begin = (long long)split * chunk;
  const long long p_end =
      p_begin + chunk < p_total ? p_begin + chunk : p_total;

  // the pixel row and 16-column slice this thread stages
  const int s_row = tid / 4;
  const int s_col = (tid % 4) * 16;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (long long p0 = p_begin; p0 < p_end; p0 += BK) {
    const long long p = p0 + s_row;
    long long src = -1, grow = -1;
    if (p < p_end) {
      grow = p;
      const int pw = (int)(p % wd);
      const long long t = p / wd;
      const int ph = (int)(t % h);
      const int pn = (int)(t / h);
      const int hs = pad_index(ph + dy - 1, h, reflect);
      const int ws = pad_index(pw + dx - 1, wd, reflect);
      if (hs >= 0 && ws >= 0) src = ((long long)pn * h + hs) * wd + ws;
    }
    stage16<VA>(As + s_row * LDA + s_col, x, src, c, c0 + s_col);
    stage16<VB>(Bs + s_row * LDB + s_col, g, grow, o, o0 + s_col);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + kk * LDA + wm * 32 + i * 16, LDA);
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

  // ---- epilogue: accumulators -> shared -> this split's partial ----
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  float* dst = part + ((size_t)split * 9 + tap) * c * o;
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN, col = e % BN;
    const int ci = c0 + r, oc = o0 + col;
    if (ci < c && oc < o) dst[(size_t)ci * o + oc] = Cs[r * LDC + col];
  }
}

// dw[i] = sum over s of part[s][i], in split order (deterministic).
__global__ void __launch_bounds__(256)
reduce_splits(const float* __restrict__ part, float* __restrict__ dw,
              long long count, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * count + i];
  dw[i] = s;
}

}  // namespace

// x [N, H, W, C] bf16, g [N, H, W, O] bf16 -> dw [3, 3, C, O] f32.
// The pixels are cut into `splits` slices of `chunk` (a multiple of 32);
// with splits > 1, `part` is scratch of splits * 9 * C * O floats and a
// second kernel reduces it into dw; with splits == 1 the one pass writes
// dw and `part` is not read.
extern "C" int rnr_conv3x3_wgrad(const void* x, const void* g, void* part,
                                 void* dw, int n, int h, int wd, int c, int o,
                                 int reflect, int splits, int chunk,
                                 cudaStream_t stream) {
  if (splits < 1 || chunk < BK || chunk % BK) return (int)cudaErrorInvalidValue;
  if ((long long)splits * chunk < (long long)n * h * wd)
    return (int)cudaErrorInvalidValue;
  float* dst = static_cast<float*>(splits > 1 ? part : dw);
  dim3 grid((unsigned)((c + BM - 1) / BM), (unsigned)((o + BN - 1) / BN),
            (unsigned)(9 * splits));
  auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* gp = static_cast<const __nv_bfloat16*>(g);
  const bool va = c % 8 == 0, vb = o % 8 == 0;
  if (va && vb)
    wgrad_kernel<true, true><<<grid, THREADS, 0, stream>>>(xp, gp, dst, n, h, wd, c, o, reflect, chunk);
  else if (va)
    wgrad_kernel<true, false><<<grid, THREADS, 0, stream>>>(xp, gp, dst, n, h, wd, c, o, reflect, chunk);
  else if (vb)
    wgrad_kernel<false, true><<<grid, THREADS, 0, stream>>>(xp, gp, dst, n, h, wd, c, o, reflect, chunk);
  else
    wgrad_kernel<false, false><<<grid, THREADS, 0, stream>>>(xp, gp, dst, n, h, wd, c, o, reflect, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long count = 9LL * c * o;
  reduce_splits<<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), count, splits);
  return (int)cudaGetLastError();
}
