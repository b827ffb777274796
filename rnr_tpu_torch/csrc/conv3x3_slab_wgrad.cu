// K8b: the weight gradient of the 3x3 stride-1 convolution in the slab
// formulation:
//     dWcat[dy*C + c, dx*O + o] = sum over n, i, j' of
//                                 xp[n, i + dy, j', c] * g[n, i, j' - dx, o]
// over the W + 2 slab columns j' (g is zero outside [0, W)), unpacked to
// dW [3, 3, C, O] f32.  NHWC bf16 input x and output gradient g, f32 sums.
// xp is x under a ring of zero ("same") or reflect padding, taken by index
// arithmetic while the tile is staged: neither the slab [N, H, W+2, 3C]
// nor the shifted gradient g3 [N, H, W+2, 3O] is built.
//
// Replaces: rnr_tpu/ops/conv_pallas.py  _conv3x3_slab_wgrad_impl (:982) /
//   _slab_wgrad_kernel (:961).  The TPU kernel zeroes its one [KC, 3O]
//   output block at grid step (0, 0) and adds every tile's product into
//   it across its sequential grid; XLA builds the slab and g3 in HBM.  On
//   the card blocks run at the same time, so that accumulation becomes
//   split-K: each block sums its own slice of slab pixels into a partial,
//   and a second kernel adds the partials in a fixed order (as K3b,
//   csrc/conv3x3_wgrad.cu).  No atomics: two runs on the same inputs give
//   bitwise equal results.
//
// Bound on the H100: tensor-core throughput (the 14 weight gradients of a
//   512^2 frame are about 0.22 TFLOP against a few hundred MB).
// Design: WMMA bf16 fragments, f32 accumulators.  Grid (3 bands x C
//   tiles, O tiles, splits).  A block owns the [64, 192] tile of dWcat
//   made of 64 channels of one band dy and all three dx bands of 64
//   output channels, and walks its slice of the flattened slab pixels
//   (n, i, j') 32 at a time.  Per step it stages the 32 pixels' band-dy
//   row of xp (64 channels, padding per pixel) and the 34 gradient rows
//   gflat[p0 - 2 .. p0 + 31] (gflat: g on the slab's columns, zero at
//   j' >= W, so that gflat[p - dx] is g[n, i, j' - dx] or zero for every
//   j' and dx); the dx band's B fragment is that tile read 2 - dx rows on
//   (rows of 80 bf16 keep each shifted fragment 32-byte aligned).  One
//   staged x tile thus feeds all three dx taps.  8 warps (2 x 4) each
//   accumulate a 32 x 48 tile.  The epilogue stores one dx band at a time
//   through shared memory into this split's partial.  Single-buffered,
//   without TMA or wgmma: a right, simple first version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int BM = 64;          // channels of one band per block (dWcat rows)
constexpr int NB = 64;          // output channels per dx band
constexpr int BK = 32;          // slab pixels per K step
constexpr int GR = BK + 2;      // gradient rows staged per step
constexpr int LDA = BM + 8;     // bf16 elements; multiple of 8 for WMMA
constexpr int LDG = NB + 16;    // 160-byte rows: shifted fragments stay aligned
constexpr int LDC = NB + 4;     // f32 elements; multiple of 4 for WMMA
constexpr int THREADS = 256;

constexpr int SMEM_AB = (BK * LDA + GR * LDG) * 2;
constexpr int SMEM_C = BM * LDC * 4;
constexpr int SMEM = SMEM_AB > SMEM_C ? SMEM_AB : SMEM_C;

static_assert((BK * LDA * 2) % 32 == 0 && (LDG * 2) % 32 == 0,
              "WMMA fragment pointers must be 32-byte aligned");

__device__ __forceinline__ int pad_index(int i, int n, bool reflect) {
  // -1 -> 1 and n -> n-2 under reflect (jnp.pad mode="reflect"); a
  // negative value for "outside" under zero padding
  if (i >= 0 && i < n) return i;
  if (!reflect) return -1;
  return i < 0 ? -i : 2 * n - 2 - i;
}

// 8 consecutive bf16 values of row `row` (length `len`) from column `col`,
// zero past the row's end or for row < 0.
template <bool VEC>
__device__ __forceinline__ void stage8(__nv_bfloat16* dst,
                                       const __nv_bfloat16* __restrict__ src,
                                       long long row, int len, int col) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  if (VEC && row >= 0 && col + 8 <= len) {
    *reinterpret_cast<uint4*>(dst) =
        __ldg(reinterpret_cast<const uint4*>(src + row * len + col));
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      dst[k] = (row >= 0 && col + k < len) ? src[row * len + col + k] : zero;
  }
}

template <bool VA, bool VB>
__global__ void __launch_bounds__(THREADS)
slab_wgrad_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ g,
                  float* __restrict__ part, int n, int h, int wd, int c,
                  int o, int reflect, int chunk) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);   // [BK][LDA]
  __nv_bfloat16* Gs = As + BK * LDA;                             // [GR][LDG]
  float* Cs = reinterpret_cast<float*>(smem);                    // [BM][LDC]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 4;   // dWcat rows wm*32 .. +32
  const int wn = warp % 4;   // dWcat cols wn*48 .. +48 (3 fragments)
  const int c_tiles = (c + BM - 1) / BM;
  const int dy = blockIdx.x / c_tiles;
  const int c0 = (blockIdx.x % c_tiles) * BM;
  const int o0 = blockIdx.y * NB;
  const int split = blockIdx.z;
  const int sw = wd + 2;                              // slab width
  const long long p_total = (long long)n * h * sw;
  const long long p_begin = (long long)split * chunk;
  const long long p_end =
      p_begin + chunk < p_total ? p_begin + chunk : p_total;

  // the slab pixel and 8-channel group this thread stages for A
  const int s_pix = tid / (BM / 8);
  const int s_col = (tid % (BM / 8)) * 8;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][3];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (long long p0 = p_begin; p0 < p_end; p0 += BK) {
    // ---- stage A: xp's band-dy row at 32 slab pixels, 64 channels ----
    {
      const long long fp = p0 + s_pix;
      long long src = -1;
      if (fp < p_end) {
        const int jp = (int)(fp % sw);
        const long long t = fp / sw;          // n * h + i
        const int i = (int)(t % h);
        const int hs = pad_index(i + dy - 1, h, reflect);
        const int ws = pad_index(jp - 1, wd, reflect);
        if (hs >= 0 && ws >= 0) src = (t - i + hs) * wd + ws;
      }
      stage8<VA>(As + s_pix * LDA + s_col, x, src, c, c0 + s_col);
    }
    // ---- stage G: gflat rows p0 - 2 .. p0 + BK - 1, 64 channels ----
    for (int e = tid; e < GR * (NB / 8); e += THREADS) {
      const int q = e / (NB / 8), col = (e % (NB / 8)) * 8;
      const long long fp = p0 - 2 + q;
      long long row = -1;
      if (fp >= 0 && fp < p_total) {
        const int jp = (int)(fp % sw);
        if (jp < wd) row = fp / sw * wd + jp;
      }
      stage8<VB>(Gs + q * LDG + col, g, row, o, o0 + col);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + kk * LDA + wm * 32 + i * 16, LDA);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int col = wn * 48 + j * 16;
        const int dx = col / NB;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Gs + (kk + 2 - dx) * LDG + col % NB, LDG);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    __syncthreads();
  }

  // ---- epilogue, one dx band at a time: accumulators -> shared -> this
  //      split's partial dW[dy, dx] ----
  float* dst = part + (size_t)split * 9 * c * o;
  for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int col = wn * 48 + j * 16;
      if (col / NB != dx) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + col % NB,
                                acc[i][j], LDC, wmma::mem_row_major);
    }
    __syncthreads();
    float* tap = dst + (size_t)(dy * 3 + dx) * c * o;
    for (int e = tid; e < BM * NB; e += THREADS) {
      const int r = e / NB, col = e % NB;
      const int ci = c0 + r, oc = o0 + col;
      if (ci < c && oc < o) tap[(size_t)ci * o + oc] = Cs[r * LDC + col];
    }
    __syncthreads();
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

// x [N, H, W, C] bf16, g [N, H, W, O] bf16 -> dw [3, 3, C, O] f32.  The
// N H (W + 2) slab pixels are cut into `splits` slices of `chunk` (a
// multiple of 32); with splits > 1, `part` is scratch of splits * 9 * C * O
// floats and a second kernel reduces it into dw; with splits == 1 the one
// pass writes dw and `part` is not read.
extern "C" int rnr_conv3x3s_wgrad(const void* x, const void* g, void* part,
                                  void* dw, int n, int h, int wd, int c,
                                  int o, int reflect, int splits, int chunk,
                                  cudaStream_t stream) {
  if (n < 1 || h < 1 || wd < 1 || c < 1 || o < 1)
    return (int)cudaErrorInvalidValue;
  if (splits < 1 || chunk < BK || chunk % BK) return (int)cudaErrorInvalidValue;
  if ((long long)splits * chunk < (long long)n * h * (wd + 2))
    return (int)cudaErrorInvalidValue;
  float* dst = static_cast<float*>(splits > 1 ? part : dw);
  dim3 grid((unsigned)(3 * ((c + BM - 1) / BM)), (unsigned)((o + NB - 1) / NB),
            (unsigned)splits);
  auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* gp = static_cast<const __nv_bfloat16*>(g);
  const bool va = c % 8 == 0, vb = o % 8 == 0;
  if (va && vb)
    slab_wgrad_kernel<true, true><<<grid, THREADS, 0, stream>>>(xp, gp, dst, n, h, wd, c, o, reflect, chunk);
  else if (va)
    slab_wgrad_kernel<true, false><<<grid, THREADS, 0, stream>>>(xp, gp, dst, n, h, wd, c, o, reflect, chunk);
  else if (vb)
    slab_wgrad_kernel<false, true><<<grid, THREADS, 0, stream>>>(xp, gp, dst, n, h, wd, c, o, reflect, chunk);
  else
    slab_wgrad_kernel<false, false><<<grid, THREADS, 0, stream>>>(xp, gp, dst, n, h, wd, c, o, reflect, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long count = 9LL * c * o;
  reduce_splits<<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), count, splits);
  return (int)cudaGetLastError();
}
