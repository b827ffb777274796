// 3x3 stride-1 convolution, NHWC bf16 input, HWIO bf16 weights, f32
// accumulation, + bias in f32, bf16 output (rnr_conv3x3) or f32 output
// (rnr_conv3x3_f32out, the data gradient: the same kernel run on the
// output gradient with rotated, io-transposed weights, as
// conv_pallas.py:409-451 runs _conv3x3_fwd_impl).  Zero ("same") or reflect
// padding is done by index arithmetic while the input tile is staged:
// no padded copy of the input is ever made.
//
// Replaces: rnr_tpu/ops/conv_pallas.py  conv3x3 (:379) /
//   _conv3x3_fwd_impl (:192) / _conv_kernel (:158), the implicit-GEMM
//   3x3 conv of every U-Net level under conv_backend=pallas3.  The TPU
//   kernel pre-pads in XLA, DMAs row halos and falls back to XLA past a
//   VMEM budget; this kernel takes every shape (C up to 640, W from 16 to
//   512) with no fallback.
//
// Bound on the H100: tensor-core throughput.  The 14 convs of one 512^2
//   frame are about 0.43 TFLOP against a few hundred MB of activations;
//   a scalar-FMA kernel would take a good fraction of a second.
// Design: implicit GEMM on the tensor cores with WMMA bf16 fragments
//   (mma.sync underneath).  GEMM rows are output pixels (M = N*H*W),
//   columns are output channels (O), the reduction runs over 9 taps x C
//   channels.  A block owns a 128 x 64 output tile and walks K in steps
//   of 32 channels of one tap: it stages the shifted input rows (with the
//   padding rule applied per row) and the 32 x 64 weight slice in shared
//   memory, and 8 warps (4 x 2) each multiply-accumulate a 32 x 32 f32
//   tile in registers.  The epilogue goes through shared memory so the
//   bf16 stores are coalesced along O.  Single-buffered and without TMA
//   or wgmma: a right, simple first version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int BM = 128;   // output pixels per block
constexpr int BN = 64;    // output channels per block
constexpr int BK = 32;    // input channels per K step
constexpr int LDA = BK + 8;   // bf16 elements; multiple of 8 for WMMA
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;   // f32 elements; multiple of 4 for WMMA

constexpr int SMEM_AB = (BM * LDA + BK * LDB) * 2;
constexpr int SMEM_C = BM * LDC * 4;
constexpr int SMEM = SMEM_AB > SMEM_C ? SMEM_AB : SMEM_C;

__device__ __forceinline__ int pad_index(int i, int n, bool reflect) {
  // -1 -> 1 and n -> n-2 under reflect (jnp.pad mode="reflect");
  // -1 for "outside" under zero padding
  if (i >= 0 && i < n) return i;
  if (!reflect) return -1;
  return i < 0 ? -i : 2 * n - 2 - i;
}

__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }

template <bool VA, bool VB, typename OutT>
__global__ void __launch_bounds__(256)
conv3x3_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ w,
               const float* __restrict__ bias, OutT* __restrict__ y,
               int n, int h, int wd, int c, int o, int reflect) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BM * LDA;
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;   // 0..3: rows wm*32 .. +32
  const int wn = warp % 2;   // 0..1: cols wn*32 .. +32
  const long long m_total = (long long)n * h * wd;
  const long long m0 = (long long)blockIdx.x * BM;
  const int o0 = blockIdx.y * BN;

  // the A row this thread stages (2 threads per row, 16 channels each)
  const int a_row = tid / 2;
  const int a_col = (tid % 2) * 16;
  const long long pm = m0 + a_row;
  int pn = 0, ph = 0, pw = 0;
  const bool row_ok = pm < m_total;
  if (row_ok) {
    pw = (int)(pm % wd);
    const long long t = pm / wd;
    ph = (int)(t % h);
    pn = (int)(t / h);
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    // source pixel of this thread's A row under this tap (-1: zero pad)
    long long src = -1;
    if (row_ok) {
      const int hs = pad_index(ph + dy - 1, h, reflect);
      const int ws = pad_index(pw + dx - 1, wd, reflect);
      if (hs >= 0 && ws >= 0) src = (((long long)pn * h + hs) * wd + ws) * c;
    }
    const __nv_bfloat16* wt = w + (size_t)tap * c * o;
    for (int c0 = 0; c0 < c; c0 += BK) {
      // ---- stage A: [BM, BK] shifted input rows ----
      __nv_bfloat16* arow = As + a_row * LDA + a_col;
      const int cb = c0 + a_col;
      if (VA && src >= 0 && cb + 16 <= c) {
        const uint4* g = reinterpret_cast<const uint4*>(x + src + cb);
        uint4* s = reinterpret_cast<uint4*>(arow);
        s[0] = __ldg(g);
        s[1] = __ldg(g + 1);
      } else {
#pragma unroll
        for (int k = 0; k < 16; ++k)
          arow[k] = (src >= 0 && cb + k < c) ? x[src + cb + k] : zero;
      }
      // ---- stage B: [BK, BN] weight slice, rows = input channels ----
      {
        const int b_row = tid / 8;          // 0..31
        const int b_col = (tid % 8) * 8;    // 0..56
        const int ci = c0 + b_row, oc = o0 + b_col;
        __nv_bfloat16* brow = Bs + b_row * LDB + b_col;
        if (VB && ci < c && oc + 8 <= o) {
          *reinterpret_cast<uint4*>(brow) =
              __ldg(reinterpret_cast<const uint4*>(wt + (size_t)ci * o + oc));
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k)
            brow[k] = (ci < c && oc + k < o) ? wt[(size_t)ci * o + oc + k] : zero;
        }
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

  // ---- epilogue: accumulators -> shared -> + bias -> OutT, coalesced ----
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += 256) {
    const int r = e / BN, col = e % BN;
    const long long pmo = m0 + r;
    const int oc = o0 + col;
    if (pmo < m_total && oc < o)
      store_out(y + pmo * o + oc, Cs[r * LDC + col] + bias[oc]);
  }
}

template <typename OutT>
int launch(const void* x, const void* w, const void* bias, void* y, int n,
           int h, int wd, int c, int o, int reflect, cudaStream_t stream) {
  const long long m = (long long)n * h * wd;
  dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)((o + BN - 1) / BN));
  auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* wp = static_cast<const __nv_bfloat16*>(w);
  auto* bp = static_cast<const float*>(bias);
  auto* yp = static_cast<OutT*>(y);
  // 16-byte staging needs rows of 8-element multiples
  const bool va = c % 8 == 0, vb = o % 8 == 0;
  if (va && vb)
    conv3x3_kernel<true, true, OutT><<<grid, 256, 0, stream>>>(xp, wp, bp, yp, n, h, wd, c, o, reflect);
  else if (va)
    conv3x3_kernel<true, false, OutT><<<grid, 256, 0, stream>>>(xp, wp, bp, yp, n, h, wd, c, o, reflect);
  else if (vb)
    conv3x3_kernel<false, true, OutT><<<grid, 256, 0, stream>>>(xp, wp, bp, yp, n, h, wd, c, o, reflect);
  else
    conv3x3_kernel<false, false, OutT><<<grid, 256, 0, stream>>>(xp, wp, bp, yp, n, h, wd, c, o, reflect);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rnr_conv3x3(const void* x, const void* w, const void* bias,
                           void* y, int n, int h, int wd, int c, int o,
                           int reflect, cudaStream_t stream) {
  return launch<__nv_bfloat16>(x, w, bias, y, n, h, wd, c, o, reflect, stream);
}

// The same conv with an f32 output: the dgrad of conv3x3 (no rounding of
// the data gradient to bf16 before the reflect fold).
extern "C" int rnr_conv3x3_f32out(const void* x, const void* w,
                                  const void* bias, void* y, int n, int h,
                                  int wd, int c, int o, int reflect,
                                  cudaStream_t stream) {
  return launch<float>(x, w, bias, y, n, h, wd, c, o, reflect, stream);
}
