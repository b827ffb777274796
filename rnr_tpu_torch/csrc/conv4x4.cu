// K6: the U-Net's 4x4 stride-2 conv (rnr_down4) and 4x4 stride-2 "SAME"
// transpose conv (rnr_convt4), tap-wise.  NHWC bf16 input, HWIO bf16
// weights [4, 4, C, O], f32 accumulation, no bias (the U-Net adds it in
// the activation dtype), bf16 output or, for the data-gradient use, f32
// output (the *_f32out entry points: convt4 is down4's dgrad under zero
// padding, down4 is convt4's dgrad, as conv_pallas.py:763-806 run them).
//
//   down4:  y[n, i, j] = sum_{dy, dx < 4} xp[n, 2i + dy, 2j + dx] w[dy, dx]
//           xp = x with a ring of 1, zero or reflect, applied by index
//           arithmetic while the input tile is staged (no padded copy);
//           y is [N, H/2, W/2, O] (H//2 at odd H, as rnr_tpu's kernel).
//   convt4: per output parity (a, b), a 2x2 correlation on x zero-padded
//           by 1:  y[n, 2t + a, 2s + b] = sum_{r, q < 2}
//           xq[n, t + a + r, s + b + q] w[a + 2r, b + 2q]   -> [N, 2H, 2W, O]
//           (lax.conv_transpose with transpose_kernel=False is a
//           correlation on the 2x-dilated input; conv_pallas.py:617-627).
//
// Replaces: rnr_tpu/ops/conv_pallas.py  _down4_fwd_impl (:532) /
//   _down4_kernel (:481) and _convt4_fwd_impl (:664) / _convt4_kernel
//   (:617), the 4x4 pair under conv_backend=pallas.  The TPU kernels split
//   the padded input into row/column parity planes, pad rows to 8 and
//   channels to 128 and write four parity outputs that XLA interleaves,
//   all because Mosaic cannot load 16-bit data at a stride; they fall
//   back to XLA past a VMEM budget.  Here the stride-2 taps are read
//   directly, the interleaved output is written directly, and every
//   shape is taken (any C, O >= 1) with no fallback.
//
// Bound on the H100: tensor-core throughput.  The ten 4x4 convs of one
//   512^2 frame are about 184 GFLOP of useful taps against a few hundred
//   MB of activations.
// Design: implicit GEMM on the tensor cores with WMMA bf16 fragments
//   (mma.sync underneath), the layout of K3 (csrc/conv3x3.cu).  GEMM rows
//   are the pixels of the grid the taps are read on: the output pixels
//   (n, i, j) for down4 (16 taps), the input-grid pixels (n, t, s) of one
//   output parity for convt4 (4 taps; the parity is blockIdx.z).  GEMM
//   columns are output channels; the reduction runs over taps x C in
//   steps of 32 channels of one tap.  A block owns a 128 x 64 tile; 8
//   warps (4 x 2) each hold a 32 x 32 f32 tile.  The epilogue goes
//   through shared memory so the stores are coalesced along O.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int BM = 128;   // grid pixels per block
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

// UP = false: down4 over the output grid [N, H/2, W/2]; UP = true: convt4
// over the input grid [N, H, W] for the parity blockIdx.z = 2a + b.
template <bool UP, bool VA, bool VB, typename OutT>
__global__ void __launch_bounds__(256)
conv4_kernel(const __nv_bfloat16* __restrict__ x,
             const __nv_bfloat16* __restrict__ w, OutT* __restrict__ y,
             int n, int h, int wd, int c, int o, int reflect) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BM * LDA;
  float* Cs = reinterpret_cast<float*>(smem);

  const int gh = UP ? h : h / 2;      // the GEMM rows' pixel grid
  const int gw = UP ? wd : wd / 2;
  const int a = UP ? (int)(blockIdx.z >> 1) : 0;
  const int b = UP ? (int)(blockIdx.z & 1) : 0;
  constexpr int TAPS = UP ? 4 : 16;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;   // 0..3: rows wm*32 .. +32
  const int wn = warp % 2;   // 0..1: cols wn*32 .. +32
  const long long m_total = (long long)n * gh * gw;
  const long long m0 = (long long)blockIdx.x * BM;
  const int o0 = blockIdx.y * BN;

  // the A row this thread stages (2 threads per row, 16 channels each)
  const int a_row = tid / 2;
  const int a_col = (tid % 2) * 16;
  const long long pm = m0 + a_row;
  int pn = 0, ph = 0, pw = 0;
  const bool row_ok = pm < m_total;
  if (row_ok) {
    pw = (int)(pm % gw);
    const long long t = pm / gw;
    ph = (int)(t % gh);
    pn = (int)(t / gh);
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int tap = 0; tap < TAPS; ++tap) {
    // source row / column of this thread's A row under this tap, and the
    // tap's kernel position (ky, kx)
    int hs, ws, ky, kx;
    if (UP) {
      const int r = tap / 2, q = tap % 2;
      hs = pad_index(ph + a + r - 1, h, false);
      ws = pad_index(pw + b + q - 1, wd, false);
      ky = a + 2 * r;
      kx = b + 2 * q;
    } else {
      ky = tap / 4;
      kx = tap % 4;
      hs = pad_index(2 * ph + ky - 1, h, reflect);
      ws = pad_index(2 * pw + kx - 1, wd, reflect);
    }
    long long src = -1;   // -1: a zero of the padding
    if (row_ok && hs >= 0 && ws >= 0)
      src = (((long long)pn * h + hs) * wd + ws) * c;
    const __nv_bfloat16* wt = w + (size_t)(ky * 4 + kx) * c * o;
    for (int c0 = 0; c0 < c; c0 += BK) {
      // ---- stage A: [BM, BK] tap rows ----
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

  // ---- epilogue: accumulators -> shared -> OutT, coalesced along O ----
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
    if (pmo >= m_total || oc >= o) continue;
    long long dst = pmo;   // down4: the output grid is the GEMM grid
    if (UP) {              // convt4: pixel (2t + a, 2s + b) of [N, 2H, 2W]
      const int s = (int)(pmo % gw);
      const long long t2 = pmo / gw;
      const int t = (int)(t2 % gh);
      const long long nn = t2 / gh;
      dst = (nn * 2 * h + 2 * t + a) * 2 * wd + 2 * s + b;
    }
    store_out(y + dst * o + oc, Cs[r * LDC + col]);
  }
}

template <bool UP, typename OutT>
int launch(const void* x, const void* w, void* y, int n, int h, int wd,
           int c, int o, int reflect, cudaStream_t stream) {
  const long long m = UP ? (long long)n * h * wd
                         : (long long)n * (h / 2) * (wd / 2);
  if (n < 1 || c < 1 || o < 1 || m < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)((o + BN - 1) / BN),
            UP ? 4 : 1);
  auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* wp = static_cast<const __nv_bfloat16*>(w);
  auto* yp = static_cast<OutT*>(y);
  // 16-byte staging needs rows of 8-element multiples
  const bool va = c % 8 == 0, vb = o % 8 == 0;
  if (va && vb)
    conv4_kernel<UP, true, true, OutT><<<grid, 256, 0, stream>>>(xp, wp, yp, n, h, wd, c, o, reflect);
  else if (va)
    conv4_kernel<UP, true, false, OutT><<<grid, 256, 0, stream>>>(xp, wp, yp, n, h, wd, c, o, reflect);
  else if (vb)
    conv4_kernel<UP, false, true, OutT><<<grid, 256, 0, stream>>>(xp, wp, yp, n, h, wd, c, o, reflect);
  else
    conv4_kernel<UP, false, false, OutT><<<grid, 256, 0, stream>>>(xp, wp, yp, n, h, wd, c, o, reflect);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rnr_down4(const void* x, const void* w, void* y, int n, int h,
                         int wd, int c, int o, int reflect,
                         cudaStream_t stream) {
  return launch<false, __nv_bfloat16>(x, w, y, n, h, wd, c, o, reflect, stream);
}

// down4 with an f32 output: convt4's data gradient (zero padding).
extern "C" int rnr_down4_f32out(const void* x, const void* w, void* y, int n,
                                int h, int wd, int c, int o, int reflect,
                                cudaStream_t stream) {
  return launch<false, float>(x, w, y, n, h, wd, c, o, reflect, stream);
}

extern "C" int rnr_convt4(const void* x, const void* w, void* y, int n, int h,
                          int wd, int c, int o, cudaStream_t stream) {
  return launch<true, __nv_bfloat16>(x, w, y, n, h, wd, c, o, 0, stream);
}

// convt4 with an f32 output: down4's and down4s's data gradient under
// zero padding.
extern "C" int rnr_convt4_f32out(const void* x, const void* w, void* y, int n,
                                 int h, int wd, int c, int o,
                                 cudaStream_t stream) {
  return launch<true, float>(x, w, y, n, h, wd, c, o, 0, stream);
}
