// K8a: the 3x3 stride-1 convolution in the slab formulation, NHWC bf16
// input, HWIO bf16 weights [3, 3, C, O], f32 accumulation, + bias in f32,
// bf16 output (rnr_conv3x3s) or f32 output (rnr_conv3x3s_f32out: the data
// gradient, the same kernel run on the output gradient with rotated,
// io-transposed weights, as conv_pallas.py:1054-1088 runs
// _conv3x3_slab_fwd_impl).  The same function as K3 (csrc/conv3x3.cu).
//
// The slab formulation packs the three input rows of an output row on the
// reduction axis and puts the column shift on the output:
//   Y[j', (dx, o)] = sum_{dy, c} xp[i + dy, j', c] w[dy, dx, c, o]
//                    (packed depth k = dy*C + c, 3C; width 3O)
//   y[i, j] = Y[j, (0, o)] + Y[j + 1, (1, o)] + Y[j + 2, (2, o)] + b[o]
// with xp = x and a ring of 1 (zero, "same", or reflect) and j' over the
// W + 2 slab columns.  The packed band is built from x by index arithmetic
// while it is staged in shared memory: the [N, H, W+2, 3C] slab is never
// written to device memory.
//
// Replaces: rnr_tpu/ops/conv_pallas.py  _conv3x3_slab_fwd_impl (:917) /
//   _slab_kernel (:860), the 3x3 conv of every U-Net level under
//   conv_backend=slab3 and slab.  There XLA builds the slab in HBM at 3x
//   the activation bytes (_make_slab, :892), rounds 3C up to 128 lanes
//   (_slab_kc, :877) and W + 2 up to 8, pads the rows to the tile and
//   falls back to the tap-wise kernel past a 13 MB VMEM tile (:926).  Here
//   the band is staged from x, every shape is taken (any C, O >= 1), no
//   fallback.
//
// Bound on the H100: tensor-core throughput (as K3; the 14 convs of a
//   512^2 frame are about 0.43 TFLOP).
// Design: a block owns R consecutive grid rows x a segment of `seg`
//   output columns (seg = min(W, 64), R = the rows that fit 64 outputs and
//   80 Y rows: each row needs seg + 2) x 64 output channels.  It computes
//   Y [80 (R (seg + 2) used), 192 = (dx, o)] with WMMA bf16 fragments,
//   walking the packed depth band by band in steps of 32 channels (a step
//   never straddles two bands, so a staged group of 8 channels is one
//   16-byte load when C % 8 == 0): each step stages the band's [80, 32]
//   slice (padding applied per Y row) and the weights' [32, 192] slice in
//   shared memory; 12 warps each own one 16-wide column strip of Y (5
//   fragments).  The epilogue stores Y to shared memory in two halves of
//   32 output channels and adds each output's three shifted bands and the
//   bias, coalesced along O.  Single-buffered, without TMA or wgmma: a
//   right, simple first version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int SEG = 64;            // output columns of one block's row segment
constexpr int YR = 80;             // Y rows: R (seg + 2) <= 80, 5 fragments
constexpr int NB = 64;             // output channels per block
constexpr int HB = NB / 2;         // output channels per epilogue half
constexpr int YC = 3 * NB;         // Y columns: (dx, o)
constexpr int WARPS = YC / 16;     // one 16-wide column strip each
constexpr int THREADS = 32 * WARPS;
constexpr int BK = 32;             // packed channels per K step
constexpr int GROUPS = YR * (BK / 8);   // A groups of 8 channels per step
constexpr int LDA = BK + 8;        // bf16 elements; multiple of 8 for WMMA
constexpr int LDB = YC + 8;
constexpr int LDY = 3 * HB + 4;    // f32 elements; multiple of 4 for WMMA

constexpr int SMEM_AB = (YR * LDA + BK * LDB) * 2;
constexpr int SMEM_Y = YR * LDY * 4;
constexpr int SMEM = SMEM_AB > SMEM_Y ? SMEM_AB : SMEM_Y;

static_assert(GROUPS <= THREADS, "one A group per thread");

__device__ __forceinline__ int pad_index(int i, int n, bool reflect) {
  // -1 -> 1 and n -> n-2 under reflect (jnp.pad mode="reflect"); a
  // negative value for "outside" under zero padding
  if (i >= 0 && i < n) return i;
  if (!reflect) return -1;
  return i < 0 ? -i : 2 * n - 2 - i;
}

__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }

template <bool VA, bool VB, typename OutT>
__global__ void __launch_bounds__(THREADS)
slab_kernel(const __nv_bfloat16* __restrict__ x,
            const __nv_bfloat16* __restrict__ w,
            const float* __restrict__ bias, OutT* __restrict__ y, int n,
            int h, int wd, int c, int o, int reflect, int seg, int rows) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + YR * LDA;
  float* Ys = reinterpret_cast<float*>(smem);

  const long long g_rows = (long long)n * h;
  const int o0 = blockIdx.z * NB;
  const int col0 = blockIdx.x * seg;      // first output column
  const long long row0 = (long long)blockIdx.y * rows;
  const int span = seg + 2;               // slab columns col0 .. col0 + seg + 1
  const int used = rows * span;           // Y rows that feed an output

  const int tid = threadIdx.x;
  const int warp = tid / 32;              // Y columns warp*16 .. +16

  // the A group this thread stages: Y row a_m, channels a_k .. a_k + 8
  const int a_m = tid / (BK / 8);
  const int a_k = (tid % (BK / 8)) * 8;
  bool a_ok = tid < GROUPS && a_m < used;
  long long a_img = 0;                    // image n * h of the grid row
  int a_i = 0, a_ws = -1;
  if (a_ok) {
    const int r = a_m / span, u = a_m % span;
    const long long grow = row0 + r;
    const int jp = col0 + u;              // slab column, x column jp - 1
    a_ok = grow < g_rows && jp <= wd + 1;
    if (a_ok) {
      a_img = grow / h * h;
      a_i = (int)(grow % h);
      a_ws = pad_index(jp - 1, wd, reflect);
      a_ok = a_ws >= 0;
    }
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[YR / 16];
#pragma unroll
  for (int i = 0; i < YR / 16; ++i) wmma::fill_fragment(acc[i], 0.f);

  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int dy = 0; dy < 3; ++dy) {
    // x offset of this thread's A row in band dy (-1: padding)
    long long src = -1;
    if (a_ok) {
      const int hs = pad_index(a_i + dy - 1, h, reflect);
      if (hs >= 0) src = ((a_img + hs) * wd + a_ws) * c;
    }
    const __nv_bfloat16* wb = w + (size_t)dy * 3 * c * o;   // w[dy]
    for (int c0 = 0; c0 < c; c0 += BK) {
      // ---- stage A: band dy's [YR, BK] slice ----
      if (tid < GROUPS) {
        __nv_bfloat16* dst = As + a_m * LDA + a_k;
        const int cb = c0 + a_k;
        if (VA && src >= 0 && cb + 8 <= c) {
          *reinterpret_cast<uint4*>(dst) =
              __ldg(reinterpret_cast<const uint4*>(x + src + cb));
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k)
            dst[k] = (src >= 0 && cb + k < c) ? x[src + cb + k] : zero;
        }
      }
      // ---- stage B: [BK, YC], row kk = channel c0 + kk, column (dx, oo) ----
      for (int e = tid; e < BK * (YC / 8); e += THREADS) {
        const int kk = e / (YC / 8), col = (e % (YC / 8)) * 8;
        const int dx = col / NB, ci = c0 + kk, oc = o0 + col % NB;
        __nv_bfloat16* dst = Bs + kk * LDB + col;
        if (VB && ci < c && oc + 8 <= o) {
          *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(
              wb + ((size_t)dx * c + ci) * o + oc));
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k)
            dst[k] = (ci < c && oc + k < o)
                         ? wb[((size_t)dx * c + ci) * o + oc + k] : zero;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Bs + kk * LDB + warp * 16, LDB);
#pragma unroll
        for (int i = 0; i < YR / 16; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::load_matrix_sync(fa, As + i * 16 * LDA + kk, LDA);
          wmma::mma_sync(acc[i], fa, fb, acc[i]);
        }
      }
      __syncthreads();
    }
  }

  // ---- epilogue, per half of the block's output channels: Y -> shared,
  //      each output adds its three shifted bands, then the bias ----
  const int dxw = warp / 4, qw = warp % 4;   // this warp's band, 16-col quarter
  for (int half = 0; half < 2; ++half) {
    if (qw / 2 == half) {
#pragma unroll
      for (int i = 0; i < YR / 16; ++i)
        wmma::store_matrix_sync(Ys + i * 16 * LDY + dxw * HB + (qw % 2) * 16,
                                acc[i], LDY, wmma::mem_row_major);
    }
    __syncthreads();
    for (int e = tid; e < rows * seg * HB; e += THREADS) {
      const int oo = e % HB, ru = e / HB;
      const int r = ru / seg, u = ru % seg;
      const long long grow = row0 + r;
      const int cu = col0 + u, oc = o0 + half * HB + oo;
      if (grow >= g_rows || cu >= wd || oc >= o) continue;
      const int m = r * span + u;
      const float v = Ys[m * LDY + oo] + Ys[(m + 1) * LDY + HB + oo] +
                      Ys[(m + 2) * LDY + 2 * HB + oo];
      store_out(y + (grow * wd + cu) * o + oc, v + bias[oc]);
    }
    __syncthreads();
  }
}

template <typename OutT>
int launch(const void* x, const void* w, const void* bias, void* y, int n,
           int h, int wd, int c, int o, int reflect, cudaStream_t stream) {
  if (n < 1 || h < 1 || wd < 1 || c < 1 || o < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int seg = wd < SEG ? wd : SEG;
  const int r1 = SEG / seg, r2 = YR / (seg + 2);
  const int rows = r1 < r2 ? r1 : r2;
  const long long row_blocks = ((long long)n * h + rows - 1) / rows;
  const int o_tiles = (o + NB - 1) / NB;
  if (row_blocks > 65535 || o_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  dim3 grid((unsigned)((wd + seg - 1) / seg), (unsigned)row_blocks,
            (unsigned)o_tiles);
  auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* wp = static_cast<const __nv_bfloat16*>(w);
  auto* bp = static_cast<const float*>(bias);
  auto* yp = static_cast<OutT*>(y);
  // 16-byte staging: 8 channels of one x pixel, 8 output channels of one
  // weight row
  const bool va = c % 8 == 0, vb = o % 8 == 0;
  if (va && vb)
    slab_kernel<true, true, OutT><<<grid, THREADS, 0, stream>>>(xp, wp, bp, yp, n, h, wd, c, o, reflect, seg, rows);
  else if (va)
    slab_kernel<true, false, OutT><<<grid, THREADS, 0, stream>>>(xp, wp, bp, yp, n, h, wd, c, o, reflect, seg, rows);
  else if (vb)
    slab_kernel<false, true, OutT><<<grid, THREADS, 0, stream>>>(xp, wp, bp, yp, n, h, wd, c, o, reflect, seg, rows);
  else
    slab_kernel<false, false, OutT><<<grid, THREADS, 0, stream>>>(xp, wp, bp, yp, n, h, wd, c, o, reflect, seg, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rnr_conv3x3s(const void* x, const void* w, const void* bias,
                            void* y, int n, int h, int wd, int c, int o,
                            int reflect, cudaStream_t stream) {
  return launch<__nv_bfloat16>(x, w, bias, y, n, h, wd, c, o, reflect, stream);
}

// The same conv with an f32 output: the dgrad of conv3x3s (no rounding of
// the data gradient to bf16 before the reflect fold).
extern "C" int rnr_conv3x3s_f32out(const void* x, const void* w,
                                   const void* bias, void* y, int n, int h,
                                   int wd, int c, int o, int reflect,
                                   cudaStream_t stream) {
  return launch<float>(x, w, bias, y, n, h, wd, c, o, reflect, stream);
}
