// K8's 4x4 pair: the U-Net's 4x4 stride-2 conv (rnr_down4s) and 4x4
// stride-2 "SAME" transpose conv (rnr_convt4s) in the slab formulation.
// The same two functions as K6 (csrc/conv4x4.cu): NHWC bf16 input, HWIO
// bf16 weights [4, 4, C, O], f32 accumulation, no bias, bf16 output or,
// for the data-gradient use, f32 output (the *_f32out entry points:
// down4s is convt4s's dgrad, conv_pallas.py:1347-1355).
//
// The slab formulation packs rows on the reduction axis and puts the
// column shift on the output:
//   down4s: for column parity p, packed depth k = dy*C + c (4C):
//           Y[u, (q, o)] += sum_k xp[2i + dy, 2(j0 + u) + p, c] w[dy, 2q + p, c, o]
//           y[i, j0 + u] = Y[u, (0, o)] + Y[u + 1, (1, o)]
//           (even taps dx 0/2 and odd taps dx 1/3: two depth-4C products
//           of width 2O, summed in one Y)
//   convt4s: for output parity (a, b), packed depth k = r*C + c (2C):
//           Y[u, (q, o)] = sum_k xq[t + a + r, s0 + b + u, c] w[a + 2r, b + 2q, c, o]
//           y[2t + a, 2(s0 + u) + b] = Y[u, (0, o)] + Y[u + 1, (1, o)]
//           (wcat_ab[r*C + c, q*O + o] = w[2r + a, 2q + b, c, o], :1300)
// with xp = x and a ring of 1 (zero or reflect) and xq = x zero-padded by
// 1, both by index arithmetic: the packed band is built from x while it
// is staged in shared memory, never materialised in device memory.
//
// Replaces: rnr_tpu/ops/conv_pallas.py  _down4s_fwd_impl (:1138) /
//   _down4s_kernel (:1122) and _convt4s_fwd_impl (:1276) /
//   _convt4s_kernel (:1255), the 4x4 pair under conv_backend=p3s4 (and
//   slab).  There XLA builds the slab [N, HO, W+2, 4C] (two [.., 2C]
//   slabs for convt4s) in HBM, splits it into column-parity planes, pads
//   to 8 x 128 and the kernel writes four parity outputs that XLA
//   interleaves; past a VMEM budget it falls back to the tap-wise kernel.
//   Here the band is staged from x, the interleaved output is written
//   directly, and every shape is taken (any C, O >= 1), no fallback.
//
// Bound on the H100: tensor-core throughput (as K6).
// Design: a block owns R consecutive grid rows x a segment of `seg`
//   output columns (seg = min(width, 64), R = the rows that fit 64
//   outputs and 80 Y rows), x 64 output channels (x one parity for
//   convt4s).  It computes Y [80 (R (seg + 1) used), 128 = (q, o)] with
//   WMMA bf16 fragments, walking the packed depth in steps of 32: each
//   step stages the packed band's [80, 32] slice (the rows' seg + 1
//   columns, with padding applied) and the packed weights' [32, 128]
//   slice in shared memory; 8 warps each own one 16-wide column strip of
//   Y (5 fragments).  The epilogue stores Y to shared memory and adds
//   each output's two shifted halves, coalesced along O.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int SEG = 64;      // output columns of one block's row segment
constexpr int YR = 80;       // Y rows: R (seg + 1) <= 80, 5 fragments
constexpr int NB = 64;       // output channels per block
constexpr int YC = 2 * NB;   // Y columns: (q, o)
constexpr int BK = 32;       // packed channels per K step
constexpr int LDA = BK + 8;  // bf16 elements; multiple of 8 for WMMA
constexpr int LDB = YC + 8;
constexpr int LDY = YC + 4;  // f32 elements; multiple of 4 for WMMA

constexpr int SMEM_AB = (YR * LDA + BK * LDB) * 2;
constexpr int SMEM_Y = YR * LDY * 4;
constexpr int SMEM = SMEM_AB > SMEM_Y ? SMEM_AB : SMEM_Y;

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

// UP = false: down4s over the output grid [N, H/2, W/2]; UP = true:
// convt4s over the input grid [N, H, W] for parity (blockIdx.z & 3) = 2a+b.
template <bool UP, bool VA, bool VB, typename OutT>
__global__ void __launch_bounds__(256)
conv4s_kernel(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ w, OutT* __restrict__ y,
              int n, int h, int wd, int c, int o, int reflect, int seg,
              int rows) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + YR * LDA;
  float* Ys = reinterpret_cast<float*>(smem);

  const int gh = UP ? h : h / 2;
  const int gw = UP ? wd : wd / 2;
  const long long g_rows = (long long)n * gh;
  const int par = UP ? (int)(blockIdx.z & 3) : 0;
  const int a = par >> 1, b = par & 1;
  const int o0 = (UP ? (int)(blockIdx.z >> 2) : (int)blockIdx.z) * NB;
  const int col0 = blockIdx.x * seg;
  const long long row0 = (long long)blockIdx.y * rows;
  const int kp = (UP ? 2 : 4) * c;        // packed depth of one product
  const int used = rows * (seg + 1);      // Y rows that feed an output

  const int tid = threadIdx.x;
  const int warp = tid / 32;              // Y columns warp*16 .. +16

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[YR / 16];
#pragma unroll
  for (int i = 0; i < YR / 16; ++i) wmma::fill_fragment(acc[i], 0.f);

  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  // x offset of packed channel k at Y row m (-1: padding or unused row)
  auto a_src = [&](int m, int k, int p) -> long long {
    if (m >= used || k >= kp) return -1;
    const int r = m / (seg + 1), u = m % (seg + 1);
    const long long grow = row0 + r;
    if (grow >= g_rows) return -1;
    const int pn = (int)(grow / gh), pi = (int)(grow % gh);
    const int band = k / c, ch = k % c;   // dy (down) or r (up), channel
    int hs, ws;
    if (UP) {
      hs = pad_index(pi + a + band - 1, h, false);
      ws = pad_index(col0 + u + b - 1, wd, false);
    } else {
      hs = pad_index(2 * pi + band - 1, h, reflect);
      ws = pad_index(2 * (col0 + u) + p - 1, wd, reflect);
    }
    if (hs < 0 || ws < 0) return -1;
    return (((long long)pn * h + hs) * wd + ws) * c + ch;
  };
  // weight offset of packed channel k, Y column (q, oo) (-1: zero)
  auto b_src = [&](int k, int q, int oc, int p) -> long long {
    if (k >= kp || oc >= o) return -1;
    const int band = k / c, ch = k % c;
    const int ky = UP ? a + 2 * band : band;
    const int kx = UP ? b + 2 * q : 2 * q + p;
    return ((long long)(ky * 4 + kx) * c + ch) * o + oc;
  };

  for (int p = 0; p < (UP ? 1 : 2); ++p) {
    for (int k0 = 0; k0 < kp; k0 += BK) {
      // ---- stage A: the packed band's [YR, BK] slice ----
      if (VA) {   // C % 8 == 0: 8 packed channels lie in one band row
        for (int e = tid; e < YR * (BK / 8); e += 256) {
          const int m = e / (BK / 8), kg = (e % (BK / 8)) * 8;
          const long long s = a_src(m, k0 + kg, p);
          uint4 v = make_uint4(0, 0, 0, 0);
          if (s >= 0) v = __ldg(reinterpret_cast<const uint4*>(x + s));
          *reinterpret_cast<uint4*>(As + m * LDA + kg) = v;
        }
      } else {
        for (int e = tid; e < YR * BK; e += 256) {
          const int m = e / BK, kk = e % BK;
          const long long s = a_src(m, k0 + kk, p);
          As[m * LDA + kk] = s >= 0 ? x[s] : zero;
        }
      }
      // ---- stage B: the packed weights' [BK, YC] slice ----
      if (VB) {   // O % 8 == 0: 8 output channels are contiguous
        for (int e = tid; e < BK * (YC / 8); e += 256) {
          const int kk = e / (YC / 8), col = (e % (YC / 8)) * 8;
          const long long s = b_src(k0 + kk, col / NB, o0 + col % NB, p);
          uint4 v = make_uint4(0, 0, 0, 0);
          if (s >= 0) v = __ldg(reinterpret_cast<const uint4*>(w + s));
          *reinterpret_cast<uint4*>(Bs + kk * LDB + col) = v;
        }
      } else {
        for (int e = tid; e < BK * YC; e += 256) {
          const int kk = e / YC, col = e % YC;
          const long long s = b_src(k0 + kk, col / NB, o0 + col % NB, p);
          Bs[kk * LDB + col] = s >= 0 ? w[s] : zero;
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

  // ---- epilogue: Y -> shared; each output adds its two shifted halves ----
#pragma unroll
  for (int i = 0; i < YR / 16; ++i)
    wmma::store_matrix_sync(Ys + i * 16 * LDY + warp * 16, acc[i], LDY,
                            wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < rows * seg * NB; e += 256) {
    const int oo = e % NB, ru = e / NB;
    const int r = ru / seg, u = ru % seg;
    const long long grow = row0 + r;
    const int cu = col0 + u, oc = o0 + oo;
    if (grow >= g_rows || cu >= gw || oc >= o) continue;
    const int m = r * (seg + 1) + u;
    const float v = Ys[m * LDY + oo] + Ys[(m + 1) * LDY + NB + oo];
    long long dst;
    if (UP) {   // pixel (2t + a, 2s + b) of [N, 2H, 2W]
      const long long pn = grow / gh;
      const int t = (int)(grow % gh);
      dst = (pn * 2 * h + 2 * t + a) * 2 * wd + 2 * cu + b;
    } else {
      dst = grow * gw + cu;
    }
    store_out(y + dst * o + oc, v);
  }
}

template <bool UP, typename OutT>
int launch(const void* x, const void* w, void* y, int n, int h, int wd,
           int c, int o, int reflect, cudaStream_t stream) {
  const int gh = UP ? h : h / 2, gw = UP ? wd : wd / 2;
  if (n < 1 || c < 1 || o < 1 || gh < 1 || gw < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int seg = gw < SEG ? gw : SEG;
  const int r1 = SEG / seg, r2 = YR / (seg + 1);
  const int rows = r1 < r2 ? r1 : r2;
  const long long row_blocks = ((long long)n * gh + rows - 1) / rows;
  const int o_tiles = (o + NB - 1) / NB;
  if (row_blocks > 65535 || (long long)o_tiles * (UP ? 4 : 1) > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  dim3 grid((unsigned)((gw + seg - 1) / seg), (unsigned)row_blocks,
            (unsigned)(o_tiles * (UP ? 4 : 1)));
  auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* wp = static_cast<const __nv_bfloat16*>(w);
  auto* yp = static_cast<OutT*>(y);
  // 16-byte staging: 8 packed channels from one band row, 8 output
  // channels of one weight row
  const bool va = c % 8 == 0, vb = o % 8 == 0;
  if (va && vb)
    conv4s_kernel<UP, true, true, OutT><<<grid, 256, 0, stream>>>(xp, wp, yp, n, h, wd, c, o, reflect, seg, rows);
  else if (va)
    conv4s_kernel<UP, true, false, OutT><<<grid, 256, 0, stream>>>(xp, wp, yp, n, h, wd, c, o, reflect, seg, rows);
  else if (vb)
    conv4s_kernel<UP, false, true, OutT><<<grid, 256, 0, stream>>>(xp, wp, yp, n, h, wd, c, o, reflect, seg, rows);
  else
    conv4s_kernel<UP, false, false, OutT><<<grid, 256, 0, stream>>>(xp, wp, yp, n, h, wd, c, o, reflect, seg, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rnr_down4s(const void* x, const void* w, void* y, int n, int h,
                          int wd, int c, int o, int reflect,
                          cudaStream_t stream) {
  return launch<false, __nv_bfloat16>(x, w, y, n, h, wd, c, o, reflect, stream);
}

// down4s with an f32 output: convt4s's data gradient (zero padding).
extern "C" int rnr_down4s_f32out(const void* x, const void* w, void* y,
                                 int n, int h, int wd, int c, int o,
                                 int reflect, cudaStream_t stream) {
  return launch<false, float>(x, w, y, n, h, wd, c, o, reflect, stream);
}

extern "C" int rnr_convt4s(const void* x, const void* w, void* y, int n,
                           int h, int wd, int c, int o, cudaStream_t stream) {
  return launch<true, __nv_bfloat16>(x, w, y, n, h, wd, c, o, 0, stream);
}

extern "C" int rnr_convt4s_f32out(const void* x, const void* w, void* y,
                                  int n, int h, int wd, int c, int o,
                                  cudaStream_t stream) {
  return launch<true, float>(x, w, y, n, h, wd, c, o, 0, stream);
}
