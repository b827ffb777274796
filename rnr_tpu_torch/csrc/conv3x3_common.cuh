// Code shared by the 3x3 stride-1 convolutions in both formulations: K3 /
// K3b (conv3x3.cu, conv3x3_wgrad.cu) and K8a / K8b (conv3x3_slab.cu,
// conv3x3_slab_wgrad.cu).  What the formulations share is what they
// compute around their products: reflect's row index, the output rows of
// the reflect data gradient's full correlation, the fold of its ring onto
// dx in ops/conv_cuda.py::_dgrad's order of adds, the epilogue's stores
// and the sum of split-K partials in split order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace conv3 {

using bf16 = __nv_bfloat16;

// the forward kernels' `pad`: zero ring, reflect ring, or the dgrad's full
// correlation (a 2-pixel zero ring, outputs on the (H+2) x (W+2) grid)
constexpr int PAD_REFLECT = 1, PAD_FULL = 2;

__device__ __forceinline__ int reflect(int i, int n) {
  // i in [-1, n]: -1 -> 1, n -> n - 2 (jnp.pad mode="reflect")
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// The output row (of O values) of grid position (row, j) of image img,
// or -1 past the grid's W (+ 2) columns.  Pad 0 / 1: [N, H, W] rows.  Pad
// 2: the N H W rows of dx's interior, then per image the R = 2 (W + 2) +
// 2 H rows of the ring: top, bottom, left, right.
__device__ __forceinline__ long long out_row(int pad, int img, int row, int j,
                                             int n, int h, int wd) {
  if (pad != PAD_FULL) return j < wd ? ((long long)img * h + row) * wd + j : -1;
  if (j >= wd + 2) return -1;
  if (row >= 1 && row <= h && j >= 1 && j <= wd)
    return ((long long)img * h + row - 1) * wd + j - 1;
  const int ring = 2 * (wd + 2) + 2 * h;
  const int k = row == 0 ? j
              : row == h + 1 ? wd + 2 + j
              : j == 0 ? 2 * (wd + 2) + row - 1
                       : 2 * (wd + 2) + h + row - 1;
  return (long long)n * h * wd + (long long)img * ring + k;
}

__device__ __forceinline__ void store_vec(bf16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_one(bf16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }

// dx [N, H, W, C] += the ring of the full correlation, folded by the
// adjoint of reflect-pad: per element, the additions of
// ops/conv_cuda.py::_dgrad in its order (top, bottom, left, right, then
// the four corners).  One thread per channel of each pixel on rows 1 and
// H - 2 and columns 1 and W - 2.
__global__ void __launch_bounds__(256)
fold_ring_kernel(float* __restrict__ dx, const float* __restrict__ ring,
                 int n, int h, int wd, int c) {
  const int rlo = h - 2 < 1 ? h - 2 : 1, rhi = h - 2 < 1 ? 1 : h - 2;
  const int clo = wd - 2 < 1 ? wd - 2 : 1, chi = wd - 2 < 1 ? 1 : wd - 2;
  const int nr = rlo == rhi ? 1 : 2, nc = clo == chi ? 1 : 2;
  const long long per = (long long)nr * wd + (long long)nc * (h - nr);
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= per * n * c) return;
  const int ch = (int)(idx % c);
  const long long t = idx / c;
  const int img = (int)(t / per);
  int l = (int)(t % per), a, b;
  if (l < nr * wd) {
    a = l / wd == 0 ? rlo : rhi;
    b = l % wd;
  } else {
    l -= nr * wd;
    b = l / (h - nr) == 0 ? clo : chi;
    a = l % (h - nr);     // the a-th row outside {rlo, rhi}
    if (a >= rlo) ++a;
    if (nr == 2 && a >= rhi) ++a;
  }
  const long long rr = 2LL * (wd + 2) + 2LL * h;
  const float* rg = ring + (size_t)img * rr * c + ch;
  const float* top = rg;
  const float* bot = rg + (size_t)(wd + 2) * c;
  const float* left = rg + (size_t)(2 * (wd + 2) - 1) * c;       // row i' >= 1
  const float* right = rg + (size_t)(2 * (wd + 2) + h - 1) * c;
  float* p = dx + (((size_t)img * h + a) * wd + b) * c + ch;
  float v = *p;
  if (a == 1) v = __fadd_rn(v, top[(size_t)(b + 1) * c]);
  if (a == h - 2) v = __fadd_rn(v, bot[(size_t)(b + 1) * c]);
  if (b == 1) v = __fadd_rn(v, left[(size_t)(a + 1) * c]);
  if (b == wd - 2) v = __fadd_rn(v, right[(size_t)(a + 1) * c]);
  if (a == 1 && b == 1) v = __fadd_rn(v, top[0]);
  if (a == 1 && b == wd - 2) v = __fadd_rn(v, top[(size_t)(wd + 1) * c]);
  if (a == h - 2 && b == 1) v = __fadd_rn(v, bot[0]);
  if (a == h - 2 && b == wd - 2) v = __fadd_rn(v, bot[(size_t)(wd + 1) * c]);
  *p = v;
}

// After a pad-2 launch into y (N H W + N R rows of O): dx = the first N H
// W rows, += the ring that follows them.
inline int fold_ring(float* y, int n, int h, int wd, int o,
                     cudaStream_t stream) {
  const int nr = h == 3 ? 1 : 2, nc = wd == 3 ? 1 : 2;
  const long long count =
      ((long long)nr * wd + (long long)nc * (h - nr)) * n * o;
  fold_ring_kernel<<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(
      y, y + (size_t)n * h * wd * o, n, h, wd, o);
  return (int)cudaGetLastError();
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

inline int sum_splits(const void* part, void* dw, long long count, int splits,
                      cudaStream_t stream) {
  reduce_splits<<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), count, splits);
  return (int)cudaGetLastError();
}

}  // namespace conv3
