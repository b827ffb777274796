// What the two formulations of the U-Net's 4x4 stride-2 pair share: K6
// (csrc/conv4x4.cu: down4 / convt4, conv_backend "pallas") and K8's pair
// (csrc/conv4x4_slab.cu: down4s / convt4s, "p3s4" and "slab").  Both are
// persistent implicit GEMMs on wgmma over TMA bands of 128-byte-swizzled
// rows (csrc/sm90.cuh); they differ in their reduction units and keep
// their own kernel bodies.  Shared here: the tensor maps of x's parity
// planes and of the weights, the epilogue's staging and 16-byte stores,
// the fixed-order sum of split-K partials, and the persistent grid's size.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace conv4 {

using bf16 = __nv_bfloat16;

constexpr int KC = 64;                 // input channels per unit: one row
constexpr int SMEM_LIMIT = 232448;     // a block's shared memory on sm_90

__device__ __forceinline__ int reflect_row(int i, int n) {
  // i in [-1, n]: -1 -> 1, n -> n - 2 (jnp.pad mode="reflect")
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
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

// registers -> a shared f32 tile es (rows of LDC floats): COLS columns of
// a wgmma accumulator, d[off + 4j + v] at row rbase + 8 (v / 2), column
// 8j + 2 (lane % 4) + v % 2 (rbase: the thread's first row; off a
// constant once the caller's loops unroll, so d stays in registers)
template <int COLS, int LDC, int N>
__device__ __forceinline__ void stage_frag(float* es, const float (&d)[N],
                                           int off, int rbase, int lane) {
#pragma unroll
  for (int j = 0; j < COLS / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    *reinterpret_cast<float2*>(es + rbase * LDC + col) =
        make_float2(d[off + 4 * j], d[off + 4 * j + 1]);
    *reinterpret_cast<float2*>(es + (rbase + 8) * LDC + col) =
        make_float2(d[off + 4 * j + 2], d[off + 4 * j + 3]);
  }
}

// the staged tile's `rows` rows of COLS values -> y: row m goes to output
// row dest[m * dstep + dofs] (skipped where -1), columns oc0 ..; 16 bytes
// a thread along O where O's rows are 16-byte multiples, else elementwise
template <typename OutT, int COLS, int LDC>
__device__ __forceinline__ void store_rows(const float* es,
                                           const long long* dest, int dstep,
                                           int dofs, OutT* y, int o, int oc0,
                                           int rows, int tid, int nthreads) {
  constexpr int V = 16 / sizeof(OutT);
  const bool vec = (o * (int)sizeof(OutT)) % 16 == 0;
  for (int e = tid; e < rows * (COLS / V); e += nthreads) {
    const int m = e / (COLS / V), cv = (e % (COLS / V)) * V;
    const long long d = dest[m * dstep + dofs];
    const int oc = oc0 + cv;
    if (d < 0 || oc >= o) continue;
    const float* src = es + m * LDC + cv;
    OutT* dst = y + d * o + oc;
    if (vec) {
      store_vec(dst, src);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (oc + k < o) store_one(dst + k, src[k]);
    }
  }
}

// y[e] = the sum of the splits' partials of e, in split order
template <typename OutT>
__global__ void __launch_bounds__(256)
sum_splits(const float* __restrict__ part, OutT* __restrict__ y,
           long long elems, int splits) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < elems; e += stride) {
    float v = part[e];
    for (int s = 1; s < splits; ++s) v += part[(size_t)s * elems + e];
    store_one(y + e, v);
  }
}

template <typename OutT>
inline int launch_sum_splits(const float* part, OutT* y, long long elems,
                             int splits, cudaStream_t stream) {
  long long blocks = (elems + 255) / 256;
  if (blocks > 4 * 132) blocks = 4 * 132;
  sum_splits<OutT><<<(unsigned)blocks, 256, 0, stream>>>(part, y, elems,
                                                         splits);
  return (int)cudaGetLastError();
}

// x's rows rp, rp + rstep, .. (rstep 1: every row) and columns p, p + 2,
// .. (p = 0 even, 1 odd) as 4 dims (C, W', H', N), boxes (64 channels,
// `cols`, 1, 1), 128-byte swizzle
inline int parity_map(CUtensorMap* map, const void* x, int n, int h, int wd,
                      int c, int rstep, int rp, int p, int cols) {
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)((wd - p + 1) / 2),
                              (cuuint64_t)((h - rp + rstep - 1) / rstep),
                              (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)c * 4,
                                 (cuuint64_t)rstep * wd * c * 2,
                                 (cuuint64_t)h * wd * c * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)cols, 1, 1};
  return sm90::bf16_map(map,
                        static_cast<const bf16*>(x) + ((size_t)rp * wd + p) * c,
                        4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// w [4, 4, C, O8] as 4 dims (O8, C, kx % 2, 2 ky + kx / 2), boxes (64
// outputs, 64 channels, bp, bt): taps (ky, kx) in that order, 8 KB each
inline int weight_map(CUtensorMap* map, const void* w, int c, int o8,
                      int bp, int bt) {
  const cuuint64_t dims[4] = {(cuuint64_t)o8, (cuuint64_t)c, 2, 8};
  const cuuint64_t strides[3] = {(cuuint64_t)o8 * 2, (cuuint64_t)c * o8 * 2,
                                 (cuuint64_t)c * o8 * 4};
  const cuuint32_t box[4] = {64, KC, (cuuint32_t)bp, (cuuint32_t)bt};
  return sm90::bf16_map(map, w, 4, dims, strides, box,
                        CU_TENSOR_MAP_SWIZZLE_128B);
}

// the persistent grid: as many blocks of `kernel` as fit on the card at
// once, at most one a tile (per_sm / per_sm_smem: the caller's cache of
// the occupancy at that shared-memory size); 0 where none fits
template <typename Kernel>
inline long long wave_blocks(Kernel kernel, int threads, int smem,
                             long long tiles, int& per_sm, int& per_sm_smem) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (per_sm_smem != smem) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                  smem);
    per_sm_smem = smem;
  }
  if (sms < 1 || per_sm < 1) return 0;
  return tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm;
}

}  // namespace conv4
