// The parts of the SH shading kernels K5 / K5b (sh_shade.cu, the rays
// read from a materialised rays_dir): the real-SH ladder of rnr_tpu's
// _emit_basis (rnr_tpu/ops/sh_pallas.py:42; the orthonormal, csphase=1
// basis of rnr_tpu/ops/sh.py, index l*l + l + m), the coefficients and
// ladder constants in constant memory, the radiance fold, rays_lt loads
// and stores in bf16 or f32, and the fixed-order sum of the backward's
// per-block d coeff partials.  K1 / K1b (sh_fan.cu) take from it only the
// rays_lt loads and stores, the coefficient bank, MAX_RAYS and the lmax
// switch; their ladder is their own.
//
// Each .cu that includes this header is its own library, with its own
// copy of the constant banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_RAYS = 64;
constexpr int MAX_BASIS = 121;          // lmax 10
constexpr int MAX_LADDER = 2 * MAX_BASIS;
constexpr int BWD_THREADS = 64;         // pixels per backward block
constexpr int LDS = BWD_THREADS + 1;    // basis tile row stride (floats)
constexpr float SQRT2 = 1.4142135623730951f;

// Uniform per-launch constants.  Every thread reads the same address at
// the same time, and with compile-time offsets the FMAs take them as
// constant-bank operands: no registers, no shared-memory loads.  The
// entry points copy them in on the launch's stream, so launches in
// stream order never see each other's values.
__constant__ float c_coeff[MAX_BASIS * 3];
__constant__ float c_ladder[MAX_LADDER];

__device__ __forceinline__ float load_lt(const float* p) { return *p; }
__device__ __forceinline__ float load_lt(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_lt(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_lt(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The ladder (_emit_basis) of direction (x, y, z): calls
// put(l, m, q, cos(m phi), sin(m phi)) with each associated-Legendre
// value q of order m >= 0, in the order of the ladder-constant table.
// Unrolled, l and m are compile-time constants inside put.  At the zero
// vector (a masked pixel's reflected ray) it takes ct = 0, st = 1 and
// the azimuth (1, 0): finite values, as rnr_tpu's ladder gives there.
template <int LMAX, typename Put>
__device__ __forceinline__ void sh_ladder(float x, float y, float z,
                                          Put&& put) {
  const float ct = fminf(fmaxf(z, -1.f), 1.f);
  const float st = sqrtf(fmaxf(1.f - ct * ct, 0.f));
  const float r2 = x * x + y * y;
  const float inv_rxy = r2 > 0.f ? 1.f / sqrtf(r2) : 0.f;
  const float c1 = r2 > 0.f ? x * inv_rxy : 1.f;
  const float s1 = y * inv_rxy;
  // cos(m phi), sin(m phi) by angle addition, advanced with m
  float cos_m = 1.f, sin_m = 0.f;
  int k = 0;   // position in the ladder-constant table (compile time)
  float q_diag = 0.28209479177387814f;   // 1 / sqrt(4 pi)
#pragma unroll
  for (int m = 0; m <= LMAX; ++m) {
    if (m == 1) {
      cos_m = c1; sin_m = s1;
    } else if (m > 1) {
      const float cn = cos_m * c1 - sin_m * s1;
      sin_m = sin_m * c1 + cos_m * s1;
      cos_m = cn;
    }
    if (m > 0) q_diag = c_ladder[k++] * st * q_diag;
    put(m, m, q_diag, cos_m, sin_m);
    if (m < LMAX) {
      float q_lm1 = q_diag;
      float q_l = c_ladder[k++] * ct * q_diag;
      put(m + 1, m, q_l, cos_m, sin_m);
#pragma unroll
      for (int l = m + 2; l <= LMAX; ++l) {
        const float a = c_ladder[k++], b = c_ladder[k++];
        const float q_new = a * (ct * q_l - b * q_lm1);
        q_lm1 = q_l;
        q_l = q_new;
        put(l, m, q_l, cos_m, sin_m);
      }
    }
  }
}

// radiance += coeff^T basis for the basis values of (l, m) and (l, -m),
// built from the ladder value q; when bs is given, also writes them to
// column tid of the backward's [b][pixel] basis tile.
__device__ __forceinline__ void fold_radiance(int l, int m, float q,
                                              float cm, float sm,
                                              float (&rad)[3],
                                              float* bs = nullptr,
                                              int tid = 0) {
  if (m == 0) {
    const int i = l * l + l;
#pragma unroll
    for (int c = 0; c < 3; ++c) rad[c] += c_coeff[i * 3 + c] * q;
    if (bs) bs[i * LDS + tid] = q;
  } else {
    const float qc = SQRT2 * q * cm, qs = SQRT2 * q * sm;
    const int ic = l * l + l + m, is = l * l + l - m;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      rad[c] += c_coeff[ic * 3 + c] * qc + c_coeff[is * 3 + c] * qs;
    if (bs) {
      bs[ic * LDS + tid] = qc;
      bs[is * LDS + tid] = qs;
    }
  }
}

// The d coeff partial of one backward block: after the barrier that
// completes the [NB][LDS] basis tile bs and the rays_lt * gsel tile lg
// of its 64 pixels, each thread adds the 64-pixel dot products of its
// two basis rows (tid and tid + 64) with the three lt*gsel columns.
template <int NB>
__device__ __forceinline__ void dot_basis_rows(const float* bs,
                                               const float4* lg, int tid,
                                               float (&acc0)[3],
                                               float (&acc1)[3]) {
  const int b0 = tid, b1 = tid + BWD_THREADS;
  if (b0 < NB) {
    const float* row = bs + b0 * LDS;
#pragma unroll 8
    for (int q = 0; q < BWD_THREADS; ++q) {
      const float v = row[q];
      const float4 w = lg[q];
      acc0[0] += v * w.x; acc0[1] += v * w.y; acc0[2] += v * w.z;
    }
  }
  if (b1 < NB) {
    const float* row = bs + b1 * LDS;
#pragma unroll 8
    for (int q = 0; q < BWD_THREADS; ++q) {
      const float v = row[q];
      const float4 w = lg[q];
      acc1[0] += v * w.x; acc1[1] += v * w.y; acc1[2] += v * w.z;
    }
  }
}

// Write a backward block's [NB, 3] partial: rows tid and tid + 64.
template <int NB>
__device__ __forceinline__ void store_partial(float* part, int block,
                                              int tid, const float (&acc0)[3],
                                              const float (&acc1)[3]) {
  float* out = part + (size_t)block * NB * 3;
  const int b0 = tid, b1 = tid + BWD_THREADS;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (b0 < NB) out[b0 * 3 + c] = acc0[c];
    if (b1 < NB) out[b1 * 3 + c] = acc1[c];
  }
}

// dcoeff[e] = sum over blocks k of part[k][e]: one block per entry, a
// fixed strided split over 256 threads and a fixed tree (deterministic).
__global__ void __launch_bounds__(256)
sum_partials(const float* __restrict__ part, int n_part, int n_entry,
             float* __restrict__ out) {
  __shared__ float red[256];
  const int e = blockIdx.x;
  float s = 0.f;
  for (int k = threadIdx.x; k < n_part; k += 256)
    s += part[(size_t)k * n_entry + e];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = 128; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[e] = red[0];
}

// coeff [(lmax+1)^2, 3] and the ladder table [n_ladder]: device pointers
// copied to constant memory on `stream`.
int copy_coeff_ladder(const void* coeff, const void* ladder, int lmax,
                      int n_ladder, cudaStream_t stream) {
  const int nb = (lmax + 1) * (lmax + 1);
  cudaError_t e;
  if ((e = cudaMemcpyToSymbolAsync(c_coeff, coeff, nb * 3 * sizeof(float), 0,
                                   cudaMemcpyDeviceToDevice, stream)) ||
      (e = cudaMemcpyToSymbolAsync(c_ladder, ladder, n_ladder * sizeof(float),
                                   0, cudaMemcpyDeviceToDevice, stream)))
    return (int)e;
  return 0;
}

bool bad_sh_args(int lmax, int n_ladder, int r_total, int r_spec) {
  return lmax < 1 || lmax > 10 || r_total > MAX_RAYS ||
         n_ladder > MAX_LADDER || r_spec < 1 || r_spec > r_total;
}

}  // namespace

#define RNR_SH_SWITCH(CASE)                                                 \
  switch (lmax) {                                                           \
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5)                                 \
    CASE(6) CASE(7) CASE(8) CASE(9) CASE(10)                                \
    default:                                                                \
      return (int)cudaErrorInvalidValue;                                    \
  }
