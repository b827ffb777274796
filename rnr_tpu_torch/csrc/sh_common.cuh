// The parts of the SH shading kernels: K1 / K1b (sh_fan.cu, the fan of
// rays built per pixel) and K5 / K5b (sh_shade.cu, the rays read from a
// materialised rays_dir).  All evaluate the real-SH basis of rnr_tpu's
// _emit_basis (rnr_tpu/ops/sh_pallas.py:42; the orthonormal, csphase=1
// basis of rnr_tpu/ops/sh.py, index l*l + l + m) with the coefficients in
// constant memory, load and store rays_lt in bf16 or f32, and share the
// lmax switch.
//
// K1, K1b and K5 evaluate the scaled ladder (below: azimuth, next_power,
// order_walk, cf, radiance).  For order m the ladder value q(l, m) is K_m
// st^m S(l, m) r(l, m), with r(m, m) = 1, r(m+1, m) = ct and r(l, m) = ct
// r(l-1, m) - k(l, m) r(l-2, m), k = ((l-1)^2 - m^2) / (4 (l-1)^2 - 1): a
// rational literal, so one step is an FMUL and an FFMA.  The factors K_m
// S(l, m) (and sqrt 2 for m > 0) are folded into the coefficients on the
// host (ops/sh_cuda.py fan_basis_scale / fan_coeff), and st^m (cos m phi,
// sin m phi) = T_m is the m-th complex power of T_1 = st (cos phi, sin
// phi).  Directions are used as given (ct = clamp(z, -1, 1), no
// renormalisation); the zero vector (a masked pixel's ray) takes ct = 0,
// st = 1 and T_1 = (1, 0), as rnr_tpu does.  The radiance is folded per
// order: A_m = sum_l coeff'(l, m) r(l, m), B_m likewise for -m, then rad
// += Tc_m A_m + Ts_m B_m.
//
// K5b evaluates the unscaled ladder (sh_ladder, with the ladder constants
// in c_ladder, and fold_radiance per (l, m)) and sums its per-block d
// coeff partials in a fixed order.
//
// Each .cu that includes this header is its own library, with its own
// copy of the constant banks: in sh_shade.cu, K5 copies the scaled
// coefficients into c_coeff and K5b the unscaled ones, each on its
// launch's stream before its kernel, so launches in stream order never
// see each other's values.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// ------------------------------------------------ the scaled ladder

template <int V>
struct IC {
  static constexpr int value = V;
};

// f(IC<B>), f(IC<B+1>), ..., f(IC<E-1>): l and m as compile-time constants.
template <int B, int E, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(IC<B>{});
    static_for<B + 1, E>(f);
  }
}

// k(l, m) of the scaled recurrence
__host__ __device__ constexpr float rec_k(int l, int m) {
  return (float)((double)((l - 1) * (l - 1) - m * m) /
                 (double)(4 * (l - 1) * (l - 1) - 1));
}

// The scaled coefficient of basis (l, m) (m < 0: the sine row), channel c.
template <int L, int M>
__device__ __forceinline__ float cf(int c) {
  return c_coeff[(L * L + L + M) * 3 + c];
}

// The ladder of order M past its diagonal for NP directions at once:
// visit(IC<l>, r(l, M)[NP]) for l = M+1..LMAX (r(M, M) = 1 is the
// caller's).  The NP walks share every coefficient the visit reads.
template <int LMAX, int M, int NP, typename Visit>
__device__ __forceinline__ void order_walk(const float (&ct)[NP],
                                           Visit&& visit) {
  if constexpr (M < LMAX) {
    visit(IC<M + 1>{}, ct);
    float r0[NP], r1[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      r0[i] = 1.f;
      r1[i] = ct[i];
    }
    static_for<M + 2, LMAX + 1>([&](auto lc) {
      constexpr float k = rec_k(decltype(lc)::value, M);
      float rn[NP];
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        rn[i] = fmaf(ct[i], r1[i], -k * r0[i]);
        r0[i] = r1[i];
        r1[i] = rn[i];
      }
      visit(lc, rn);
    });
  }
}

// ct and T_1 = st (cos phi, sin phi) of direction (x, y, z); at the zero
// vector ct = 0 and T_1 = (1, 0).
__device__ __forceinline__ void azimuth(float x, float y, float z, float& ct,
                                        float& t1c, float& t1s) {
  ct = fminf(fmaxf(z, -1.f), 1.f);
  const float st = sqrtf(fmaxf(1.f - ct * ct, 0.f));
  const float r2 = x * x + y * y;
  const float inv = r2 > 0.f ? rsqrtf(r2) : 0.f;
  t1c = r2 > 0.f ? st * (x * inv) : st;
  t1s = st * (y * inv);
}

// T_m from T_{m-1} and T_1
__device__ __forceinline__ void next_power(float& tc, float& ts, float t1c,
                                           float t1s) {
  const float c = tc * t1c - ts * t1s;
  ts = tc * t1s + ts * t1c;
  tc = c;
}

// rad[i] = coeff'^T (r T) of direction i, the whole ladder, for NP
// directions at once.
template <int LMAX, int NP>
__device__ __forceinline__ void radiance(const float (&x)[NP],
                                         const float (&y)[NP],
                                         const float (&z)[NP],
                                         float (&rad)[NP][3]) {
  float ct[NP], t1c[NP], t1s[NP], tc[NP], ts[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    azimuth(x[i], y[i], z[i], ct[i], t1c[i], t1s[i]);
    tc[i] = 1.f;
    ts[i] = 0.f;
  }
  static_for<0, LMAX + 1>([&](auto mc) {
    constexpr int m = decltype(mc)::value;
    float a[NP][3], b[NP][3];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if constexpr (m == 1) {
        tc[i] = t1c[i]; ts[i] = t1s[i];
      } else if constexpr (m > 1) {
        next_power(tc[i], ts[i], t1c[i], t1s[i]);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        a[i][c] = cf<m, m>(c);
        if constexpr (m > 0) b[i][c] = cf<m, -m>(c);
      }
    }
    order_walk<LMAX, m>(ct, [&](auto lc, const float (&r)[NP]) {
      constexpr int l = decltype(lc)::value;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          a[i][c] = fmaf(cf<l, m>(c), r[i], a[i][c]);
          if constexpr (m > 0) b[i][c] = fmaf(cf<l, -m>(c), r[i], b[i][c]);
        }
      }
    });
#pragma unroll
    for (int i = 0; i < NP; ++i) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if constexpr (m == 0) rad[i][c] = a[i][c];
        else rad[i][c] = fmaf(tc[i], a[i][c], fmaf(ts[i], b[i][c], rad[i][c]));
      }
    }
  });
}

// Copy `bytes` (even) between global and shared memory: 16 bytes a
// thread where both ends are 16-byte aligned, 2 bytes for the rest.
__device__ __forceinline__ void copy_rows(void* dst, const void* src,
                                          int bytes, int tid, int nthr) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) &
       15) == 0) {
    const int n16 = bytes >> 4;
    const int4* s = static_cast<const int4*>(src);
    int4* d = static_cast<int4*>(dst);
    for (int i = tid; i < n16; i += nthr) d[i] = s[i];
    done = n16 << 3;
  }
  const unsigned short* s = static_cast<const unsigned short*>(src);
  unsigned short* d = static_cast<unsigned short*>(dst);
  for (int i = done + tid; i < (bytes >> 1); i += nthr) d[i] = s[i];
}

// ---------------------------------------------- the unscaled ladder (K5b)

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

// the launch arguments every SH kernel takes: lmax 1..10, at most
// MAX_RAYS rays, 1 <= r_spec <= R
bool bad_ray_args(int lmax, int r_total, int r_spec) {
  return lmax < 1 || lmax > 10 || r_total > MAX_RAYS || r_spec < 1 ||
         r_spec > r_total;
}

// K5b's: also the ladder table's length
bool bad_sh_args(int lmax, int n_ladder, int r_total, int r_spec) {
  return bad_ray_args(lmax, r_total, r_spec) || n_ladder > MAX_LADDER;
}

// a kernel's dynamic shared memory past the default 48 KB
int set_smem(const void* kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

#define RNR_SH_SWITCH(CASE)                                                 \
  switch (lmax) {                                                           \
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5)                                 \
    CASE(6) CASE(7) CASE(8) CASE(9) CASE(10)                                \
    default:                                                                \
      return (int)cudaErrorInvalidValue;                                    \
  }
