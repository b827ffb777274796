// The parts of the SH shading kernels: K1 / K1b (sh_fan.cu, the fan of
// rays built per pixel) and K5 / K5b (sh_shade.cu, the rays read from a
// materialised rays_dir).  All evaluate the real-SH basis of rnr_tpu's
// _emit_basis (rnr_tpu/ops/sh_pallas.py:42; the orthonormal, csphase=1
// basis of rnr_tpu/ops/sh.py, index l*l + l + m) with the coefficients in
// constant memory, load and store rays_lt in bf16 or f32, and share the
// lmax switch.  The backward's order split, shared by K1b and K5b, is in
// sh_bwd.cuh.
//
// All four evaluate the scaled ladder (below: azimuth, next_power,
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
// Each .cu that includes this header is its own library, with its own
// copy of the constant bank; each entry point copies its scaled
// coefficients into c_coeff on its launch's stream before its kernel, so
// launches in stream order never see each other's values.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_RAYS = 64;
constexpr int MAX_BASIS = 121;          // lmax 10

// Uniform per-launch constants.  Every thread reads the same address at
// the same time, and with compile-time offsets the FMAs take them as
// constant-bank operands: no registers, no shared-memory loads.  The
// entry points copy them in on the launch's stream, so launches in
// stream order never see each other's values.
__constant__ float c_coeff[MAX_BASIS * 3];

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

// the launch arguments every SH kernel takes: lmax 1..10, at most
// MAX_RAYS rays, 1 <= r_spec <= R
bool bad_ray_args(int lmax, int r_total, int r_spec) {
  return lmax < 1 || lmax > 10 || r_total > MAX_RAYS || r_spec < 1 ||
         r_spec > r_total;
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
