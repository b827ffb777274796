// Fan-fused SH shading, forward.  Per pixel: build R rays (the first
// r_spec reflect the tangent-space view direction about each pivot and
// are masked by alpha, the rest are the pivots), take each to world space
// through the pixel's TBN and normalise, evaluate the real-SH basis up to
// LMAX (the orthonormal, csphase=1 ladder of rnr_tpu/ops/sh.py, index
// l*l + l + m), and reduce
//     spec = mean over spec rays of rays_lt * (coeff^T basis) * alpha
//     diff = mean over diffuse rays of the same.
//
// Replaces: rnr_tpu/ops/sh_pallas.py  sh_shade_fan (:692) /
//   _sh_shade_fan_impl (:587) / _fwd_kernel_fan (:456), with the ray math
//   of _fan_ray (:429) and the ladder of _emit_basis (:42).  The TPU kernel
//   writes the 121 basis planes of a row tile to a VMEM stack and
//   contracts them with coeff on the MXU.
//
// Bound on the H100: FP32 ALU.  At 512^2, lmax 10 and 26 rays a frame is
//   about 9 GFLOP of ladder and radiance arithmetic against 12 floats of
//   geometry, 26 x 3 bf16 of rays_lt and 6 floats of output per pixel
//   (about 60 MB), so the FMA pipes, not memory, set the time.
// Design: one thread per pixel loops over the rays and rebuilds each in
//   f32.  The ladder is unrolled at compile time (LMAX is a template
//   parameter), and each basis value is folded into three radiance
//   registers as it is emitted: the 121 values are never stored.  coeff,
//   the pivots and the ladder constants sit in constant memory: read
//   uniformly at compile-time offsets, they are FMA operands straight
//   from the constant bank (a first version in shared memory let the
//   compiler hoist all 363 coeff values into registers and spill).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_RAYS = 64;
constexpr int MAX_BASIS = 121;          // lmax 10
constexpr int MAX_LADDER = 2 * MAX_BASIS;

// Uniform per-launch constants.  Every thread reads the same address at
// the same time, and with compile-time offsets the FMAs take them as
// constant-bank operands: no registers, no shared-memory loads.  The
// entry point copies them in on the launch's stream, so launches in
// stream order never see each other's values.
__constant__ float c_coeff[MAX_BASIS * 3];
__constant__ float c_pivots[MAX_RAYS * 3];
__constant__ float c_ladder[MAX_LADDER];

__device__ __forceinline__ float load_lt(const float* p) { return *p; }
__device__ __forceinline__ float load_lt(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <int LMAX, typename LT>
__global__ void __launch_bounds__(128)
sh_fan_kernel(const float* __restrict__ tbn, const float* __restrict__ vdt,
              const float* __restrict__ alpha, const LT* __restrict__ rays_lt,
              int n_pix, int r_total, int r_spec, float* __restrict__ spec,
              float* __restrict__ diff) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pix) return;

  float tb[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) tb[i] = tbn[(size_t)p * 9 + i];
  const float vx = vdt[(size_t)p * 3], vy = vdt[(size_t)p * 3 + 1],
              vz = vdt[(size_t)p * 3 + 2];
  const float al = alpha[p];
  const float inv_spec = 1.f / (float)r_spec;
  const float inv_diff = 1.f / (float)max(r_total - r_spec, 1);
  const float inv_sqrt_4pi = 0.28209479177387814f;
  const float sqrt2 = 1.4142135623730951f;

  float acc_s[3] = {0.f, 0.f, 0.f}, acc_d[3] = {0.f, 0.f, 0.f};
  const LT* lt = rays_lt + (size_t)p * r_total * 3;

  for (int r = 0; r < r_total; ++r) {
    // ---- the fan ray in world space (_fan_ray) ----
    const float px = c_pivots[r * 3], py = c_pivots[r * 3 + 1],
                pz = c_pivots[r * 3 + 2];
    float tx = px, ty = py, tz = pz;
    if (r < r_spec) {
      const float dot = vx * px + vy * py + vz * pz;
      const float rx = 2.f * dot * px - vx;
      const float ry = 2.f * dot * py - vy;
      const float rz = 2.f * dot * pz - vz;
      const float inv = 1.f / fmaxf(sqrtf(rx * rx + ry * ry + rz * rz), 1e-12f);
      const float ia = inv * al;
      tx = rx * ia; ty = ry * ia; tz = rz * ia;
    }
    float x = tb[0] * tx + tb[1] * ty + tb[2] * tz;
    float y = tb[3] * tx + tb[4] * ty + tb[5] * tz;
    float z = tb[6] * tx + tb[7] * ty + tb[8] * tz;
    const float inv_w = 1.f / fmaxf(sqrtf(x * x + y * y + z * z), 1e-12f);
    x *= inv_w; y *= inv_w; z *= inv_w;

    // ---- the ladder (_emit_basis), folded into the radiance ----
    const float ct = fminf(fmaxf(z, -1.f), 1.f);
    const float st = sqrtf(fmaxf(1.f - ct * ct, 0.f));
    const float r2 = x * x + y * y;
    const float inv_rxy = r2 > 0.f ? 1.f / sqrtf(r2) : 0.f;
    const float c1 = r2 > 0.f ? x * inv_rxy : 1.f;
    const float s1 = y * inv_rxy;
    // cos(m phi), sin(m phi) by angle addition, advanced with m
    float cos_m = 1.f, sin_m = 0.f;
    float rad[3] = {0.f, 0.f, 0.f};
    int k = 0;   // position in the ladder-constant table (compile time)
    float q_diag = inv_sqrt_4pi;
#pragma unroll
    for (int m = 0; m <= LMAX; ++m) {
      if (m == 1) {
        cos_m = c1; sin_m = s1;
      } else if (m > 1) {
        const float cn = cos_m * c1 - sin_m * s1;
        sin_m = sin_m * c1 + cos_m * s1;
        cos_m = cn;
      }
      // emit (l, m) and (l, -m) from the Legendre value q
      auto put = [&](int l, float q) {
        if (m == 0) {
          const int i = l * l + l;
#pragma unroll
          for (int c = 0; c < 3; ++c) rad[c] += c_coeff[i * 3 + c] * q;
        } else {
          const float qc = sqrt2 * q * cos_m, qs = sqrt2 * q * sin_m;
          const int ic = l * l + l + m, is = l * l + l - m;
#pragma unroll
          for (int c = 0; c < 3; ++c)
            rad[c] += c_coeff[ic * 3 + c] * qc + c_coeff[is * 3 + c] * qs;
        }
      };
      if (m > 0) q_diag = c_ladder[k++] * st * q_diag;
      put(m, q_diag);
      if (m < LMAX) {
        float q_lm1 = q_diag;
        float q_l = c_ladder[k++] * ct * q_diag;
        put(m + 1, q_l);
#pragma unroll
        for (int l = m + 2; l <= LMAX; ++l) {
          const float a = c_ladder[k++], b = c_ladder[k++];
          const float q_new = a * (ct * q_l - b * q_lm1);
          q_lm1 = q_l;
          q_l = q_new;
          put(l, q_l);
        }
      }
    }

    // ---- reduce into the spec / diff means ----
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float contrib = load_lt(lt + r * 3 + c) * (rad[c] * al);
      if (r < r_spec) acc_s[c] += contrib * inv_spec;
      else acc_d[c] += contrib * inv_diff;
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    spec[(size_t)p * 3 + c] = acc_s[c];
    diff[(size_t)p * 3 + c] = acc_d[c];
  }
}

template <typename LT>
int launch(int lmax, const float* tbn, const float* vdt, const float* alpha,
           const LT* lt, int n_pix, int r_total, int r_spec, float* spec,
           float* diff, cudaStream_t stream) {
  const int blocks = (n_pix + 127) / 128;
  if (blocks == 0) return 0;
#define RNR_SH_CASE(L)                                                      \
  case L:                                                                   \
    sh_fan_kernel<L, LT><<<blocks, 128, 0, stream>>>(                       \
        tbn, vdt, alpha, lt, n_pix, r_total, r_spec, spec, diff);           \
    break;
  switch (lmax) {
    RNR_SH_CASE(1) RNR_SH_CASE(2) RNR_SH_CASE(3) RNR_SH_CASE(4)
    RNR_SH_CASE(5) RNR_SH_CASE(6) RNR_SH_CASE(7) RNR_SH_CASE(8)
    RNR_SH_CASE(9) RNR_SH_CASE(10)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RNR_SH_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// coeff [(lmax+1)^2, 3], pivots [r_total, 3] and ladder [n_ladder] are
// device pointers; they are copied to constant memory on `stream`.
// lt_bf16 selects the rays_lt storage type (1: bf16, 0: f32).
extern "C" int rnr_sh_shade_fan(const void* tbn, const void* vdt,
                                const void* alpha, const void* rays_lt,
                                const void* coeff, const void* pivots,
                                const void* ladder, void* spec, void* diff,
                                int lmax, int n_ladder, int n_pix, int r_total,
                                int r_spec, int lt_bf16, cudaStream_t stream) {
  if (lmax < 1 || lmax > 10 || r_total > MAX_RAYS || n_ladder > MAX_LADDER ||
      r_spec < 1 || r_spec > r_total)
    return (int)cudaErrorInvalidValue;
  const int nb = (lmax + 1) * (lmax + 1);
  cudaError_t e;
  if ((e = cudaMemcpyToSymbolAsync(c_coeff, coeff, nb * 3 * sizeof(float), 0,
                                   cudaMemcpyDeviceToDevice, stream)) ||
      (e = cudaMemcpyToSymbolAsync(c_pivots, pivots,
                                   r_total * 3 * sizeof(float), 0,
                                   cudaMemcpyDeviceToDevice, stream)) ||
      (e = cudaMemcpyToSymbolAsync(c_ladder, ladder, n_ladder * sizeof(float),
                                   0, cudaMemcpyDeviceToDevice, stream)))
    return (int)e;
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  if (lt_bf16)
    return launch(lmax, f(tbn), f(vdt), f(alpha),
                  static_cast<const __nv_bfloat16*>(rays_lt), n_pix, r_total,
                  r_spec, static_cast<float*>(spec), static_cast<float*>(diff),
                  stream);
  return launch(lmax, f(tbn), f(vdt), f(alpha),
                static_cast<const float*>(rays_lt), n_pix, r_total, r_spec,
                static_cast<float*>(spec), static_cast<float*>(diff), stream);
}
