// SH shading of materialised rays, forward (K5) and backward (K5b).  Per
// pixel p and ray r < R: the direction rays_dir[p, :, r] (bf16 or f32,
// widened to f32 and used as it is, not renormalised), the real-SH basis
// up to LMAX, the radiance coeff^T basis, and
//     spec = sum over r < r_spec of rays_lt * radiance * alpha / r_spec
//     diff = sum over r >= r_spec of the same / max(R - r_spec, 1).
// The backward takes gs, gd [N, H, W, 3] and, with gsel = (gs / r_spec or
// gd / r_diff) * alpha per ray, returns
//     d rays_lt[p, r, c] = radiance[c] * gsel[c]        (rays_lt's dtype)
//     d coeff[b, c]      = sum over pixels and rays of basis[b] * rays_lt[c] * gsel[c];
// rays_dir and alpha are G-buffer data and get no gradient.
//
// Replaces: rnr_tpu/ops/sh_pallas.py  sh_shade (:336) / _sh_shade_impl
//   (:234) / _fwd_kernel (:101) and _sh_shade_bwd_impl (:276) /
//   _bwd_kernel (:140), the unfused shading (sh_fan_fuse=False).  The TPU
//   kernels take rays and channels on leading axes ([N, R, 3, H, W], one
//   transpose per tensor in the wrapper) so that a row tile is (rows, W),
//   and contract a VMEM stack of 121 basis planes with coeff on the MXU.
//   Here the NHWC tensors go in as they are: [N, H, W, 3, R] rays_dir and
//   [N, H, W, R, C] rays_lt, one thread per pixel reading its own rays.
//
// Bound on the H100: FP32 ALU, as K1 (sh_fan.cu).  At 512^2, lmax 10 and
//   26 rays the ladder and radiance are about 9 GFLOP against about 89 MB
//   read (rays_dir and rays_lt in bf16, alpha) and 6 MB written.
// Design: K1 without the fan construction.  Forward: one thread per
//   pixel walks its rays, reads each ray's 3 components (stride R apart)
//   and folds the unrolled ladder into three radiance registers with
//   coeff in constant memory.  Backward: blocks of 64 pixels, each ray's
//   121 basis values of the block in a [121][65] shared tile, two basis
//   rows per thread dotted with the rays_lt * gsel column, per-block
//   [121, 3] partials summed by a second kernel in block order: d coeff
//   is bitwise the same from run to run, with no atomics (the TPU grid
//   accumulated in sequence).  The shared parts are in sh_common.cuh.

#include "sh_common.cuh"

namespace {

template <int LMAX, typename RT>
__global__ void __launch_bounds__(128)
sh_shade_kernel(const RT* __restrict__ rays_dir,
                const float* __restrict__ alpha,
                const RT* __restrict__ rays_lt, int n_pix, int r_total,
                int r_spec, float* __restrict__ spec,
                float* __restrict__ diff) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pix) return;

  const float al = alpha[p];
  const float inv_spec = 1.f / (float)r_spec;
  const float inv_diff = 1.f / (float)max(r_total - r_spec, 1);
  const RT* rd = rays_dir + (size_t)p * 3 * r_total;
  const RT* lt = rays_lt + (size_t)p * r_total * 3;

  float acc_s[3] = {0.f, 0.f, 0.f}, acc_d[3] = {0.f, 0.f, 0.f};
  for (int r = 0; r < r_total; ++r) {
    const float x = load_lt(rd + r), y = load_lt(rd + r_total + r),
                z = load_lt(rd + 2 * r_total + r);
    float rad[3] = {0.f, 0.f, 0.f};
    sh_ladder<LMAX>(x, y, z, [&](int l, int m, float q, float cm, float sm) {
      fold_radiance(l, m, q, cm, sm, rad);
    });
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

template <int LMAX, typename RT>
__global__ void __launch_bounds__(BWD_THREADS)
sh_shade_bwd_kernel(const RT* __restrict__ rays_dir,
                    const float* __restrict__ alpha,
                    const RT* __restrict__ rays_lt,
                    const float* __restrict__ gs,
                    const float* __restrict__ gd, int n_pix, int r_total,
                    int r_spec, RT* __restrict__ dlt,
                    float* __restrict__ part) {
  constexpr int NB = (LMAX + 1) * (LMAX + 1);
  __shared__ float bs[NB * LDS];          // basis [b][pixel]
  __shared__ float4 lg[BWD_THREADS];      // rays_lt * gsel per pixel

  const int tid = threadIdx.x;
  const int p = blockIdx.x * BWD_THREADS + tid;
  const bool live = p < n_pix;
  // a dead lane shades the direction +z with alpha 0 and contributes zero
  float al = 0.f;
  float g_s[3] = {0.f, 0.f, 0.f}, g_d[3] = {0.f, 0.f, 0.f};
  if (live) {
    al = alpha[p];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      g_s[c] = gs[(size_t)p * 3 + c];
      g_d[c] = gd[(size_t)p * 3 + c];
    }
  }
  const float inv_spec = 1.f / (float)r_spec;
  const float inv_diff = 1.f / (float)max(r_total - r_spec, 1);
  const RT* rd = rays_dir + (size_t)p * 3 * r_total;
  const RT* lt = rays_lt + (size_t)p * r_total * 3;
  RT* dl = dlt + (size_t)p * r_total * 3;

  // this thread's basis rows of d coeff: tid and tid + 64
  float acc0[3] = {0.f, 0.f, 0.f}, acc1[3] = {0.f, 0.f, 0.f};

  for (int r = 0; r < r_total; ++r) {
    float x = 0.f, y = 0.f, z = 1.f;
    if (live) {
      x = load_lt(rd + r);
      y = load_lt(rd + r_total + r);
      z = load_lt(rd + 2 * r_total + r);
    }
    float rad[3] = {0.f, 0.f, 0.f};
    sh_ladder<LMAX>(x, y, z, [&](int l, int m, float q, float cm, float sm) {
      fold_radiance(l, m, q, cm, sm, rad, bs, tid);
    });
    float ltg[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float gsel =
          (r < r_spec ? g_s[c] * inv_spec : g_d[c] * inv_diff) * al;
      if (live) {
        store_lt(dl + r * 3 + c, rad[c] * gsel);
        ltg[c] = load_lt(lt + r * 3 + c) * gsel;
      } else {
        ltg[c] = 0.f;
      }
    }
    lg[tid] = make_float4(ltg[0], ltg[1], ltg[2], 0.f);
    __syncthreads();
    dot_basis_rows<NB>(bs, lg, tid, acc0, acc1);
    __syncthreads();
  }
  store_partial<NB>(part, blockIdx.x, tid, acc0, acc1);
}

template <typename RT>
int launch(int lmax, const RT* rd, const float* alpha, const RT* lt,
           int n_pix, int r_total, int r_spec, float* spec, float* diff,
           cudaStream_t stream) {
  const int blocks = (n_pix + 127) / 128;
  if (blocks == 0) return 0;
#define RNR_SH_CASE(L)                                                      \
  case L:                                                                   \
    sh_shade_kernel<L, RT><<<blocks, 128, 0, stream>>>(                 \
        rd, alpha, lt, n_pix, r_total, r_spec, spec, diff);                 \
    break;
  RNR_SH_SWITCH(RNR_SH_CASE)
#undef RNR_SH_CASE
  return (int)cudaGetLastError();
}

template <typename RT>
int launch_bwd(int lmax, const RT* rd, const float* alpha, const RT* lt,
               const float* gs, const float* gd, int n_pix, int r_total,
               int r_spec, RT* dlt, float* part, float* dcoeff,
               cudaStream_t stream) {
  const int blocks = (n_pix + BWD_THREADS - 1) / BWD_THREADS;
  if (blocks == 0) return 0;
#define RNR_SH_CASE(L)                                                      \
  case L:                                                                   \
    sh_shade_bwd_kernel<L, RT><<<blocks, BWD_THREADS, 0, stream>>>(     \
        rd, alpha, lt, gs, gd, n_pix, r_total, r_spec, dlt, part);          \
    break;
  RNR_SH_SWITCH(RNR_SH_CASE)
#undef RNR_SH_CASE
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n_entry = (lmax + 1) * (lmax + 1) * 3;
  sum_partials<<<n_entry, 256, 0, stream>>>(part, blocks, n_entry, dcoeff);
  return (int)cudaGetLastError();
}

}  // namespace

// rays_dir [n_pix, 3, r_total], alpha [n_pix], rays_lt [n_pix, r_total, 3]
// -> spec, diff [n_pix, 3] f32.  rays_dir and rays_lt share one storage
// type, the model's ray dtype (bf16: 1, f32: 0).  coeff [(lmax+1)^2, 3]
// and ladder [n_ladder] are device pointers, copied to constant memory
// on `stream`.
extern "C" int rnr_sh_shade(const void* rays_dir, const void* alpha,
                            const void* rays_lt, const void* coeff,
                            const void* ladder, void* spec, void* diff,
                            int lmax, int n_ladder, int n_pix, int r_total,
                            int r_spec, int rays_bf16, cudaStream_t stream) {
  if (bad_sh_args(lmax, n_ladder, r_total, r_spec))
    return (int)cudaErrorInvalidValue;
  if (int e = copy_coeff_ladder(coeff, ladder, lmax, n_ladder, stream))
    return e;
  const float* al = static_cast<const float*>(alpha);
  float* s = static_cast<float*>(spec);
  float* d = static_cast<float*>(diff);
  if (rays_bf16) {
    using bf = __nv_bfloat16;
    return launch(lmax, static_cast<const bf*>(rays_dir), al,
                  static_cast<const bf*>(rays_lt), n_pix, r_total, r_spec, s,
                  d, stream);
  }
  return launch(lmax, static_cast<const float*>(rays_dir), al,
                static_cast<const float*>(rays_lt), n_pix, r_total, r_spec, s,
                d, stream);
}

// The backward: gs, gd [n_pix, 3] f32 -> dlt [n_pix, r_total, 3] in the
// rays_lt type and dcoeff [(lmax+1)^2, 3] f32.  `part` is scratch of
// ceil(n_pix / 64) * (lmax+1)^2 * 3 floats (the per-block partials).
extern "C" int rnr_sh_shade_bwd(const void* rays_dir, const void* alpha,
                                const void* rays_lt, const void* coeff,
                                const void* ladder, const void* gs,
                                const void* gd, void* dlt, void* part,
                                void* dcoeff, int lmax, int n_ladder,
                                int n_pix, int r_total, int r_spec,
                                int rays_bf16, cudaStream_t stream) {
  if (bad_sh_args(lmax, n_ladder, r_total, r_spec))
    return (int)cudaErrorInvalidValue;
  if (int e = copy_coeff_ladder(coeff, ladder, lmax, n_ladder, stream))
    return e;
  const float* al = static_cast<const float*>(alpha);
  const float* g_s = static_cast<const float*>(gs);
  const float* g_d = static_cast<const float*>(gd);
  float* pt = static_cast<float*>(part);
  float* dc = static_cast<float*>(dcoeff);
  if (rays_bf16) {
    using bf = __nv_bfloat16;
    return launch_bwd(lmax, static_cast<const bf*>(rays_dir), al,
                      static_cast<const bf*>(rays_lt), g_s, g_d, n_pix,
                      r_total, r_spec, static_cast<bf*>(dlt), pt, dc, stream);
  }
  return launch_bwd(lmax, static_cast<const float*>(rays_dir), al,
                    static_cast<const float*>(rays_lt), g_s, g_d, n_pix,
                    r_total, r_spec, static_cast<float*>(dlt), pt, dc, stream);
}
