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
//   [N, H, W, R, C] rays_lt, a block's pixels staged row by row.
//
// Bound on the H100: FP32 issue, as K1 (sh_fan.cu).  At 512^2, lmax 10
//   and 26 rays the ladder and radiance are about 9 GFLOP against about
//   89 MB read (rays_dir and rays_lt in bf16, alpha) and 6 MB written.
// Design, forward (K5): K1's forward on materialised rays.  A block of
//   128 pixels first copies its rays_dir and rays_lt rows to shared
//   memory with 16-byte loads, one coalesced pass each (a pixel's
//   rays_dir row is 3 R values, 156 bytes in bf16 at R = 26, in general
//   not 16-byte aligned; a block's rows are); then each thread
//   shades two pixels ray by ray on the scaled ladder of sh_common.cuh,
//   folded per order into the scaled coefficients (ops/sh_cuda.py
//   fan_coeff) in constant memory, so each coefficient load serves both
//   pixels' FMAs.  Measured at 512^2 (chip_variants.py, NVIDIA H100
//   80GB HBM3, 700 W): the ladder alone takes 55% of the kernel's time,
//   without rays_lt's loads 92%, with one pixel a thread 102%, and each
//   thread reading its rays from device memory (2-byte loads 156 bytes
//   apart across a warp) instead of the staged rows 146%.
// Design, backward (K5b): blocks of 64 pixels, each ray's
//   121 basis values of the block in a [121][65] shared tile, two basis
//   rows per thread dotted with the rays_lt * gsel column, per-block
//   [121, 3] partials summed by a second kernel in block order: d coeff
//   is bitwise the same from run to run, with no atomics (the TPU grid
//   accumulated in sequence).  The shared parts are in sh_common.cuh.

#include "sh_common.cuh"

namespace {

constexpr int SHADE_NP = 2;             // pixels per forward thread
constexpr int SHADE_THREADS = 64;
constexpr int SHADE_PIXELS = SHADE_THREADS * SHADE_NP;   // pixels per block

// Shared memory of a forward block: its rays_dir rows, then its rays_lt
// rows (both 3 R values a pixel).
__host__ __device__ constexpr int shade_smem(int r_total, int item) {
  return 2 * SHADE_PIXELS * 3 * r_total * item;
}

template <int LMAX, typename RT>
__global__ void __launch_bounds__(SHADE_THREADS)
sh_shade_kernel(const RT* __restrict__ rays_dir,
                const float* __restrict__ alpha,
                const RT* __restrict__ rays_lt, int n_pix, int r_total,
                int r_spec, float* __restrict__ spec,
                float* __restrict__ diff) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = 3 * r_total;   // values per pixel in either tensor
  RT* rds = reinterpret_cast<RT*>(smem);
  RT* lts = rds + SHADE_PIXELS * row;
  const int p0 = blockIdx.x * SHADE_PIXELS;
  const int np = min(SHADE_PIXELS, n_pix - p0);
  const int bytes = np * row * (int)sizeof(RT);
  copy_rows(rds, rays_dir + (size_t)p0 * row, bytes, threadIdx.x,
            SHADE_THREADS);
  copy_rows(lts, rays_lt + (size_t)p0 * row, bytes, threadIdx.x,
            SHADE_THREADS);
  __syncthreads();
  if ((int)threadIdx.x >= np) return;

  // pixels threadIdx.x + i * SHADE_THREADS of the block; a dead one
  // repeats the block's last pixel and is never stored
  const RT* rd[SHADE_NP];
  const RT* lt[SHADE_NP];
  float al[SHADE_NP];
#pragma unroll
  for (int i = 0; i < SHADE_NP; ++i) {
    const int q = min((int)threadIdx.x + i * SHADE_THREADS, np - 1);
    rd[i] = rds + q * row;
    lt[i] = lts + q * row;
    al[i] = alpha[p0 + q];
  }

  float acc_s[SHADE_NP][3] = {}, acc_d[SHADE_NP][3] = {};
  for (int r = 0; r < r_total; ++r) {
    const bool is_spec = r < r_spec;
    float x[SHADE_NP], y[SHADE_NP], z[SHADE_NP];
#pragma unroll
    for (int i = 0; i < SHADE_NP; ++i) {
      x[i] = load_lt(rd[i] + r);
      y[i] = load_lt(rd[i] + r_total + r);
      z[i] = load_lt(rd[i] + 2 * r_total + r);
    }
    float rad[SHADE_NP][3];
    radiance<LMAX>(x, y, z, rad);
#pragma unroll
    for (int i = 0; i < SHADE_NP; ++i) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float v = load_lt(lt[i] + r * 3 + c) * rad[i][c];
        if (is_spec) acc_s[i][c] += v;
        else acc_d[i][c] += v;
      }
    }
  }
  const float is = 1.f / (float)r_spec;
  const float id = 1.f / (float)max(r_total - r_spec, 1);
#pragma unroll
  for (int i = 0; i < SHADE_NP; ++i) {
    const int q = threadIdx.x + i * SHADE_THREADS;
    if (q >= np) break;
    const size_t p = p0 + q;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      spec[p * 3 + c] = acc_s[i][c] * (al[i] * is);
      diff[p * 3 + c] = acc_d[i][c] * (al[i] * id);
    }
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
  const int blocks = (n_pix + SHADE_PIXELS - 1) / SHADE_PIXELS;
  if (blocks == 0) return 0;
  const int smem = shade_smem(r_total, (int)sizeof(RT));
#define RNR_SH_CASE(L)                                                      \
  case L:                                                                   \
    if (int e = set_smem((const void*)sh_shade_kernel<L, RT>, smem))       \
      return e;                                                             \
    sh_shade_kernel<L, RT><<<blocks, SHADE_THREADS, smem, stream>>>(        \
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
// holds the scaled coefficients coeff * scale (ops/sh_cuda.py
// fan_coeff): a device pointer, copied to constant memory on `stream`.
extern "C" int rnr_sh_shade(const void* rays_dir, const void* alpha,
                            const void* rays_lt, const void* coeff,
                            void* spec, void* diff, int lmax, int n_pix,
                            int r_total, int r_spec, int rays_bf16,
                            cudaStream_t stream) {
  if (bad_ray_args(lmax, r_total, r_spec)) return (int)cudaErrorInvalidValue;
  const int nb = (lmax + 1) * (lmax + 1);
  if (cudaError_t e = cudaMemcpyToSymbolAsync(
          c_coeff, coeff, nb * 3 * sizeof(float), 0,
          cudaMemcpyDeviceToDevice, stream))
    return (int)e;
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
