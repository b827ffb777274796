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
// Design, backward (K5b): K1b's backward on materialised rays, the
//   order-split backward of sh_bwd.cuh (shared with K1b): the orders split
//   between four warps, each keeping its d coeff sums in registers, chunks
//   of 4 rays x 64 pixels with one barrier each, d rays_lt staged and
//   written with 16-byte stores, per-block partials summed in block order
//   (bitwise the same from run to run, no atomics).  Its build step
//   (StoredRays) reads each direction from the block's rays_dir rows,
//   copied to shared memory with 16-byte loads beside its rays_lt rows, as
//   in K5.  With both tensors' rows and every even power staged, a block
//   would take 77 KB at bf16 and 13 + 13 rays, over the 75 KB that three
//   blocks an SM allow, so a chunk stores the even powers up to T_8 and
//   the walk of order 9 or 10 takes T_m from T_8 by the build's own chain
//   of complex products: 73 KB, three blocks an SM (f32 rows: two).

#include "sh_common.cuh"
#include "sh_bwd.cuh"

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

// K5b's build step: each direction as stored in the block's rays_dir rows
// ([3, R] per pixel, widened, not renormalised); a dead pixel takes the
// zero vector.
template <typename RT>
struct StoredRays {
  static constexpr int PX_FIELDS = 0;
  static constexpr bool DIR_ROWS = true;
  __host__ __device__ static constexpr int powers(int lmax) {
    return lmax / 2 < 4 ? lmax / 2 : 4;
  }
  const RT* rays_dir;
  int r_total;
  struct Pixel {
    const RT* rd;
    bool live;
  };

  __device__ __forceinline__ void stage(float*, void* dirs, int p0,
                                        int np) const {
    const int row = 3 * r_total;
    copy_rows(dirs, rays_dir + (size_t)p0 * row, np * row * (int)sizeof(RT),
              threadIdx.x, FAN_BWD_THREADS);
  }

  __device__ __forceinline__ Pixel pixel(const float*, const void* dirs,
                                         int p, int np) const {
    return {static_cast<const RT*>(dirs) + p * 3 * r_total, p < np};
  }

  __device__ __forceinline__ void ray(const Pixel& q, int r, bool, float& x,
                                      float& y, float& z) const {
    x = y = z = 0.f;
    if (q.live) {
      x = load_lt(q.rd + r);
      y = load_lt(q.rd + r_total + r);
      z = load_lt(q.rd + 2 * r_total + r);
    }
  }
};

template <int LMAX, typename RT>
__global__ void __launch_bounds__(FAN_BWD_THREADS, 3)
sh_shade_bwd_kernel(const RT* __restrict__ rays_dir,
                    const float* __restrict__ alpha,
                    const RT* __restrict__ rays_lt,
                    const float* __restrict__ gs,
                    const float* __restrict__ gd, int n_pix, int r_total,
                    int r_spec, RT* __restrict__ dlt,
                    float* __restrict__ part) {
  extern __shared__ __align__(16) float sm[];
  order_split_bwd<LMAX>(sm, StoredRays<RT>{rays_dir, r_total}, alpha,
                        rays_lt, gs, gd, n_pix, r_total, r_spec, dlt, part);
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
               int r_spec, RT* dlt, float* part, const float* scale,
               float* dcoeff, cudaStream_t stream) {
  const int blocks = (n_pix + FAN_BWD_PIXELS - 1) / FAN_BWD_PIXELS;
  if (blocks == 0) return 0;
  const int smem =
      bwd_smem<StoredRays<RT>>(lmax, r_total, (int)sizeof(RT)).total_bytes;
#define RNR_SH_CASE(L)                                                      \
  case L:                                                                   \
    if (int e = set_smem((const void*)sh_shade_bwd_kernel<L, RT>, smem))   \
      return e;                                                             \
    sh_shade_bwd_kernel<L, RT><<<blocks, FAN_BWD_THREADS, smem, stream>>>(  \
        rd, alpha, lt, gs, gd, n_pix, r_total, r_spec, dlt, part);          \
    break;
  RNR_SH_SWITCH(RNR_SH_CASE)
#undef RNR_SH_CASE
  return sum_partials_after(blocks, lmax, part, scale, dcoeff, stream);
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
// rays_lt type and dcoeff [(lmax+1)^2, 3] f32.  coeff holds the scaled
// coefficients, as for the forward, and `scale` [(lmax+1)^2] their basis
// scale; `part` is scratch of n_part floats, at least
// rnr_sh_shade_fan_bwd_partials(n_pix, lmax) of sh_fan.cu
// (ops/sh_cuda.py fan_bwd_partials).
extern "C" int rnr_sh_shade_bwd(const void* rays_dir, const void* alpha,
                                const void* rays_lt, const void* coeff,
                                const void* scale, const void* gs,
                                const void* gd, void* dlt, void* part,
                                void* dcoeff, int lmax, int n_pix,
                                int r_total, int r_spec, int rays_bf16,
                                int n_part, cudaStream_t stream) {
  if (bad_ray_args(lmax, r_total, r_spec) ||
      n_part < bwd_partials(n_pix, lmax))
    return (int)cudaErrorInvalidValue;
  const int nb = (lmax + 1) * (lmax + 1);
  if (cudaError_t e = cudaMemcpyToSymbolAsync(
          c_coeff, coeff, nb * 3 * sizeof(float), 0,
          cudaMemcpyDeviceToDevice, stream))
    return (int)e;
  const float* al = static_cast<const float*>(alpha);
  const float* g_s = static_cast<const float*>(gs);
  const float* g_d = static_cast<const float*>(gd);
  const float* sc = static_cast<const float*>(scale);
  float* pt = static_cast<float*>(part);
  float* dc = static_cast<float*>(dcoeff);
  if (rays_bf16) {
    using bf = __nv_bfloat16;
    return launch_bwd(lmax, static_cast<const bf*>(rays_dir), al,
                      static_cast<const bf*>(rays_lt), g_s, g_d, n_pix,
                      r_total, r_spec, static_cast<bf*>(dlt), pt, sc, dc,
                      stream);
  }
  return launch_bwd(lmax, static_cast<const float*>(rays_dir), al,
                    static_cast<const float*>(rays_lt), g_s, g_d, n_pix,
                    r_total, r_spec, static_cast<float*>(dlt), pt, sc, dc,
                    stream);
}
