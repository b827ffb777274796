// Fan-fused SH shading, forward (K1) and backward (K1b).  Per pixel: build
// R rays (the first r_spec reflect the tangent-space view direction about
// each pivot and are masked by alpha, the rest are the pivots), take each
// to world space through the pixel's TBN and normalise, evaluate the
// real-SH basis up to LMAX (the orthonormal, csphase=1 ladder of
// rnr_tpu/ops/sh.py, index l*l + l + m), and reduce
//     spec = mean over spec rays of rays_lt * (coeff^T basis) * alpha
//     diff = mean over diffuse rays of the same.
// The backward takes the output gradients gs, gd [N, H, W, 3] and, with
// gsel = (gs / r_spec or gd / r_diff) * alpha per ray, returns
//     d rays_lt[p, r, c] = (coeff^T basis)[c] * gsel[c]   (rays_lt's dtype)
//     d coeff[b, c]      = sum over pixels and rays of basis[b] * rays_lt[c] * gsel[c].
//
// Replaces: rnr_tpu/ops/sh_pallas.py  sh_shade_fan (:692) /
//   _sh_shade_fan_impl (:587) / _fwd_kernel_fan (:456) and
//   _sh_shade_fan_bwd_impl (:632) / _bwd_kernel_fan (:500), with the ray
//   math of _fan_ray (:429) and the ladder of _emit_basis (:42).  The TPU
//   kernels write the 121 basis planes of a row tile to a VMEM stack and
//   contract them with coeff (and, backward, with rays_lt * gsel) on the
//   MXU; the backward adds d coeff across its sequential grid or writes
//   per-tile partials.
//
// Bound on the H100: FP32 issue.  At 512^2, lmax 10 and 26 rays a frame
//   is about 7 M pixel-rays of 121 basis values, each a few f32
//   instructions (the backward about twice as many), against about 60 MB
//   of operands (the backward also writes d rays_lt, about 100 MB).
//
// The basis: the scaled ladder of sh_common.cuh (shared with K5), folded
//   per order into the scaled coefficients.
// Design, forward (K1): a block of 128 pixels, two pixels per thread.
//   The block first copies its rays_lt rows to shared memory with 16-byte
//   loads (one coalesced pass); each thread then loops over the rays and
//   evaluates the whole ladder for both its pixels, unrolled at compile
//   time (l and m are template constants).  The scaled coefficients sit
//   in constant memory; each one the compiler loads (ULDC) serves both
//   pixels' FMAs, which halves the loads that set a quarter of the time
//   with one pixel per thread.
// Design, backward (K1b): the order-split backward of sh_bwd.cuh (shared
//   with K5b), whose build step here makes the fan ray of each pixel-ray
//   from the pixel's TBN, view direction and alpha (FanRays).

#include "sh_common.cuh"
#include "sh_bwd.cuh"

namespace {

constexpr int FWD_NP = 2;               // pixels per forward thread
constexpr int FWD_THREADS = 64;
constexpr int FWD_PIXELS = FWD_THREADS * FWD_NP;   // pixels per block

// The fan's pivots [r_total, 3], uniform per launch like the coefficients
// (c_coeff holds the scaled coefficients coeff'[b][c]).
__constant__ float c_pivots[MAX_RAYS * 3];

// The fan ray r of a pixel in world space (_fan_ray), normalised.
__device__ __forceinline__ void fan_ray(const float* tb, float vx, float vy,
                                        float vz, float al, int r, bool spec,
                                        float& x, float& y, float& z) {
  const float px = c_pivots[r * 3], py = c_pivots[r * 3 + 1],
              pz = c_pivots[r * 3 + 2];
  float tx = px, ty = py, tz = pz;
  if (spec) {
    const float dot = vx * px + vy * py + vz * pz;
    const float rx = 2.f * dot * px - vx;
    const float ry = 2.f * dot * py - vy;
    const float rz = 2.f * dot * pz - vz;
    const float ia = al * rsqrtf(fmaxf(rx * rx + ry * ry + rz * rz, 1e-24f));
    tx = rx * ia; ty = ry * ia; tz = rz * ia;
  }
  x = tb[0] * tx + tb[1] * ty + tb[2] * tz;
  y = tb[3] * tx + tb[4] * ty + tb[5] * tz;
  z = tb[6] * tx + tb[7] * ty + tb[8] * tz;
  const float inv_w = rsqrtf(fmaxf(x * x + y * y + z * z, 1e-24f));
  x *= inv_w; y *= inv_w; z *= inv_w;
}

template <int LMAX, typename LT>
__global__ void __launch_bounds__(FWD_THREADS)
sh_fan_kernel(const float* __restrict__ tbn, const float* __restrict__ vdt,
              const float* __restrict__ alpha, const LT* __restrict__ rays_lt,
              int n_pix, int r_total, int r_spec, float* __restrict__ spec,
              float* __restrict__ diff) {
  extern __shared__ __align__(16) unsigned char smem[];
  LT* lts = reinterpret_cast<LT*>(smem);
  const int row = r_total * 3;   // rays_lt values per pixel
  const int p0 = blockIdx.x * FWD_PIXELS;
  const int np = min(FWD_PIXELS, n_pix - p0);
  copy_rows(lts, rays_lt + (size_t)p0 * row, np * row * (int)sizeof(LT),
            threadIdx.x, FWD_THREADS);
  __syncthreads();
  if ((int)threadIdx.x >= np) return;

  // pixels threadIdx.x + i * FWD_THREADS of the block; a dead one repeats
  // the block's last pixel and is never stored
  float tb[FWD_NP][9], vx[FWD_NP], vy[FWD_NP], vz[FWD_NP], al[FWD_NP];
  const LT* lt[FWD_NP];
#pragma unroll
  for (int i = 0; i < FWD_NP; ++i) {
    const int q = threadIdx.x + i * FWD_THREADS;
    const int p = p0 + min(q, np - 1);
#pragma unroll
    for (int k = 0; k < 9; ++k) tb[i][k] = tbn[(size_t)p * 9 + k];
    vx[i] = vdt[(size_t)p * 3];
    vy[i] = vdt[(size_t)p * 3 + 1];
    vz[i] = vdt[(size_t)p * 3 + 2];
    al[i] = alpha[p];
    lt[i] = lts + min(q, np - 1) * row;
  }

  float acc_s[FWD_NP][3] = {}, acc_d[FWD_NP][3] = {};
  for (int r = 0; r < r_total; ++r) {
    const bool is_spec = r < r_spec;
    float x[FWD_NP], y[FWD_NP], z[FWD_NP];
#pragma unroll
    for (int i = 0; i < FWD_NP; ++i)
      fan_ray(tb[i], vx[i], vy[i], vz[i], al[i], r, is_spec, x[i], y[i],
              z[i]);
    float rad[FWD_NP][3];
    radiance<LMAX>(x, y, z, rad);
#pragma unroll
    for (int i = 0; i < FWD_NP; ++i) {
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
  for (int i = 0; i < FWD_NP; ++i) {
    const int q = threadIdx.x + i * FWD_THREADS;
    if (q >= np) break;
    const size_t p = p0 + q;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      spec[p * 3 + c] = acc_s[i][c] * (al[i] * is);
      diff[p * 3 + c] = acc_d[i][c] * (al[i] * id);
    }
  }
}

// ----------------------------------------------------------- the backward

// K1b's build step: the fan ray of each pixel-ray, from the pixel's TBN,
// tangent view direction and alpha staged field-major (tbn 0-8, vdt 9-11,
// alpha 12); a dead pixel is a finite dummy with alpha 0.
struct FanRays {
  static constexpr int PX_FIELDS = 13;
  static constexpr bool DIR_ROWS = false;
  __host__ __device__ static constexpr int powers(int lmax) {
    return lmax / 2;
  }
  const float* tbn;
  const float* vdt;
  const float* alpha;
  struct Pixel {
    float tb[9], vx, vy, vz, al;
  };

  __device__ __forceinline__ void stage(float* own, void*, int p0,
                                        int np) const {
    const int t = threadIdx.x;
    if (t >= FAN_BWD_PIXELS) return;
    float f[PX_FIELDS] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f,
                          1.f, 0.f, 0.f, 1.f, 0.f};
    const int p = p0 + t;
    if (t < np) {
#pragma unroll
      for (int i = 0; i < 9; ++i) f[i] = __ldg(tbn + (size_t)p * 9 + i);
#pragma unroll
      for (int i = 0; i < 3; ++i) f[9 + i] = __ldg(vdt + (size_t)p * 3 + i);
      f[12] = __ldg(alpha + p);
    }
#pragma unroll
    for (int i = 0; i < PX_FIELDS; ++i) own[i * FAN_BWD_PIXELS + t] = f[i];
  }

  __device__ __forceinline__ Pixel pixel(const float* own, const void*,
                                         int p, int) const {
    Pixel q;
#pragma unroll
    for (int i = 0; i < 9; ++i) q.tb[i] = own[i * FAN_BWD_PIXELS + p];
    q.vx = own[9 * FAN_BWD_PIXELS + p];
    q.vy = own[10 * FAN_BWD_PIXELS + p];
    q.vz = own[11 * FAN_BWD_PIXELS + p];
    q.al = own[12 * FAN_BWD_PIXELS + p];
    return q;
  }

  __device__ __forceinline__ void ray(const Pixel& q, int r, bool spec,
                                      float& x, float& y, float& z) const {
    fan_ray(q.tb, q.vx, q.vy, q.vz, q.al, r, spec, x, y, z);
  }
};

template <int LMAX, typename LT>
__global__ void __launch_bounds__(FAN_BWD_THREADS, 3)
sh_fan_bwd_kernel(const float* __restrict__ tbn, const float* __restrict__ vdt,
                  const float* __restrict__ alpha,
                  const LT* __restrict__ rays_lt, const float* __restrict__ gs,
                  const float* __restrict__ gd, int n_pix, int r_total,
                  int r_spec, LT* __restrict__ dlt, float* __restrict__ part) {
  extern __shared__ __align__(16) float sm[];
  order_split_bwd<LMAX>(sm, FanRays{tbn, vdt, alpha}, alpha, rays_lt, gs, gd,
                        n_pix, r_total, r_spec, dlt, part);
}

template <typename LT>
int launch(int lmax, const float* tbn, const float* vdt, const float* alpha,
           const LT* lt, int n_pix, int r_total, int r_spec, float* spec,
           float* diff, cudaStream_t stream) {
  const int blocks = (n_pix + FWD_PIXELS - 1) / FWD_PIXELS;
  if (blocks == 0) return 0;
  const int smem = FWD_PIXELS * r_total * 3 * (int)sizeof(LT);
#define RNR_SH_CASE(L)                                                      \
  case L:                                                                   \
    if (int e = set_smem((const void*)sh_fan_kernel<L, LT>, smem)) return e; \
    sh_fan_kernel<L, LT><<<blocks, FWD_THREADS, smem, stream>>>(            \
        tbn, vdt, alpha, lt, n_pix, r_total, r_spec, spec, diff);           \
    break;
  RNR_SH_SWITCH(RNR_SH_CASE)
#undef RNR_SH_CASE
  return (int)cudaGetLastError();
}

template <typename LT>
int launch_bwd(int lmax, const float* tbn, const float* vdt,
               const float* alpha, const LT* lt, const float* gs,
               const float* gd, int n_pix, int r_total, int r_spec, LT* dlt,
               float* part, const float* scale, float* dcoeff,
               cudaStream_t stream) {
  const int blocks = (n_pix + FAN_BWD_PIXELS - 1) / FAN_BWD_PIXELS;
  if (blocks == 0) return 0;
  const int smem =
      bwd_smem<FanRays>(lmax, r_total, (int)sizeof(LT)).total_bytes;
#define RNR_SH_CASE(L)                                                      \
  case L:                                                                   \
    if (int e = set_smem((const void*)sh_fan_bwd_kernel<L, LT>, smem))     \
      return e;                                                             \
    sh_fan_bwd_kernel<L, LT><<<blocks, FAN_BWD_THREADS, smem, stream>>>(    \
        tbn, vdt, alpha, lt, gs, gd, n_pix, r_total, r_spec, dlt, part);    \
    break;
  RNR_SH_SWITCH(RNR_SH_CASE)
#undef RNR_SH_CASE
  return sum_partials_after(blocks, lmax, part, scale, dcoeff, stream);
}

int copy_constants(const void* coeff, const void* pivots, int lmax,
                   int r_total, cudaStream_t stream) {
  const int nb = (lmax + 1) * (lmax + 1);
  cudaError_t e;
  if ((e = cudaMemcpyToSymbolAsync(c_coeff, coeff, nb * 3 * sizeof(float), 0,
                                   cudaMemcpyDeviceToDevice, stream)) ||
      (e = cudaMemcpyToSymbolAsync(c_pivots, pivots,
                                   r_total * 3 * sizeof(float), 0,
                                   cudaMemcpyDeviceToDevice, stream)))
    return (int)e;
  return 0;
}

}  // namespace

// Floats of the backward's partials scratch for n_pix pixels at lmax: one
// row of the [(lmax+1)^2 * 3] entries per block of FAN_BWD_PIXELS pixels
// (ops/sh_cuda.py fan_bwd_partials computes the same).
extern "C" int rnr_sh_shade_fan_bwd_partials(int n_pix, int lmax) {
  return bwd_partials(n_pix, lmax);
}

// coeff [(lmax+1)^2, 3] holds the scaled coefficients coeff * scale
// (ops/sh_cuda.py fan_coeff) and pivots [r_total, 3]: device pointers,
// copied to constant memory on `stream`.  lt_bf16 selects the rays_lt
// storage type (1: bf16, 0: f32).
extern "C" int rnr_sh_shade_fan(const void* tbn, const void* vdt,
                                const void* alpha, const void* rays_lt,
                                const void* coeff, const void* pivots,
                                void* spec, void* diff, int lmax, int n_pix,
                                int r_total, int r_spec, int lt_bf16,
                                cudaStream_t stream) {
  if (bad_ray_args(lmax, r_total, r_spec)) return (int)cudaErrorInvalidValue;
  if (int e = copy_constants(coeff, pivots, lmax, r_total, stream)) return e;
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

// The backward: gs, gd [n_pix, 3] f32 -> dlt [n_pix, r_total, 3] in the
// rays_lt type and dcoeff [(lmax+1)^2, 3] f32.  `scale` [(lmax+1)^2] is
// the basis scale of the scaled coefficients; `part` is scratch of n_part
// floats, at least rnr_sh_shade_fan_bwd_partials(n_pix, lmax).
extern "C" int rnr_sh_shade_fan_bwd(const void* tbn, const void* vdt,
                                    const void* alpha, const void* rays_lt,
                                    const void* coeff, const void* pivots,
                                    const void* scale, const void* gs,
                                    const void* gd, void* dlt, void* part,
                                    void* dcoeff, int lmax, int n_pix,
                                    int r_total, int r_spec, int lt_bf16,
                                    int n_part, cudaStream_t stream) {
  if (bad_ray_args(lmax, r_total, r_spec) ||
      n_part < rnr_sh_shade_fan_bwd_partials(n_pix, lmax))
    return (int)cudaErrorInvalidValue;
  if (int e = copy_constants(coeff, pivots, lmax, r_total, stream)) return e;
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  float* pt = static_cast<float*>(part);
  float* dc = static_cast<float*>(dcoeff);
  if (lt_bf16)
    return launch_bwd(lmax, f(tbn), f(vdt), f(alpha),
                      static_cast<const __nv_bfloat16*>(rays_lt), f(gs), f(gd),
                      n_pix, r_total, r_spec,
                      static_cast<__nv_bfloat16*>(dlt), pt, f(scale), dc,
                      stream);
  return launch_bwd(lmax, f(tbn), f(vdt), f(alpha),
                    static_cast<const float*>(rays_lt), f(gs), f(gd), n_pix,
                    r_total, r_spec, static_cast<float*>(dlt), pt, f(scale),
                    dc, stream);
}
