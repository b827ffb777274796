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
// Bound on the H100: FP32 ALU.  At 512^2, lmax 10 and 26 rays a frame is
//   about 9 GFLOP of ladder and radiance arithmetic (the backward about
//   14 GFLOP) against 12 floats of geometry, 26 x 3 bf16 of rays_lt and 6
//   floats of output per pixel (about 60 MB; the backward also writes
//   d rays_lt, about 100 MB), so the FMA pipes, not memory, set the time.
// Design, forward: one thread per pixel loops over the rays and rebuilds
//   each in f32.  The ladder is unrolled at compile time (LMAX is a
//   template parameter), and each basis value is folded into three
//   radiance registers as it is emitted: the 121 values are never stored.
//   coeff, the pivots and the ladder constants sit in constant memory:
//   read uniformly at compile-time offsets, they are FMA operands straight
//   from the constant bank (a first version in shared memory let the
//   compiler hoist all 363 coeff values into registers and spill).
// Design, backward: the 121 x 3 d coeff sums cannot live in one thread's
//   registers.  A block of 64 pixels walks the rays together: per ray each
//   thread runs the same ladder as the forward (for the radiance of
//   d rays_lt) and also writes its 121 basis values to a [121][65] shared
//   tile, and rays_lt * gsel to a [64] float4 tile; after a barrier each
//   thread owns basis rows tid and tid + 64 and adds their 64-pixel dot
//   products with the three lt*gsel columns into 6 registers (row stride
//   65 keeps the 32 lanes on 32 banks).  Each block writes its [121, 3]
//   partial; a second kernel adds the partials in block order, so d coeff
//   is bitwise the same from run to run (no atomics).
// The ladder, the constant banks, the radiance fold and the backward's
// basis tile, dot products and partial sum live in sh_common.cuh, shared
// with K5 / K5b (sh_shade.cu).

#include "sh_common.cuh"

namespace {

// The fan's pivots [r_total, 3], uniform per launch like coeff.
__constant__ float c_pivots[MAX_RAYS * 3];

// The fan ray r of a pixel in world space (_fan_ray), normalised.
__device__ __forceinline__ void fan_ray(const float* tb, float vx, float vy,
                                        float vz, float al, int r, int r_spec,
                                        float& x, float& y, float& z) {
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
  x = tb[0] * tx + tb[1] * ty + tb[2] * tz;
  y = tb[3] * tx + tb[4] * ty + tb[5] * tz;
  z = tb[6] * tx + tb[7] * ty + tb[8] * tz;
  const float inv_w = 1.f / fmaxf(sqrtf(x * x + y * y + z * z), 1e-12f);
  x *= inv_w; y *= inv_w; z *= inv_w;
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

  float acc_s[3] = {0.f, 0.f, 0.f}, acc_d[3] = {0.f, 0.f, 0.f};
  const LT* lt = rays_lt + (size_t)p * r_total * 3;

  for (int r = 0; r < r_total; ++r) {
    float x, y, z;
    fan_ray(tb, vx, vy, vz, al, r, r_spec, x, y, z);
    // the ladder, folded into the radiance
    float rad[3] = {0.f, 0.f, 0.f};
    sh_ladder<LMAX>(x, y, z, [&](int l, int m, float q, float cm, float sm) {
      fold_radiance(l, m, q, cm, sm, rad);
    });

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

template <int LMAX, typename LT>
__global__ void __launch_bounds__(BWD_THREADS)
sh_fan_bwd_kernel(const float* __restrict__ tbn, const float* __restrict__ vdt,
                  const float* __restrict__ alpha,
                  const LT* __restrict__ rays_lt, const float* __restrict__ gs,
                  const float* __restrict__ gd, int n_pix, int r_total,
                  int r_spec, LT* __restrict__ dlt, float* __restrict__ part) {
  constexpr int NB = (LMAX + 1) * (LMAX + 1);
  __shared__ float bs[NB * LDS];          // basis [b][pixel]
  __shared__ float4 lg[BWD_THREADS];      // rays_lt * gsel per pixel

  const int tid = threadIdx.x;
  const int p = blockIdx.x * BWD_THREADS + tid;
  const bool live = p < n_pix;
  // a dead lane shades a finite dummy pixel and contributes zero
  float tb[9] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f};
  float vx = 0.f, vy = 0.f, vz = 1.f, al = 0.f;
  float g_s[3] = {0.f, 0.f, 0.f}, g_d[3] = {0.f, 0.f, 0.f};
  if (live) {
#pragma unroll
    for (int i = 0; i < 9; ++i) tb[i] = tbn[(size_t)p * 9 + i];
    vx = vdt[(size_t)p * 3]; vy = vdt[(size_t)p * 3 + 1];
    vz = vdt[(size_t)p * 3 + 2];
    al = alpha[p];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      g_s[c] = gs[(size_t)p * 3 + c];
      g_d[c] = gd[(size_t)p * 3 + c];
    }
  }
  const float inv_spec = 1.f / (float)r_spec;
  const float inv_diff = 1.f / (float)max(r_total - r_spec, 1);
  const LT* lt = rays_lt + (size_t)p * r_total * 3;
  LT* dl = dlt + (size_t)p * r_total * 3;

  // this thread's basis rows of d coeff: tid and tid + 64
  float acc0[3] = {0.f, 0.f, 0.f}, acc1[3] = {0.f, 0.f, 0.f};

  for (int r = 0; r < r_total; ++r) {
    float x, y, z;
    fan_ray(tb, vx, vy, vz, al, r, r_spec, x, y, z);
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
  RNR_SH_SWITCH(RNR_SH_CASE)
#undef RNR_SH_CASE
  return (int)cudaGetLastError();
}

template <typename LT>
int launch_bwd(int lmax, const float* tbn, const float* vdt,
               const float* alpha, const LT* lt, const float* gs,
               const float* gd, int n_pix, int r_total, int r_spec, LT* dlt,
               float* part, float* dcoeff, cudaStream_t stream) {
  const int blocks = (n_pix + BWD_THREADS - 1) / BWD_THREADS;
  if (blocks == 0) return 0;
#define RNR_SH_CASE(L)                                                      \
  case L:                                                                   \
    sh_fan_bwd_kernel<L, LT><<<blocks, BWD_THREADS, 0, stream>>>(           \
        tbn, vdt, alpha, lt, gs, gd, n_pix, r_total, r_spec, dlt, part);    \
    break;
  RNR_SH_SWITCH(RNR_SH_CASE)
#undef RNR_SH_CASE
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n_entry = (lmax + 1) * (lmax + 1) * 3;
  sum_partials<<<n_entry, 256, 0, stream>>>(part, blocks, n_entry, dcoeff);
  return (int)cudaGetLastError();
}

int copy_constants(const void* coeff, const void* pivots, const void* ladder,
                   int lmax, int n_ladder, int r_total, cudaStream_t stream) {
  if (int e = copy_coeff_ladder(coeff, ladder, lmax, n_ladder, stream))
    return e;
  return (int)cudaMemcpyToSymbolAsync(c_pivots, pivots,
                                      r_total * 3 * sizeof(float), 0,
                                      cudaMemcpyDeviceToDevice, stream);
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
  if (bad_sh_args(lmax, n_ladder, r_total, r_spec))
    return (int)cudaErrorInvalidValue;
  if (int e = copy_constants(coeff, pivots, ladder, lmax, n_ladder, r_total,
                             stream))
    return e;
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
// rays_lt type and dcoeff [(lmax+1)^2, 3] f32.  `part` is scratch of
// ceil(n_pix / 64) * (lmax+1)^2 * 3 floats (the per-block partials).
extern "C" int rnr_sh_shade_fan_bwd(const void* tbn, const void* vdt,
                                    const void* alpha, const void* rays_lt,
                                    const void* coeff, const void* pivots,
                                    const void* ladder, const void* gs,
                                    const void* gd, void* dlt, void* part,
                                    void* dcoeff, int lmax, int n_ladder,
                                    int n_pix, int r_total, int r_spec,
                                    int lt_bf16, cudaStream_t stream) {
  if (bad_sh_args(lmax, n_ladder, r_total, r_spec))
    return (int)cudaErrorInvalidValue;
  if (int e = copy_constants(coeff, pivots, ladder, lmax, n_ladder, r_total,
                             stream))
    return e;
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  float* pt = static_cast<float*>(part);
  float* dc = static_cast<float*>(dcoeff);
  if (lt_bf16)
    return launch_bwd(lmax, f(tbn), f(vdt), f(alpha),
                      static_cast<const __nv_bfloat16*>(rays_lt), f(gs), f(gd),
                      n_pix, r_total, r_spec,
                      static_cast<__nv_bfloat16*>(dlt), pt, dc, stream);
  return launch_bwd(lmax, f(tbn), f(vdt), f(alpha),
                    static_cast<const float*>(rays_lt), f(gs), f(gd), n_pix,
                    r_total, r_spec, static_cast<float*>(dlt), pt, dc, stream);
}
