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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_RAYS = 64;
constexpr int MAX_BASIS = 121;          // lmax 10
constexpr int MAX_LADDER = 2 * MAX_BASIS;
constexpr int BWD_THREADS = 64;         // pixels per backward block
constexpr int LDS = BWD_THREADS + 1;    // basis tile row stride (floats)

// Uniform per-launch constants.  Every thread reads the same address at
// the same time, and with compile-time offsets the FMAs take them as
// constant-bank operands: no registers, no shared-memory loads.  The
// entry points copy them in on the launch's stream, so launches in
// stream order never see each other's values.
__constant__ float c_coeff[MAX_BASIS * 3];
__constant__ float c_pivots[MAX_RAYS * 3];
__constant__ float c_ladder[MAX_LADDER];

__device__ __forceinline__ float load_lt(const float* p) { return *p; }
__device__ __forceinline__ float load_lt(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_lt(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_lt(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

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

// The ladder (_emit_basis) of direction (x, y, z): calls
// put(l, m, q, cos(m phi), sin(m phi)) with each associated-Legendre
// value q of order m >= 0, in the order of the ladder-constant table.
// Unrolled, l and m are compile-time constants inside put.
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

constexpr float SQRT2 = 1.4142135623730951f;

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
      if (m == 0) {
        const int i = l * l + l;
#pragma unroll
        for (int c = 0; c < 3; ++c) rad[c] += c_coeff[i * 3 + c] * q;
      } else {
        const float qc = SQRT2 * q * cm, qs = SQRT2 * q * sm;
        const int ic = l * l + l + m, is = l * l + l - m;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          rad[c] += c_coeff[ic * 3 + c] * qc + c_coeff[is * 3 + c] * qs;
      }
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

  // this thread's basis rows of d coeff: b0 = tid, b1 = tid + 64
  const int b0 = tid, b1 = tid + BWD_THREADS;
  float acc0[3] = {0.f, 0.f, 0.f}, acc1[3] = {0.f, 0.f, 0.f};

  for (int r = 0; r < r_total; ++r) {
    float x, y, z;
    fan_ray(tb, vx, vy, vz, al, r, r_spec, x, y, z);
    float rad[3] = {0.f, 0.f, 0.f};
    sh_ladder<LMAX>(x, y, z, [&](int l, int m, float q, float cm, float sm) {
      if (m == 0) {
        const int i = l * l + l;
#pragma unroll
        for (int c = 0; c < 3; ++c) rad[c] += c_coeff[i * 3 + c] * q;
        bs[i * LDS + tid] = q;
      } else {
        const float qc = SQRT2 * q * cm, qs = SQRT2 * q * sm;
        const int ic = l * l + l + m, is = l * l + l - m;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          rad[c] += c_coeff[ic * 3 + c] * qc + c_coeff[is * 3 + c] * qs;
        bs[ic * LDS + tid] = qc;
        bs[is * LDS + tid] = qs;
      }
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
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.x * NB * 3;
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

#define RNR_SH_SWITCH(CASE)                                                 \
  switch (lmax) {                                                           \
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5)                                 \
    CASE(6) CASE(7) CASE(8) CASE(9) CASE(10)                                \
    default:                                                                \
      return (int)cudaErrorInvalidValue;                                    \
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
  return 0;
}

bool bad_args(int lmax, int n_ladder, int r_total, int r_spec) {
  return lmax < 1 || lmax > 10 || r_total > MAX_RAYS ||
         n_ladder > MAX_LADDER || r_spec < 1 || r_spec > r_total;
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
  if (bad_args(lmax, n_ladder, r_total, r_spec))
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
  if (bad_args(lmax, n_ladder, r_total, r_spec))
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
