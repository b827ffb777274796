// Mipmap texture gather: for each pixel, the bilinear sample of every
// level of the neural-texture pyramid at the pixel's uv, summed over the
// levels (models/texture.py's level loop).  Tap semantics are those of
// rnr_tpu/ops/interpolate.py interpolate_bilinear / texture_pallas._taps:
// corner indices clamped to the grid, the weight anchor shifted one texel
// back at the right/bottom edge, weights zero outside [0, S-1]^2.
//
// Replaces: rnr_tpu/ops/texture_pallas.py  gather_taps (:372) /
//   _gather_kernel (:281), called per level by mipmap_sample (:529).  The
//   TPU form bins pixel chunks to 128^2 texture tiles and gathers with
//   one-hot bf16 matmuls (TPU element gathers are slow), falling back to
//   an XLA gather on overflow.  None of that is needed here: the H100
//   gathers directly.  The texture is read in f32, as the JAX model's
//   f32 XLA path does off the TPU (no bf16 rounding of the texture).
//
// Bound on the H100: memory and L2.  At 512^2 with 24 channels and four
//   levels (512^2 .. 64^2, 34 MB of texture, which stays in the 50 MB L2)
//   a frame reads about 100 MB of texels through L2 and writes 25 MB.
// Design: one thread per (pixel, group of 4 channels); neighbouring
//   threads take neighbouring channel groups of one pixel, so each tap
//   is one 96-byte run read as float4 by 6 lanes.  The tap weights are
//   recomputed per thread (a few FLOPs) instead of being shared.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEVELS = 4;

struct Levels {
  const float* tex[MAX_LEVELS];
  int size[MAX_LEVELS];
  int n;
};

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  static __device__ __forceinline__ void add_tap(float* acc, const float* p, float w) {
    acc[0] += p[0] * w;
  }
};
template <>
struct Vec<4> {
  static __device__ __forceinline__ void add_tap(float* acc, const float* p, float w) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    acc[0] += t.x * w; acc[1] += t.y * w; acc[2] += t.z * w; acc[3] += t.w * w;
  }
};

template <int VEC>
__global__ void __launch_bounds__(256)
mipmap_gather_kernel(Levels lv, const float* __restrict__ uv, int n_pix,
                     int ch, int accumulate, float* __restrict__ out) {
  const int groups = ch / VEC;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_pix * groups) return;
  const int p = (int)(t / groups);
  const int c0 = (int)(t % groups) * VEC;
  const float u = uv[2 * (size_t)p], vv = uv[2 * (size_t)p + 1];

  float total[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    total[k] = accumulate ? out[(size_t)p * ch + c0 + k] : 0.f;

  for (int l = 0; l < lv.n; ++l) {
    const int s = lv.size[l];
    const float sm1 = (float)(s - 1);
    // coordinates and weights with explicit rounding (no FMA contraction):
    // a fused multiply-add would shift y by an ulp of up to 511 and move
    // every weight with it; these are the twin's and XLA's roundings
    const float x = __fmul_rn(u, sm1);    // texel coordinates, v flipped
    const float y = __fsub_rn(sm1, __fmul_rn(vv, sm1));
    const float valid =
        (x >= 0.f && x <= sm1 && y >= 0.f && y <= sm1) ? 1.f : 0.f;
    // floor then clamp; the pre-clamp keeps the int conversion defined
    const int xf = (int)floorf(fminf(fmaxf(x, -1.f), (float)s));
    const int yf = (int)floorf(fminf(fmaxf(y, -1.f), (float)s));
    const int x0 = min(max(xf, 0), s - 1), x1 = min(max(x0 + 1, 0), s - 1);
    const int y0 = min(max(yf, 0), s - 1), y1 = min(max(y0 + 1, 0), s - 1);
    const float x0w = (float)(x0 - (x0 == x1 ? 1 : 0));
    const float y0w = (float)(y0 - (y0 == y1 ? 1 : 0));
    const float ax = __fsub_rn((float)x1, x), bx = __fsub_rn(x, x0w);
    const float ay = __fsub_rn((float)y1, y), by = __fsub_rn(y, y0w);
    const float w00 = __fmul_rn(__fmul_rn(ax, ay), valid);
    const float w10 = __fmul_rn(__fmul_rn(ax, by), valid);
    const float w01 = __fmul_rn(__fmul_rn(bx, ay), valid);
    const float w11 = __fmul_rn(__fmul_rn(bx, by), valid);
    const float* tex = lv.tex[l];
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    Vec<VEC>::add_tap(acc, tex + ((size_t)y0 * s + x0) * ch + c0, w00);
    Vec<VEC>::add_tap(acc, tex + ((size_t)y1 * s + x0) * ch + c0, w10);
    Vec<VEC>::add_tap(acc, tex + ((size_t)y0 * s + x1) * ch + c0, w01);
    Vec<VEC>::add_tap(acc, tex + ((size_t)y1 * s + x1) * ch + c0, w11);
#pragma unroll
    for (int k = 0; k < VEC; ++k) total[k] += acc[k];
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) out[(size_t)p * ch + c0 + k] = total[k];
}

}  // namespace

// Up to MAX_LEVELS levels per launch; `accumulate` adds to `out` so a
// caller with more levels launches again.
extern "C" int rnr_mipmap_gather(const void* t0, const void* t1,
                                 const void* t2, const void* t3,
                                 const void* uv, void* out, int s0, int s1,
                                 int s2, int s3, int n_levels, int n_pix,
                                 int ch, int accumulate,
                                 cudaStream_t stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  Levels lv;
  const void* ts[MAX_LEVELS] = {t0, t1, t2, t3};
  const int ss[MAX_LEVELS] = {s0, s1, s2, s3};
  for (int i = 0; i < MAX_LEVELS; ++i) {
    lv.tex[i] = static_cast<const float*>(ts[i]);
    lv.size[i] = ss[i];
  }
  lv.n = n_levels;
  const bool vec4 = (ch % 4) == 0;
  const long long threads = (long long)n_pix * (vec4 ? ch / 4 : ch);
  const int blocks = (int)((threads + 255) / 256);
  if (blocks == 0) return 0;
  if (vec4)
    mipmap_gather_kernel<4><<<blocks, 256, 0, stream>>>(
        lv, static_cast<const float*>(uv), n_pix, ch, accumulate,
        static_cast<float*>(out));
  else
    mipmap_gather_kernel<1><<<blocks, 256, 0, stream>>>(
        lv, static_cast<const float*>(uv), n_pix, ch, accumulate,
        static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
