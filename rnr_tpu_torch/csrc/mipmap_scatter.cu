// Mipmap texture scatter, the backward of csrc/mipmap_gather.cu: for each
// pixel, its output gradient g[p, :] times each bilinear tap weight is
// added into that tap's texel of every level's gradient,
//     dT_l[y, x, :] += w * g[p, :]
// with the tap and clamp rules of rnr_tpu/ops/interpolate.py
// interpolate_bilinear / texture_pallas._taps (corner indices clamped to
// the grid, the weight anchor shifted one texel back at the right/bottom
// edge, weights zero outside [0, S-1]^2).  f32 throughout.
//
// Replaces: rnr_tpu/ops/texture_pallas.py  scatter_taps (:183) /
//   _scatter_kernel (:115), called per level by _mipmap_sample_bwd (:572).
//   The TPU form bins pixel chunks to 128^2 texture tiles and scatters
//   with one-hot bf16 matmuls (a TPU scatter is a serialized loop),
//   falling back to an XLA scatter on overflow.  None of that is needed
//   here: this is the original renderer's f32 atomicAdd scatter, with no
//   bf16 rounding of w * g.
//
// Bound on the H100: atomic throughput, not bytes.  At 512^2 with 24
//   channels and four levels the kernel reads about 27 MB (uv and g) and
//   writes 35 MB of level gradients, about 18 us of memory time; but the
//   pixels outside the object have uv = 0, about half the frame, and all
//   of them land on one corner texel of every level, and the coarse
//   levels (64^2, 128^2) put tens of pixels on each texel.  Atomics on
//   one address serialise.
// Design: one thread per pixel, a warp per 32 neighbouring pixels; per
//   level and tap the lanes that hit the same texel are grouped with
//   __match_any_sync, their w * g are summed with shuffles in a log-step
//   tree (Westphal's reduce-by-key), and only the lowest lane of each
//   group issues the atomicAdd, once per channel.  Taps of weight exactly
//   0 (the uncovered pixels have one nonzero tap of four, off-range
//   pixels none) issue nothing.  The order of the atomics across warps is
//   not fixed, so the f32 sums may differ in the last bits from run to
//   run; within a warp the order is fixed.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEVELS = 4;
constexpr unsigned FULL = 0xffffffffu;

struct Levels {
  float* grad[MAX_LEVELS];
  int size[MAX_LEVELS];
  int n;
};

// Sum x over the lanes of `peers` (this lane's group); the group's lowest
// lane returns the total.  `rank` is this lane's position in the group.
// Every lane of the warp must call it.
__device__ __forceinline__ float reduce_peers(unsigned peers, int rank,
                                              float x) {
  const int lane = threadIdx.x & 31;
  unsigned rest = peers & (0xfffffffeu << lane);   // peers above this lane
  while (__any_sync(FULL, rest)) {
    const int next = __ffs(rest);                  // 1 + lane, 0 if none
    const float t = __shfl_sync(FULL, x, next ? next - 1 : lane);
    if (next) x += t;
    // lanes at odd positions have handed their sum down: drop them
    rest &= ~__ballot_sync(FULL, rank & 1);
    rank >>= 1;
  }
  return x;
}

__global__ void __launch_bounds__(256)
mipmap_scatter_kernel(Levels lv, const float* __restrict__ uv,
                      const float* __restrict__ g, int n_pix, int ch) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool live = p < n_pix;   // dead lanes still take part in the votes
  const float u = live ? uv[2 * (size_t)p] : 0.f;
  const float vv = live ? uv[2 * (size_t)p + 1] : 0.f;
  const float* gp = g + (size_t)p * ch;

  for (int l = 0; l < lv.n; ++l) {
    const int s = lv.size[l];
    const float sm1 = (float)(s - 1);
    // the coordinates and weights of mipmap_gather.cu, rounding for
    // rounding (no FMA contraction)
    const float x = __fmul_rn(u, sm1);
    const float y = __fsub_rn(sm1, __fmul_rn(vv, sm1));
    const float valid =
        (live && x >= 0.f && x <= sm1 && y >= 0.f && y <= sm1) ? 1.f : 0.f;
    const int xf = (int)floorf(fminf(fmaxf(x, -1.f), (float)s));
    const int yf = (int)floorf(fminf(fmaxf(y, -1.f), (float)s));
    const int x0 = min(max(xf, 0), s - 1), x1 = min(max(x0 + 1, 0), s - 1);
    const int y0 = min(max(yf, 0), s - 1), y1 = min(max(y0 + 1, 0), s - 1);
    const float x0w = (float)(x0 - (x0 == x1 ? 1 : 0));
    const float y0w = (float)(y0 - (y0 == y1 ? 1 : 0));
    const float ax = __fsub_rn((float)x1, x), bx = __fsub_rn(x, x0w);
    const float ay = __fsub_rn((float)y1, y), by = __fsub_rn(y, y0w);
    const float wt[4] = {__fmul_rn(__fmul_rn(ax, ay), valid),
                         __fmul_rn(__fmul_rn(ax, by), valid),
                         __fmul_rn(__fmul_rn(bx, ay), valid),
                         __fmul_rn(__fmul_rn(bx, by), valid)};
    const int texel[4] = {y0 * s + x0, y1 * s + x0, y0 * s + x1, y1 * s + x1};
    float* dt = lv.grad[l];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float w = wt[t];
      // a zero-weight tap joins no group: a key no other lane holds
      const int key = w != 0.f ? texel[t] : -1 - lane;
      const unsigned peers = __match_any_sync(FULL, key);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      float* dst = dt + (size_t)texel[t] * ch;
      for (int c = 0; c < ch; ++c) {
        const float v = w != 0.f ? w * gp[c] : 0.f;
        const float sum = reduce_peers(peers, rank, v);
        if (w != 0.f && rank == 0) atomicAdd(dst + c, sum);
      }
    }
  }
}

}  // namespace

// Up to MAX_LEVELS level gradients per launch (each [S_l, S_l, ch] f32,
// zeroed by the caller: the kernel adds into them); a caller with more
// levels launches again.
extern "C" int rnr_mipmap_scatter(void* d0, void* d1, void* d2, void* d3,
                                  const void* uv, const void* g, int s0,
                                  int s1, int s2, int s3, int n_levels,
                                  int n_pix, int ch, cudaStream_t stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  Levels lv;
  void* ds[MAX_LEVELS] = {d0, d1, d2, d3};
  const int ss[MAX_LEVELS] = {s0, s1, s2, s3};
  for (int i = 0; i < MAX_LEVELS; ++i) {
    lv.grad[i] = static_cast<float*>(ds[i]);
    lv.size[i] = ss[i];
  }
  lv.n = n_levels;
  const int blocks = (n_pix + 255) / 256;
  if (blocks == 0) return 0;
  mipmap_scatter_kernel<<<blocks, 256, 0, stream>>>(
      lv, static_cast<const float*>(uv), static_cast<const float*>(g), n_pix,
      ch);
  return static_cast<int>(cudaGetLastError());
}
