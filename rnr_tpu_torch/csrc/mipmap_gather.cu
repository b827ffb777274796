// Mipmap texture gather: for each pixel, the bilinear sample of every
// level of the neural-texture pyramid at the pixel's uv, summed over the
// levels (models/texture.py's level loop), with the taps of
// csrc/mipmap_common.cuh (shared with the backward, mipmap_scatter.cu).
//
// Replaces: rnr_tpu/ops/texture_pallas.py  gather_taps (:372) /
//   _gather_kernel (:281), called per level by mipmap_sample (:529).  The
//   TPU form bins pixel chunks to 128^2 texture tiles and gathers with
//   one-hot bf16 matmuls (TPU element gathers are slow), falling back to
//   an XLA gather on overflow.  None of that is needed here: the H100
//   gathers directly.  The texture is read in f32, as the JAX model's
//   f32 XLA path does off the TPU (no bf16 rounding of the texture).
//
// Bound on the H100: bytes.  At 512^2 with 24 channels and four levels
//   (512^2 .. 64^2) on the synthetic G-buffer, the floor is uv (2.1 MB),
//   the output (25.2 MB) and the texels that the taps address, of weight
//   0 or not (141,204 of 348,160, 13.6 MB): 40.8 MB, 0.0122 ms at 3.35
//   TB/s.  Charging every texel of every level instead gives 60.7 MB,
//   0.0181 ms, no floor (chip_variants.gather_counts).  The taps ask for
//   16 x 96 B a pixel, 403 MB a frame from L1: the reuse between
//   neighbouring pixels' taps is caught on the SM, and the request rate
//   through L1 is what the time follows.
//
// Design: a warp owns a tile of TW x TH = 8 x 4 pixels of one image; the
//   block is WX x WY = 2 x 4 such warps, and no warp waits for another.
//   One lane per pixel works out each level's four taps once (the
//   coordinates by __fmul_rn / __fsub_rn, no FMA contraction;
//   csrc/mipmap_common.cuh) and keeps them in registers: the 00 texel
//   with two bits for the clamped 10 / 01 steps, and the four weights.
//   Then the lanes take the tile's (pixel, 4 channels) items in pixel
//   order, 32 at a time, so that 6 neighbouring lanes read a tap's 96
//   bytes as float4; each lane takes its item's taps from the pixel's lane
//   by five shuffles a level, sums the levels in registers and stores the
//   item once, along the tile's rows (a row of 8 pixels is 768
//   contiguous bytes), with streaming stores (__stcs: the output is not
//   read again here, the texture stays in L2).  A tap of weight 0 is read
//   and multiplied all the same, as in the plain version (a NaN texel
//   gives NaN).  Channels past VEC * WINDOW take more blocks
//   (blockIdx.y); C % 4 != 0 or unaligned bases take the scalar path.
//   No texel is staged in shared memory: a design that copied each
//   level's box of a tile's taps there (at most 32 texels, outlying taps
//   read from device memory) was 2-2.5 times slower on every case
//   (PERF.md, Findings), as the boxes took L1's room and warps and their
//   copies added to the requests they replaced.
//
// Measured (chip_variants.py --kernels K2, NVIDIA H100 80GB HBM3, 700 W;
//   us a call, 20 calls of the C entry queued; G-buffer case, b2, all
//   pixels on the corner texel): real 31.22, 56.60, 25.03, against the
//   first design (one thread per (pixel, 4 channels) recomputing its
//   pixel's taps on 1-D rows) 43.14, 78.84, 38.45 in the same call; no
//   output stores 27.72; no texel reads 15.92 (the time follows the L1
//   requests); plain stores 34.36; 32 x 1 tiles 32.64; 4 x 8 and 16 x 2
//   tiles 31.48 and 31.37; 4, 16 and 32 warps a block 31.03, 31.49,
//   32.56.
//
// Exactness: each level's four taps are summed as acc += t * w in the
//   order 00, 10, 01, 11 (FMAs), then total += acc in level order, as
//   the first design did, so the output is the first design's bit for
//   bit; there are no atomics, so two runs agree bit for bit.

#include <cuda_runtime.h>

#include "mipmap_common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TW = 8, TH = 4;          // a warp's pixel tile
constexpr int WX = 2, WY = 4;          // the block's warps across and down
constexpr int WARPS = WX * WY;
constexpr int WINDOW = 8;              // groups of VEC channels a block takes

static_assert(TW * TH == 32, "a warp's tile is 32 pixels");

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  static __device__ __forceinline__ float ld(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ void add(float* acc, float t, float w) {
    acc[0] += t * w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    __stcs(p, v[0]);
  }
};
template <>
struct Vec<4> {
  static __device__ __forceinline__ float4 ld(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void add(float* acc, float4 t, float w) {
    acc[0] += t.x * w; acc[1] += t.y * w; acc[2] += t.z * w; acc[3] += t.w * w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

template <int VEC>
__global__ void __launch_bounds__(32 * WARPS)
mipmap_gather_kernel(Levels<const float*> lv, const float* __restrict__ uv,
                     int n, int h, int w, int ch, int accumulate,
                     float* __restrict__ out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int blocks_x = (w + TW * WX - 1) / (TW * WX);
  const int blocks_y = (h + TH * WY - 1) / (TH * WY);
  const int img = blockIdx.x / (blocks_x * blocks_y);
  const int b2 = blockIdx.x % (blocks_x * blocks_y);
  const int x0t = (b2 % blocks_x) * TW * WX + (warp % WX) * TW;
  const int y0t = (b2 / blocks_x) * TH * WY + (warp / WX) * TH;
  if (x0t >= w || y0t >= h) return;   // a warp past the frame's edge

  // this block's channels [c0, c0 + cw), groups of VEC
  const int c0 = blockIdx.y * VEC * WINDOW;
  const int cw = min(VEC * WINDOW, ch - c0);
  const int groups = cw / VEC;

  // one lane per pixel works out each level's taps once, into registers:
  // the 00 texel << 2 | x1 - x0 << 1 | y1 - y0, and the weights
  const int px = x0t + lane % TW, py = y0t + lane / TW;
  const bool live = px < w && py < h;
  float u = 0.f, vv = 0.f;
  if (live) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(
        uv + 2 * (((size_t)img * h + py) * w + px)));
    u = t.x;
    vv = t.y;
  }
  int key[MAX_LEVELS];
  float wk[MAX_LEVELS][4];
#pragma unroll
  for (int l = 0; l < MAX_LEVELS; ++l) {
    if (l >= lv.n) break;
    const int s = lv.size[l];
    const Taps t = level_taps(u, vv, s, live);
    key[l] = (t.y0 * s + t.x0) << 2 | (t.x1 - t.x0) << 1 | (t.y1 - t.y0);
#pragma unroll
    for (int k = 0; k < 4; ++k) wk[l][k] = t.w[k];
  }

  // the tile's (pixel, group) items, 32 at a time in pixel order: item
  // j * 32 + lane is group g of pixel p; its sum over the levels in
  // registers, then one store (a row of the tile is contiguous)
  const size_t tile_px = ((size_t)img * h + y0t) * w + x0t;
  const int dp = 32 / groups, dg = 32 % groups;
  int p = lane / groups, g = lane % groups;
  for (int j = 0; j < groups; ++j) {
    const int r = p / TW, c = p % TW;
    // an item past the frame's edge reads the taps of uv 0 (all lanes
    // take part in the shuffles) and stores nothing
    const bool ok = x0t + c < w && y0t + r < h;
    float* const o = out + (tile_px + (size_t)r * w + c) * ch + c0 + g * VEC;
    float total[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) total[k] = ok && accumulate ? o[k] : 0.f;
#pragma unroll
    for (int l = 0; l < MAX_LEVELS; ++l) {
      if (l >= lv.n) break;
      const int s = lv.size[l];
      const int kk = __shfl_sync(FULL, key[l], p);
      float wt[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) wt[k] = __shfl_sync(FULL, wk[l][k], p);
      // the taps' texels in the order 00, 10, 01, 11 (first index y)
      const int t00 = kk >> 2, dx = kk >> 1 & 1, dy = (kk & 1) * s;
      const int texel[4] = {t00, t00 + dy, t00 + dx, t00 + dx + dy};
      const float* tex = lv.ptr[l] + c0 + g * VEC;
      float acc[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        Vec<VEC>::add(acc, Vec<VEC>::ld(tex + (size_t)texel[k] * ch), wt[k]);
#pragma unroll
      for (int k = 0; k < VEC; ++k) total[k] += acc[k];
    }
    if (ok) Vec<VEC>::store(o, total);
    p += dp;
    g += dg;
    if (g >= groups) {
      g -= groups;
      ++p;
    }
  }
}

template <int VEC>
int launch(const Levels<const float*>& lv, const float* uv, int n, int h,
           int w, int ch, int accumulate, float* out, cudaStream_t stream) {
  const long long blocks = (long long)n * ((w + TW * WX - 1) / (TW * WX)) *
                           ((h + TH * WY - 1) / (TH * WY));
  if (blocks == 0) return 0;
  const int windows = (ch + VEC * WINDOW - 1) / (VEC * WINDOW);
  mipmap_gather_kernel<VEC>
      <<<dim3((unsigned)blocks, windows), 32 * WARPS, 0, stream>>>(
          lv, uv, n, h, w, ch, accumulate, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Up to MAX_LEVELS levels [S_l, S_l, ch] f32 per launch; uv [n, h, w, 2]
// f32, 8-byte aligned (read as float2) -> out [n, h, w, ch] f32;
// `accumulate` adds to `out`, so a caller with more levels launches
// again.
extern "C" int rnr_mipmap_gather(const void* t0, const void* t1,
                                 const void* t2, const void* t3,
                                 const void* uv, void* out, int s0, int s1,
                                 int s2, int s3, int n_levels, int n, int h,
                                 int w, int ch, int accumulate,
                                 cudaStream_t stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || ch < 1 || n < 0 || h < 0 ||
      w < 0 || (reinterpret_cast<size_t>(uv) & 7) != 0)
    return (int)cudaErrorInvalidValue;
  const float* const ts[MAX_LEVELS] = {
      static_cast<const float*>(t0), static_cast<const float*>(t1),
      static_cast<const float*>(t2), static_cast<const float*>(t3)};
  const int ss[MAX_LEVELS] = {s0, s1, s2, s3};
  const Levels<const float*> lv = make_levels(ts, ss, n_levels);
  // float4 taps and stores: 4 channels a group, 16-byte aligned bases
  bool vec4 = ch % 4 == 0 && (reinterpret_cast<size_t>(out) & 15) == 0;
  for (int i = 0; i < n_levels; ++i)
    vec4 = vec4 && (reinterpret_cast<size_t>(ts[i]) & 15) == 0;
  const float* u = static_cast<const float*>(uv);
  float* o = static_cast<float*>(out);
  return vec4 ? launch<4>(lv, u, n, h, w, ch, accumulate, o, stream)
              : launch<1>(lv, u, n, h, w, ch, accumulate, o, stream);
}
