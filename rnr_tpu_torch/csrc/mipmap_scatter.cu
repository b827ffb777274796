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
//   here: this is the original renderer's f32 atomic scatter, with no
//   bf16 rounding of w * g.
//
// Bound on the H100: bytes, if the atomics were free.  At 512^2 with 24
//   channels and four levels the kernel reads about 27 MB (uv and g) and
//   the level gradients are 35 MB, about 18 us of memory time.  A scatter
//   is limited by its atomics: the pixels outside the object have uv = 0,
//   about half the frame, and all of them land on one corner texel of
//   every level; the coarse levels (64^2, 128^2) put tens of pixels on
//   each texel; atomics on one address serialise in L2; and one vector
//   reduction per tap, about 11 M at 512^2, is itself some 150 us of L2
//   atomic throughput (measured).  So the design pre-reduces the taps per
//   texel before any atomic, in a way that costs few instructions: on
//   the H100 what bounds this kernel is the per-tap sort and sums (with
//   them switched off it takes a quarter of its time, with the atomics
//   switched off nine tenths; chip_variants.py).
//
// Design: a warp owns a tile of 8 x 4 pixels of one image; the block (8
//   warps) is only a container of shared memory, and no warp waits for
//   another.  The warp reads its pixels' g rows once, as float4 across
//   lanes, into shared memory.  Then per level, one lane per pixel
//   computes the four taps of csrc/mipmap_common.cuh, the gather's (the
//   coordinates by __fmul_rn / __fsub_rn, no FMA contraction), and the
//   warp takes the bounding box of its taps of nonzero weight (redux).
//   Where the box holds at most WIN texels, the warp counting-sorts its
//   taps by texel of the box in shared memory (a histogram by integer
//   shared atomics, an exclusive scan across the lanes, each tap to its
//   place), and then one lane per (texel, float4) sums w * g over its
//   texel's taps and sends the sum with one vector reduction
//   (red.global.add.v4.f32): once per texel per tile, however many of
//   the tile's taps landed on it.  Where the box is larger (silhouettes,
//   where the object's taps and the corner texel share a tile; uv seams;
//   the fine level at grazing angles), the lanes on the texel of the
//   first, then of the last, lane left are summed across lanes
//   (channels across lanes) and sent once, and every other lane sends
//   its own tap (without those two groups the silhouette tiles' corner
//   lanes, one reduction each on one address, took the kernel from
//   about 85 to 160 us at 512^2).  Taps of weight exactly 0 add nothing.
//   Measured and dropped on the way: grouping equal texels with
//   match.any (on the H100 it cost more than the atomics it saved), a
//   walk of the taps one by one with the lanes across channels
//   (latency-bound), and one reduction per tap (bound by the atomics).
//   The order of the atomics across warps is not fixed, so the f32 sums
//   may differ in the last bits from run to run.
//
// What the hot and ragged cases cost: a tile wholly outside the object
//   sorts its 32 taps into one texel and sends one vector reduction per
//   float4 per level (about 4,200 tiles of a 512^2 frame, so about 4,200
//   same-address reductions where the pixel-per-thread scatter had
//   131,072 atomics per channel); a silhouette tile sends the object's
//   taps one by one and the corner's as one group; C % 4 != 0 takes the
//   scalar path (scalar loads and atomics); a tile past the frame's edge
//   masks its missing pixels.

#include <cuda_runtime.h>

#include "mipmap_common.cuh"

namespace {

constexpr int MAX_CH = 128;
constexpr unsigned FULL = 0xffffffffu;
constexpr int TW = 8, TH = 4;          // a warp's pixel tile
constexpr int WARPS = 8;
constexpr int WIN = 128;               // texels of a warp's box, at most

// a warp's shared memory: its pixels' g rows, each padded so that the
// lanes' float4 (or float) reads of 32 rows fall in distinct banks; the
// counts of the box's texels; its taps sorted by texel (pixel, weight)
__host__ __device__ constexpr int g_stride(int ch, int vec) {
  return vec == 4 ? ch + 4 : (ch % 2 == 0 ? ch + 1 : ch);
}
__host__ __device__ constexpr int warp_floats(int ch, int vec) {
  return 32 * g_stride(ch, vec) + WIN + 2 * 4 * 32;
}

template <int VEC>
__device__ __forceinline__ void red_add(float* dst, const float* a);
template <>
__device__ __forceinline__ void red_add<1>(float* dst, const float* a) {
  atomicAdd(dst, a[0]);
}
template <>
__device__ __forceinline__ void red_add<4>(float* dst, const float* a) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "l"(dst), "f"(a[0]), "f"(a[1]), "f"(a[2]), "f"(a[3])
               : "memory");
}

template <int VEC>
__global__ void __launch_bounds__(32 * WARPS)
mipmap_scatter_kernel(Levels<float*> lv, const float* __restrict__ uv,
                      const float* __restrict__ g, int n, int h, int w,
                      int ch) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles_x = (w + TW - 1) / TW, tiles_y = (h + TH - 1) / TH;
  const long long tile = (long long)blockIdx.x * WARPS + warp;
  if (tile >= (long long)n * tiles_x * tiles_y) return;
  const int img = (int)(tile / ((long long)tiles_x * tiles_y));
  const int t2 = (int)(tile % ((long long)tiles_x * tiles_y));
  const int x0t = (t2 % tiles_x) * TW, y0t = (t2 / tiles_x) * TH;

  const int gs_stride = g_stride(ch, VEC);
  float* gs = smem + warp * warp_floats(ch, VEC);
  int* cnt = reinterpret_cast<int*>(gs + 32 * gs_stride);
  int* ent_p = cnt + WIN;
  float* ent_w = reinterpret_cast<float*>(ent_p + 4 * 32);

  // this lane's pixel, and the tile's g rows into shared memory
  const int px = x0t + lane % TW, py = y0t + lane / TW;
  const bool live = px < w && py < h;
  const int row_px = min(TW, w - x0t);
  for (int r = 0; r < TH && y0t + r < h; ++r) {
    const float* src = g + (((size_t)img * h + y0t + r) * w + x0t) * ch;
    for (int e = lane * VEC; e < row_px * ch; e += 32 * VEC) {
      float* dst = gs + (r * TW + e / ch) * gs_stride + e % ch;
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(dst) =
            __ldg(reinterpret_cast<const float4*>(src + e));
      } else {
        *dst = __ldg(src + e);
      }
    }
  }
  float u = 0.f, vv = 0.f;
  if (live) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(
        uv + 2 * (((size_t)img * h + py) * w + px)));
    u = t.x;
    vv = t.y;
  }
  __syncwarp();

  for (int l = 0; l < lv.n; ++l) {
    const int s = lv.size[l];
    // the gather's taps, rounding for rounding
    const Taps tp = level_taps(u, vv, s, live);
    const float wt[4] = {tp.w[0], tp.w[1], tp.w[2], tp.w[3]};
    const int tx[4] = {tp.x0, tp.x0, tp.x1, tp.x1};
    const int ty[4] = {tp.y0, tp.y1, tp.y0, tp.y1};

    float* dt = lv.ptr[l];

    // the bounding box of the warp's taps of nonzero weight
    unsigned lo_x = 0xffffffffu, lo_y = 0xffffffffu, hi_x = 0, hi_y = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (wt[t] != 0.f) {
        lo_x = min(lo_x, (unsigned)tx[t]);
        hi_x = max(hi_x, (unsigned)tx[t]);
        lo_y = min(lo_y, (unsigned)ty[t]);
        hi_y = max(hi_y, (unsigned)ty[t]);
      }
    }
    lo_x = __reduce_min_sync(FULL, lo_x);
    lo_y = __reduce_min_sync(FULL, lo_y);
    hi_x = __reduce_max_sync(FULL, hi_x);
    hi_y = __reduce_max_sync(FULL, hi_y);
    if (lo_x == 0xffffffffu) continue;   // no tap of weight > 0 (uniform)
    const int ww = (int)(hi_x - lo_x) + 1, wh = (int)(hi_y - lo_y) + 1;

    if (ww <= WIN && wh <= WIN && ww * wh <= WIN) {
      // the taps sorted by texel of the box (a counting sort), then one
      // lane per (texel, float4) sums its texel's taps and sends them
      const int area = ww * wh;
      for (int e = lane; e < WIN; e += 32) cnt[e] = 0;
      __syncwarp();
      int bin[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        bin[t] = wt[t] != 0.f
            ? (ty[t] - (int)lo_y) * ww + tx[t] - (int)lo_x : -1;
        if (bin[t] >= 0) atomicAdd(cnt + bin[t], 1);
      }
      __syncwarp();
      // exclusive prefix sum of the WIN counts: lane i owns WIN / 32
      // consecutive bins
      int local[WIN / 32], sum = 0;
#pragma unroll
      for (int k = 0; k < WIN / 32; ++k) {
        local[k] = cnt[lane * (WIN / 32) + k];
        sum += local[k];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
      }
      int run = incl - sum;
#pragma unroll
      for (int k = 0; k < WIN / 32; ++k) {
        cnt[lane * (WIN / 32) + k] = run;
        run += local[k];
      }
      __syncwarp();
      // each tap to its place; cnt[b] then ends bin b
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (bin[t] >= 0) {
          const int at = atomicAdd(cnt + bin[t], 1);
          ent_p[at] = lane;
          ent_w[at] = wt[t];
        }
      }
      __syncwarp();
      const int nv = ch / VEC;
      for (int it = lane; it < area * nv; it += 32) {
        const int b = it / nv, c0 = (it % nv) * VEC;
        const int beg = b ? cnt[b - 1] : 0, end = cnt[b];
        if (beg == end) continue;
        float a[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) a[k] = 0.f;
        for (int e = beg; e < end; ++e) {
          const float wp = ent_w[e];
          const float* gp = gs + ent_p[e] * gs_stride + c0;
          if constexpr (VEC == 4) {
            const float4 gv = *reinterpret_cast<const float4*>(gp);
            a[0] = fmaf(wp, gv.x, a[0]);
            a[1] = fmaf(wp, gv.y, a[1]);
            a[2] = fmaf(wp, gv.z, a[2]);
            a[3] = fmaf(wp, gv.w, a[3]);
          } else {
            a[0] = fmaf(wp, gp[0], a[0]);
          }
        }
        const int texel = ((int)lo_y + b / ww) * s + (int)lo_x + b % ww;
        red_add<VEC>(dt + (size_t)texel * ch + c0, a);
      }
      __syncwarp();
      continue;
    }

    // the box overflows the window: per tap, the lanes on the texel of the
    // first, then of the last, lane left are summed across lanes and sent
    // once; every other lane sends its own tap
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const bool nz = wt[t] != 0.f;
      // a zero-weight tap joins no group: a key no other lane holds
      const int key = nz ? ty[t] * s + tx[t] : -1 - lane;
      unsigned rest = __ballot_sync(FULL, nz);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!rest) break;
        const int ld = r == 0 ? __ffs(rest) - 1 : 31 - __clz(rest);
        const int k0 = __shfl_sync(FULL, key, ld);
        const unsigned grp = __ballot_sync(FULL, key == k0);
        if (__popc(grp) < 2) continue;
        rest &= ~grp;
        float* dst = dt + (size_t)k0 * ch;
        for (int c0 = 0; c0 < ch; c0 += 32) {
          const int c = c0 + lane;
          float a = 0.f;
          for (unsigned m = grp; m; m &= m - 1) {
            const int p = __ffs(m) - 1;
            const float wp = __shfl_sync(FULL, wt[t], p);
            if (c < ch) a = fmaf(wp, gs[p * gs_stride + c], a);
          }
          if constexpr (VEC == 4) {
            // lane j sends channels c0 + 4 j .. + 3
            float v4[4];
#pragma unroll
            for (int k = 0; k < 4; ++k)
              v4[k] = __shfl_sync(FULL, a, (4 * lane + k) & 31);
            if (4 * lane < min(32, ch - c0)) red_add<4>(dst + c0 + 4 * lane, v4);
          } else {
            if (c < ch) red_add<1>(dst + c, &a);
          }
        }
      }
      if (rest & (1u << lane)) {
        float* dst = dt + (size_t)key * ch;
        for (int c0 = 0; c0 < ch; c0 += VEC) {
          float a[VEC];
          if constexpr (VEC == 4) {
            const float4 gv =
                *reinterpret_cast<const float4*>(gs + lane * gs_stride + c0);
            a[0] = wt[t] * gv.x;
            a[1] = wt[t] * gv.y;
            a[2] = wt[t] * gv.z;
            a[3] = wt[t] * gv.w;
          } else {
            a[0] = wt[t] * gs[lane * gs_stride + c0];
          }
          red_add<VEC>(dst + c0, a);
        }
      }
    }
  }
}

template <int VEC>
int launch(const Levels<float*>& lv, const float* uv, const float* g, int n, int h,
           int w, int ch, cudaStream_t stream) {
  const int smem = WARPS * warp_floats(ch, VEC) * (int)sizeof(float);
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        mipmap_scatter_kernel<VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        WARPS * warp_floats(MAX_CH, VEC) * (int)sizeof(float));
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const long long tiles =
      (long long)n * ((w + TW - 1) / TW) * ((h + TH - 1) / TH);
  const long long blocks = (tiles + WARPS - 1) / WARPS;
  if (blocks == 0) return 0;
  mipmap_scatter_kernel<VEC><<<(unsigned)blocks, 32 * WARPS, smem, stream>>>(
      lv, uv, g, n, h, w, ch);
  return (int)cudaGetLastError();
}

}  // namespace

// Up to MAX_LEVELS level gradients per launch (each [S_l, S_l, ch] f32,
// zeroed by the caller: the kernel adds into them); a caller with more
// levels launches again.  uv [n, h, w, 2], g [n, h, w, ch] f32, ch <=
// MAX_CH.
extern "C" int rnr_mipmap_scatter(void* d0, void* d1, void* d2, void* d3,
                                  const void* uv, const void* g, int s0,
                                  int s1, int s2, int s3, int n_levels,
                                  int n, int h, int w, int ch,
                                  cudaStream_t stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || ch < 1 || ch > MAX_CH ||
      n < 0 || h < 0 || w < 0)
    return (int)cudaErrorInvalidValue;
  float* const ds[MAX_LEVELS] = {static_cast<float*>(d0),
                                 static_cast<float*>(d1),
                                 static_cast<float*>(d2),
                                 static_cast<float*>(d3)};
  const int ss[MAX_LEVELS] = {s0, s1, s2, s3};
  const Levels<float*> lv = make_levels(ds, ss, n_levels);
  const float* u = static_cast<const float*>(uv);
  const float* gp = static_cast<const float*>(g);
  return ch % 4 == 0 ? launch<4>(lv, u, gp, n, h, w, ch, stream)
                     : launch<1>(lv, u, gp, n, h, w, ch, stream);
}
