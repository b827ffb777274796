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
//   here: w * g is not rounded to bf16, and the sum is one whose result
//   does not depend on the order in which blocks run (below).
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
//
// Fixed point, so that every run gives the same bits: each w * g is
//   formed exactly in double (24 x 24 bits), multiplied by 2^k and
//   rounded once to the nearest integer (ties to even), and the sums run
//   in int64, in shared-memory slots, across lanes and through
//   red.global.add.u64 into an int64 copy of each level.  Integer
//   addition is associative, so neither the order of the warps' atomics
//   nor the slot order of the tile's counting sort reaches the result.
//   A last pass writes each sum, taken to double (a rounding at 2^-53),
//   scaled by 2^-k and rounded to f32, into the f32 level gradients.  k is chosen on the card, per call, from M =
//   max|g| and the pixel count P (grid_exponent): a pixel's four taps of
//   a level weigh at most 1 together, so a texel's sum is at most P * M;
//   with M < 2^(E+1) and P < 2^p, k = 61 - p - E keeps P * M * 2^k below
//   2^62, and the roundings (half a unit a tap, 4 P taps) cannot reach
//   2^63.  Each texel then differs from the exact sum of its f32-exact
//   products by at most (its taps) * 2^-(k+1) before the last rounding:
//   2^-42 M a tap at 512^2, b1 (P = 2^18, p = 19).  A non-finite g
//   (M inf or NaN) makes every texel of every level NaN.  The cost: the
//   int64 levels are zeroed, max|g| read and the levels converted, each
//   a pass over memory (67 MB of int64 at 512^2 x 24 x 4 levels), and
//   the reductions carry 8-byte scalars where they carried float4s.
//
// What the hot and ragged cases cost: a tile wholly outside the object
//   sorts its 32 taps into one texel and sends one reduction per channel
//   per level (about 4,200 tiles of a 512^2 frame, so about 4,200
//   same-address reductions where the pixel-per-thread scatter had
//   131,072 atomics per channel); a silhouette tile sends the object's
//   taps one by one and the corner's as one group; C % 4 != 0 takes the
//   scalar path (scalar loads of g); a tile past the frame's edge masks
//   its missing pixels.

#include <cuda_runtime.h>

#include "mipmap_common.cuh"

namespace {

constexpr int MAX_CH = 128;
constexpr unsigned FULL = 0xffffffffu;
constexpr int TW = 8, TH = 4;          // a warp's pixel tile
constexpr int WARPS = 8;
constexpr int WIN = 128;               // texels of a warp's box, at most
constexpr unsigned NONFINITE = 0x7f800000u;   // |g|'s bits at or above: inf, NaN

// a warp's shared memory: its pixels' g rows, each padded so that the
// lanes' float4 (or float) reads of 32 rows fall in distinct banks; the
// counts of the box's texels; its taps sorted by texel (pixel, weight)
__host__ __device__ constexpr int g_stride(int ch, int vec) {
  return vec == 4 ? ch + 4 : (ch % 2 == 0 ? ch + 1 : ch);
}
__host__ __device__ constexpr int warp_floats(int ch, int vec) {
  return 32 * g_stride(ch, vec) + WIN + 2 * 4 * 32;
}

// the grid exponent k of one call: with M = max|g| < 2^(E+1) (its bits
// `mbits`) and P < 2^p pixels, P * M * 2^k < 2^62
__device__ __forceinline__ int grid_exponent(unsigned mbits, long long pix) {
  const int e = max((int)(mbits >> 23), 1) - 127;
  const int p = 64 - __clzll(pix);
  return 61 - p - e;
}

// w * g on the grid 2^-k: the product is exact in double, the scaling by
// a power of two too, so the one rounding is the conversion's
__device__ __forceinline__ long long fix(float w, float g, double scale) {
  return __double2ll_rn((double)w * (double)g * scale);
}

__device__ __forceinline__ void red_add(long long* dst, long long a) {
  atomicAdd(reinterpret_cast<unsigned long long*>(dst),
            (unsigned long long)a);
}

// max |g| as float bits (order-free: an integer max)
__global__ void absmax_kernel(const float* __restrict__ g, long long count,
                              unsigned* __restrict__ mbits) {
  unsigned m = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += (long long)gridDim.x * blockDim.x)
    m = max(m, __float_as_uint(__ldg(g + i)) & 0x7fffffffu);
  m = __reduce_max_sync(FULL, m);
  if (threadIdx.x % 32 == 0 && m) atomicMax(mbits, m);
}

template <int VEC>
__global__ void __launch_bounds__(32 * WARPS)
mipmap_scatter_kernel(Levels<long long*> lv, const float* __restrict__ uv,
                      const float* __restrict__ g,
                      const unsigned* __restrict__ mbits, int n, int h,
                      int w, int ch) {
  extern __shared__ float smem[];
  const unsigned mb = *mbits;
  if (mb == 0 || mb >= NONFINITE) return;   // nothing to add, or NaN out
  const double scale =
      ldexp(1.0, grid_exponent(mb, (long long)n * h * w));
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

    long long* dt = lv.ptr[l];

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
      // lane per (texel, VEC channels) sums its texel's taps and sends
      // them
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
      // each tap to its place (in no fixed order within its bin: the
      // integer sums below do not see it); cnt[b] then ends bin b
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
        long long a[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) a[k] = 0;
        for (int e = beg; e < end; ++e) {
          const float wp = ent_w[e];
          const float* gp = gs + ent_p[e] * gs_stride + c0;
          if constexpr (VEC == 4) {
            const float4 gv = *reinterpret_cast<const float4*>(gp);
            a[0] += fix(wp, gv.x, scale);
            a[1] += fix(wp, gv.y, scale);
            a[2] += fix(wp, gv.z, scale);
            a[3] += fix(wp, gv.w, scale);
          } else {
            a[0] += fix(wp, gp[0], scale);
          }
        }
        const int texel = ((int)lo_y + b / ww) * s + (int)lo_x + b % ww;
        long long* dst = dt + (size_t)texel * ch + c0;
#pragma unroll
        for (int k = 0; k < VEC; ++k) red_add(dst + k, a[k]);
      }
      __syncwarp();
      continue;
    }

    // the box overflows the window: per tap, the lanes on the texel of the
    // first, then of the last, lane left are summed across lanes (the
    // lanes across channels) and sent once; every other lane sends its
    // own tap
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
        long long* dst = dt + (size_t)k0 * ch;
        for (int c0 = 0; c0 < ch; c0 += 32) {
          const int c = c0 + lane;
          long long a = 0;
          for (unsigned m = grp; m; m &= m - 1) {
            const int p = __ffs(m) - 1;
            const float wp = __shfl_sync(FULL, wt[t], p);
            if (c < ch) a += fix(wp, gs[p * gs_stride + c], scale);
          }
          if (c < ch) red_add(dst + c, a);
        }
      }
      if (rest & (1u << lane)) {
        long long* dst = dt + (size_t)key * ch;
        for (int c = 0; c < ch; ++c)
          red_add(dst + c, fix(wt[t], gs[lane * gs_stride + c], scale));
      }
    }
  }
}

// the int64 levels to f32: the sum to double, times 2^-k (exact), to
// f32; NaN everywhere for a non-finite g
__global__ void to_float_kernel(Levels<float*> out,
                                const long long* __restrict__ acc,
                                const unsigned* __restrict__ mbits,
                                long long pix, int ch) {
  const unsigned mb = *mbits;
  const double inv = ldexp(1.0, mb ? -grid_exponent(mb, pix) : 0);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int l = 0; l < out.n; ++l) {
    const long long count = (long long)out.size[l] * out.size[l] * ch;
    float* o = out.ptr[l];
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < count; i += stride)
      o[i] = mb >= NONFINITE ? __int_as_float(0x7fc00000)
                             : __double2float_rn(
                                   __ll2double_rn(__ldg(acc + i)) * inv);
    acc += count;
  }
}

template <int VEC>
int launch(const Levels<long long*>& lv, const float* uv, const float* g,
           const unsigned* mbits, int n, int h, int w, int ch,
           cudaStream_t stream) {
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
      lv, uv, g, mbits, n, h, w, ch);
  return (int)cudaGetLastError();
}

}  // namespace

// Up to MAX_LEVELS level gradients per launch, each [S_l, S_l, ch] f32,
// written (not added to); a caller with more levels launches again.
// `acc` is int64 scratch of sum_l S_l^2 ch elements and `mbits` one
// 4-byte word, both on the card (zeroed here).  uv [n, h, w, 2], g [n,
// h, w, ch] f32, ch <= MAX_CH.  uv is read as float2, so its base must be
// 8-byte aligned; where ch % 4 == 0, g is read as float4, so its base
// must be 16-byte aligned; acc must be 8-byte aligned.  Anything else
// returns cudaErrorInvalidValue and launches nothing.
extern "C" int rnr_mipmap_scatter(void* d0, void* d1, void* d2, void* d3,
                                  void* acc, void* mbits, const void* uv,
                                  const void* g, int s0, int s1, int s2,
                                  int s3, int n_levels, int n, int h, int w,
                                  int ch, cudaStream_t stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || ch < 1 || ch > MAX_CH ||
      n < 0 || h < 0 || w < 0 || (reinterpret_cast<size_t>(uv) & 7) != 0 ||
      (reinterpret_cast<size_t>(acc) & 7) != 0 ||
      (reinterpret_cast<size_t>(mbits) & 3) != 0 ||
      (ch % 4 == 0 && (reinterpret_cast<size_t>(g) & 15) != 0))
    return (int)cudaErrorInvalidValue;
  float* const ds[MAX_LEVELS] = {static_cast<float*>(d0),
                                 static_cast<float*>(d1),
                                 static_cast<float*>(d2),
                                 static_cast<float*>(d3)};
  const int ss[MAX_LEVELS] = {s0, s1, s2, s3};
  long long* as[MAX_LEVELS] = {};
  size_t total = 0;
  for (int i = 0; i < n_levels; ++i) {
    as[i] = static_cast<long long*>(acc) + total;
    total += (size_t)ss[i] * ss[i] * ch;
  }
  unsigned* mb = static_cast<unsigned*>(mbits);
  cudaError_t e = cudaMemsetAsync(acc, 0, total * sizeof(long long), stream);
  if (e == cudaSuccess) e = cudaMemsetAsync(mb, 0, sizeof(unsigned), stream);
  if (e != cudaSuccess) return (int)e;
  const long long count = (long long)n * h * w * ch;
  const float* gp = static_cast<const float*>(g);
  if (count > 0) {
    const long long want = (count + 255) / 256;
    const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
    absmax_kernel<<<blocks, 256, 0, stream>>>(gp, count, mb);
    const int rc = (ch % 4 == 0 ? launch<4> : launch<1>)(
        make_levels(as, ss, n_levels), static_cast<const float*>(uv), gp, mb,
        n, h, w, ch, stream);
    if (rc != 0) return rc;
  }
  to_float_kernel<<<132 * 8, 256, 0, stream>>>(
      make_levels(ds, ss, n_levels), static_cast<const long long*>(acc), mb,
      (long long)n * h * w, ch);
  return (int)cudaGetLastError();
}
