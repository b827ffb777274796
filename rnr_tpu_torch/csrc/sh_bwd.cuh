// The backward of the SH shading with the orders split between warps,
// shared by K1b (sh_fan.cu, the fan of rays built per pixel) and K5b
// (sh_shade.cu, the rays read from a materialised rays_dir).  Per pixel
// p and ray r, with gsel = (gs / r_spec or gd / r_diff) * alpha:
//     d rays_lt[p, r, c] = (coeff^T basis)[c] * gsel[c]   (rays_lt's dtype)
//     d coeff[b, c]      = sum over pixels and rays of basis[b] * rays_lt[c] * gsel[c].
// The basis is the scaled ladder of sh_common.cuh on the scaled
// coefficients (ops/sh_cuda.py fan_coeff); the basis scale is applied
// once, to the summed d coeff.
//
// d coeff is 363 sums at lmax 10, too many for one thread.  So the orders
// are split between the four warps of a block (a fixed assignment per
// LMAX balanced by instruction count, order_owner: 28 to 32 basis rows
// each at lmax 10): each warp walks only its orders' ladders, for every
// pixel-ray of the block, and keeps their d coeff sums in registers (the
// basis value never leaves the register it was computed in).  A block
// takes 64 pixels in chunks of 4 rays (256 pixel-rays) with one barrier
// per chunk: between two, each thread builds two rays of the next chunk
// (ct, T_1, the even powers T_2k and rays_lt * gsel, into shared memory),
// adds the warps' radiance parts of the chunk before (in warp order) into
// d rays_lt, and its warp walks the current chunk; the ray data and the
// radiance parts are double-buffered.  The block's rays_lt rows are
// copied in with 16-byte loads, overwritten by d rays_lt as its chunks
// finish, and written out with 16-byte stores.  Each block's d coeff sums
// go through shared memory into per-block partials laid out entry-major;
// a second kernel adds them in block order (one warp per entry, a fixed
// tree) and applies the basis scale, so d coeff is bitwise the same from
// run to run (no atomics).
//
// Only the build step differs between the two kernels: a Rays type gives
// the direction of ray r of pixel p.
//   PX_FIELDS       its per-pixel fields in shared memory (after gsel)
//   DIR_ROWS        whether it stages the block's rays_dir rows
//   powers(lmax)    the even powers T_2, T_4, ... a chunk stores; a walk
//                   takes a higher one by complex products from the last
//                   stored (the build's chain of products, so the same
//                   bits)
//   stage(own, dirs, p0, np)         fills its fields and rows
//   pixel(own, dirs, p, np) -> Pixel the pixel's operands, in registers
//   ray(pixel, r, spec, x, y, z)     the direction of ray r

#pragma once

#include "sh_common.cuh"

namespace {

constexpr int FAN_WARPS = 4;            // order groups per backward block
constexpr int FAN_BWD_THREADS = 32 * FAN_WARPS;
constexpr int FAN_BWD_PIXELS = 64;      // pixels per backward block
constexpr int FAN_CHUNK_RAYS = 4;       // rays per backward chunk
constexpr int FAN_CHUNK = FAN_BWD_PIXELS * FAN_CHUNK_RAYS;   // pixel-rays
constexpr int FAN_BWD_NP = 1;           // pixel-rays per lane in a walk
constexpr int FAN_RAYS_PER_THREAD =     // rays of one pixel a thread builds
    FAN_CHUNK / FAN_BWD_THREADS;
static_assert(FAN_BWD_PIXELS % (32 * FAN_BWD_NP) == 0 &&
                  FAN_CHUNK % FAN_BWD_THREADS == 0 &&
                  FAN_BWD_THREADS % FAN_BWD_PIXELS == 0,
              "walks of 32 x NP pixel-rays over chunks of whole rays; each "
              "thread builds rays of one pixel");
constexpr int GSEL_FIELDS = 6;          // gsel of the spec rays, then diffuse

// Basis values of order m: LMAX + 1 - m rows (twice that for m > 0).
__host__ __device__ constexpr int order_values(int lmax, int m) {
  return m == 0 ? lmax + 1 : 2 * (lmax + 1 - m);
}

// Instructions of order m per pixel-ray in the backward's walk (the
// recurrence, the fold and the d coeff sums): the balancing weight.
__host__ __device__ constexpr int order_cost(int lmax, int m) {
  return m == 0 ? 8 * (lmax + 1) : 14 * (lmax + 1 - m) + 8;
}

// The warp that owns order m: orders by falling cost, each to the least
// loaded warp so far (the lowest on a tie).
__host__ __device__ constexpr int order_owner(int lmax, int m) {
  int load[FAN_WARPS] = {};
  bool done[11] = {};
  for (int k = 0; k <= lmax; ++k) {
    int best = -1;
    for (int o = 0; o <= lmax; ++o)
      if (!done[o] && (best < 0 || order_cost(lmax, o) > order_cost(lmax, best)))
        best = o;
    int w = 0;
    for (int i = 1; i < FAN_WARPS; ++i)
      if (load[i] < load[w]) w = i;
    done[best] = true;
    load[w] += order_cost(lmax, best);
    if (best == m) return w;
  }
  return -1;
}

// The first register slot of order m in warp w's d coeff sums.
__host__ __device__ constexpr int order_slot(int lmax, int w, int m) {
  int s = 0;
  for (int o = 0; o < m; ++o)
    if (order_owner(lmax, o) == w) s += order_values(lmax, o);
  return s;
}

// The most d coeff rows any warp owns.
__host__ __device__ constexpr int max_slots(int lmax) {
  int most = 0;
  for (int w = 0; w < FAN_WARPS; ++w) {
    const int n = order_slot(lmax, w, lmax + 1);
    most = n > most ? n : most;
  }
  return most;
}

// Shared memory of a backward block, in floats: the per-pixel operands
// (gsel, then the build step's fields); two buffers of a chunk's rays
// (per pixel-ray the float4 (ct, T_1, lt * gsel [0]) and the float2 lt *
// gsel [1, 2], in two arrays, so that a warp's reads are conflict-free,
// then the stored even powers T_2, T_4, ... as float2 planes) and two of
// the warps' radiance parts; then the block's rays_lt / d rays_lt rows
// and, where the build step stages them, its rays_dir rows (at byte
// offset `dirs`).  The d coeff reduction (32 lanes x the basis rows, an
// odd pitch) reuses the space from its start.
struct BwdSmem {
  static constexpr int RADP = 3 * FAN_WARPS * FAN_CHUNK;  // one buffer
  int px, geo, geo_len, radp, rows, dirs, total_bytes, pitch;
  __host__ __device__ BwdSmem(int lmax, int r_total, int lt_bytes,
                              int px_fields, int powers, bool dir_rows) {
    px = 0;
    geo = px + px_fields * FAN_BWD_PIXELS;
    geo_len = (6 + 2 * powers) * FAN_CHUNK;              // one buffer
    radp = geo + 2 * geo_len;
    rows = radp + 2 * RADP;
    const int nb3 = 3 * (lmax + 1) * (lmax + 1);
    pitch = nb3 | 1;
    const int row_bytes = FAN_BWD_PIXELS * r_total * 3 * lt_bytes;
    dirs = rows * 4 + row_bytes;
    const int main_bytes = dirs + (dir_rows ? row_bytes : 0);
    const int red_bytes = 32 * pitch * 4;
    total_bytes = main_bytes > red_bytes ? main_bytes : red_bytes;
  }
};

template <typename Rays>
__host__ __device__ BwdSmem bwd_smem(int lmax, int r_total, int lt_bytes) {
  return BwdSmem(lmax, r_total, lt_bytes, GSEL_FIELDS + Rays::PX_FIELDS,
                 Rays::powers(lmax), Rays::DIR_ROWS);
}

// Floats of the per-block d coeff partials: one row of the [(lmax+1)^2 *
// 3] entries per block of FAN_BWD_PIXELS pixels (ops/sh_cuda.py
// fan_bwd_partials computes the same).
inline int bwd_partials(int n_pix, int lmax) {
  return (n_pix + FAN_BWD_PIXELS - 1) / FAN_BWD_PIXELS * (lmax + 1) *
         (lmax + 1) * 3;
}

// Warp W's walk of its orders for NP pixel-rays (j + 32 i): takes T_m
// from the chunk's even powers (times T_1 up to m), adds r(l, m) * T_m *
// lt*gsel into its d coeff sums and returns its part of each radiance.
template <int LMAX, int W, int NP, int NPOW>
__device__ __forceinline__ void owned_orders(const float (&ct)[NP],
                                             const float (&t1c)[NP],
                                             const float (&t1s)[NP],
                                             const float (&ltg)[NP][3],
                                             const float2* tpow, int j,
                                             float (&dc)[max_slots(LMAX)][3],
                                             float (&rad)[NP][3]) {
  static_for<0, LMAX + 1>([&](auto mc) {
    constexpr int m = decltype(mc)::value;
    if constexpr (order_owner(LMAX, m) == W) {
      constexpr int s0 = order_slot(LMAX, W, m);
      constexpr int step = m == 0 ? 1 : 2;
      float tc[NP], ts[NP], cl[NP][3], sl[NP][3], a[NP][3], b[NP][3];
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        tc[i] = 1.f;
        ts[i] = 0.f;
        if constexpr (m == 1) {
          tc[i] = t1c[i]; ts[i] = t1s[i];
        } else if constexpr (m > 1) {
          constexpr int k = m / 2 < NPOW ? m / 2 : NPOW;   // T_2k stored
          const float2 t = tpow[(k - 1) * FAN_CHUNK + j + 32 * i];
          tc[i] = t.x; ts[i] = t.y;
          static_for<2 * k, m>([&](auto) {
            next_power(tc[i], ts[i], t1c[i], t1s[i]);
          });
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          cl[i][c] = tc[i] * ltg[i][c];
          sl[i][c] = ts[i] * ltg[i][c];
          a[i][c] = cf<m, m>(c);
          dc[s0][c] += cl[i][c];
          if constexpr (m > 0) {
            b[i][c] = cf<m, -m>(c);
            dc[s0 + 1][c] += sl[i][c];
          }
        }
      }
      order_walk<LMAX, m>(ct, [&](auto lc, const float (&r)[NP]) {
        constexpr int l = decltype(lc)::value;
        constexpr int s = s0 + (l - m) * step;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
#pragma unroll
          for (int i = 0; i < NP; ++i) {
            a[i][c] = fmaf(cf<l, m>(c), r[i], a[i][c]);
            dc[s][c] = fmaf(r[i], cl[i][c], dc[s][c]);
            if constexpr (m > 0) {
              b[i][c] = fmaf(cf<l, -m>(c), r[i], b[i][c]);
              dc[s + 1][c] = fmaf(r[i], sl[i][c], dc[s + 1][c]);
            }
          }
        }
      });
#pragma unroll
      for (int i = 0; i < NP; ++i) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          if constexpr (m == 0) rad[i][c] += a[i][c];
          else rad[i][c] = fmaf(tc[i], a[i][c], fmaf(ts[i], b[i][c], rad[i][c]));
        }
      }
    }
  });
}

// f(IC<warp>): the code of the warp's order group, picked at run time.
template <int W = 0, typename F>
__device__ __forceinline__ void for_warp(int warp, F&& f) {
  if constexpr (W < FAN_WARPS) {
    if (warp == W) f(IC<W>{});
    else for_warp<W + 1>(warp, f);
  }
}

// Warp W's d coeff sums into row `lane` of the reduction tile, at the
// entries (l*l + l +- m) * 3 + c of the basis.
template <int LMAX, int W>
__device__ __forceinline__ void owned_rows_out(
    const float (&dc)[max_slots(LMAX)][3], float* red) {
  static_for<0, LMAX + 1>([&](auto mc) {
    constexpr int m = decltype(mc)::value;
    if constexpr (order_owner(LMAX, m) == W) {
      constexpr int s0 = order_slot(LMAX, W, m);
      static_for<m, LMAX + 1>([&](auto lc) {
        constexpr int l = decltype(lc)::value;
        constexpr int s = s0 + (l - m) * (m == 0 ? 1 : 2);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          red[(l * l + l + m) * 3 + c] = dc[s][c];
          if constexpr (m > 0) red[(l * l + l - m) * 3 + c] = dc[s + 1][c];
        }
      });
    }
  });
}

// gsel of the block's pixels, field-major: the spec rays' (fields 0-2,
// gs * alpha / r_spec) and the diffuse rays' (3-5, gd * alpha / r_diff);
// 0 for a dead pixel.
__device__ __forceinline__ void stage_gsel(float* px,
                                           const float* __restrict__ alpha,
                                           const float* __restrict__ gs,
                                           const float* __restrict__ gd,
                                           int p0, int np, int r_total,
                                           int r_spec) {
  const int t = threadIdx.x;
  if (t >= FAN_BWD_PIXELS) return;
  float f[GSEL_FIELDS] = {};
  const int p = p0 + t;
  if (t < np) {
    const float al = alpha[p];
    const float ws = al / (float)r_spec;
    const float wd = al / (float)max(r_total - r_spec, 1);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      f[c] = gs[(size_t)p * 3 + c] * ws;
      f[3 + c] = gd[(size_t)p * 3 + c] * wd;
    }
  }
#pragma unroll
  for (int i = 0; i < GSEL_FIELDS; ++i) px[i * FAN_BWD_PIXELS + t] = f[i];
}

// The rays of chunk r0 (nv pixel-rays, pixel-ray j = pixel j % 64, ray
// r0 + j / 64) into one geo buffer.  Thread t builds the rays of pixel
// t % 64 that are its, from one read of the pixel's operands.
template <int LMAX, typename LT, typename Rays>
__device__ __forceinline__ void build_rays(const Rays& rays, float* geo,
                                           const float* px, const void* dirs,
                                           const LT* rows, int r0, int nv,
                                           int np, int row, int r_spec) {
  constexpr int NPOW = Rays::powers(LMAX);
  const int p = threadIdx.x % FAN_BWD_PIXELS;
  const auto pix = rays.pixel(px + GSEL_FIELDS * FAN_BWD_PIXELS, dirs, p, np);
  float4* ga = reinterpret_cast<float4*>(geo);
  float2* gb = reinterpret_cast<float2*>(geo + 4 * FAN_CHUNK);
  float2* tpow = reinterpret_cast<float2*>(geo + 6 * FAN_CHUNK);
#pragma unroll
  for (int i = 0; i < FAN_RAYS_PER_THREAD; ++i) {
    const int j = threadIdx.x + i * FAN_BWD_THREADS;
    if (j >= nv) break;
    const int r = r0 + j / FAN_BWD_PIXELS;
    const bool is_spec = r < r_spec;
    float x, y, z;
    rays.ray(pix, r, is_spec, x, y, z);
    float ct, t1c, t1s;
    azimuth(x, y, z, ct, t1c, t1s);
    const int g0 = (is_spec ? 0 : 3) * FAN_BWD_PIXELS + p;
    float ltg[3] = {0.f, 0.f, 0.f};
    if (p < np) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        ltg[c] = load_lt(rows + p * row + r * 3 + c) *
                 px[g0 + c * FAN_BWD_PIXELS];
    }
    ga[j] = make_float4(ct, t1c, t1s, ltg[0]);
    gb[j] = make_float2(ltg[1], ltg[2]);
    float tc = t1c, ts = t1s;
    static_for<2, 2 * NPOW + 1>([&](auto mc) {
      constexpr int m = decltype(mc)::value;
      next_power(tc, ts, t1c, t1s);
      if constexpr (m % 2 == 0)
        tpow[(m / 2 - 1) * FAN_CHUNK + j] = make_float2(tc, ts);
    });
  }
}

// d rays_lt of chunk r0 = (the warps' radiance parts, in warp order) *
// gsel, into the block's rows; thread t takes the pixel-rays it built.
template <typename LT>
__device__ __forceinline__ void sum_radiance(LT* rows, const float* radp,
                                             const float* px, int r0, int nv,
                                             int np, int row, int r_spec) {
  const int p = threadIdx.x % FAN_BWD_PIXELS;
  if (p >= np) return;
#pragma unroll
  for (int i = 0; i < FAN_RAYS_PER_THREAD; ++i) {
    const int j = threadIdx.x + i * FAN_BWD_THREADS;
    if (j >= nv) break;
    const int r = r0 + j / FAN_BWD_PIXELS;
    const int g0 = (r < r_spec ? 0 : 3) * FAN_BWD_PIXELS + p;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float rad = radp[c * FAN_CHUNK + j];
#pragma unroll
      for (int w = 1; w < FAN_WARPS; ++w)
        rad += radp[(w * 3 + c) * FAN_CHUNK + j];
      store_lt(rows + p * row + r * 3 + c, rad * px[g0 + c * FAN_BWD_PIXELS]);
    }
  }
}

// One backward block (FAN_BWD_THREADS threads, bwd_smem<Rays>'s bytes of
// dynamic shared memory at sm): d rays_lt of its 64 pixels and its row
// of the d coeff partials.
template <int LMAX, typename LT, typename Rays>
__device__ __forceinline__ void order_split_bwd(
    float* sm, const Rays& rays, const float* __restrict__ alpha,
    const LT* __restrict__ rays_lt, const float* __restrict__ gs,
    const float* __restrict__ gd, int n_pix, int r_total, int r_spec,
    LT* __restrict__ dlt, float* __restrict__ part) {
  constexpr int NB3 = 3 * (LMAX + 1) * (LMAX + 1);
  constexpr int NP = FAN_BWD_NP;
  constexpr int NPOW = Rays::powers(LMAX);
  const BwdSmem lay = bwd_smem<Rays>(LMAX, r_total, (int)sizeof(LT));
  float* px = sm + lay.px;
  float* geo = sm + lay.geo;
  float* radp = sm + lay.radp;
  LT* rows = reinterpret_cast<LT*>(sm + lay.rows);
  unsigned char* dirs = reinterpret_cast<unsigned char*>(sm) + lay.dirs;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p0 = blockIdx.x * FAN_BWD_PIXELS;
  const int np = min(FAN_BWD_PIXELS, n_pix - p0);
  const int row = r_total * 3;
  const int row_bytes = np * row * (int)sizeof(LT);
  copy_rows(rows, rays_lt + (size_t)p0 * row, row_bytes, tid, FAN_BWD_THREADS);
  stage_gsel(px, alpha, gs, gd, p0, np, r_total, r_spec);
  rays.stage(px + GSEL_FIELDS * FAN_BWD_PIXELS, dirs, p0, np);
  __syncthreads();

  float dc[max_slots(LMAX)][3];
#pragma unroll
  for (int s = 0; s < max_slots(LMAX); ++s)
    dc[s][0] = dc[s][1] = dc[s][2] = 0.f;

  // One barrier per chunk k: between two, each thread builds chunk k+1's
  // rays, sums chunk k-1's radiance parts into d rays_lt, and its warp
  // walks chunk k; the two buffers of each keep them apart.
  const int n_chunks = (r_total + FAN_CHUNK_RAYS - 1) / FAN_CHUNK_RAYS;
  auto chunk_len = [&](int k) {
    return min(FAN_CHUNK_RAYS, r_total - k * FAN_CHUNK_RAYS) * FAN_BWD_PIXELS;
  };
  build_rays<LMAX>(rays, geo, px, dirs, rows, 0, chunk_len(0), np, row,
                   r_spec);
  __syncthreads();
  for (int k = 0; k < n_chunks; ++k) {
    const float* gk = geo + (k & 1) * lay.geo_len;
    const float4* ga = reinterpret_cast<const float4*>(gk);
    const float2* gb = reinterpret_cast<const float2*>(gk + 4 * FAN_CHUNK);
    const float2* tpow = reinterpret_cast<const float2*>(gk + 6 * FAN_CHUNK);
    float* rp = radp + (k & 1) * BwdSmem::RADP;
    if (k + 1 < n_chunks)
      build_rays<LMAX>(rays, geo + ((k + 1) & 1) * lay.geo_len, px, dirs,
                       rows, (k + 1) * FAN_CHUNK_RAYS, chunk_len(k + 1), np,
                       row, r_spec);
    if (k > 0)
      sum_radiance(rows, radp + ((k - 1) & 1) * BwdSmem::RADP, px,
                   (k - 1) * FAN_CHUNK_RAYS, chunk_len(k - 1), np, row,
                   r_spec);
    // the warp's orders for every pixel-ray of chunk k, NP at a time
    // (the chunk's length is a multiple of 64)
    const int nv = chunk_len(k);
    for (int j = lane; j < nv; j += 32 * NP) {
      float ct[NP], t1c[NP], t1s[NP], ltg[NP][3], rad[NP][3] = {};
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const float4 a = ga[j + 32 * i];
        const float2 b = gb[j + 32 * i];
        ct[i] = a.x; t1c[i] = a.y; t1s[i] = a.z;
        ltg[i][0] = a.w; ltg[i][1] = b.x; ltg[i][2] = b.y;
      }
      for_warp(warp, [&](auto wc) {
        owned_orders<LMAX, decltype(wc)::value, NP, NPOW>(ct, t1c, t1s, ltg,
                                                          tpow, j, dc, rad);
      });
#pragma unroll
      for (int i = 0; i < NP; ++i) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          rp[(warp * 3 + c) * FAN_CHUNK + j + 32 * i] = rad[i][c];
      }
    }
    __syncthreads();
  }
  sum_radiance(rows, radp + ((n_chunks - 1) & 1) * BwdSmem::RADP, px,
               (n_chunks - 1) * FAN_CHUNK_RAYS, chunk_len(n_chunks - 1), np,
               row, r_spec);
  __syncthreads();
  copy_rows(dlt + (size_t)p0 * row, rows, row_bytes, tid, FAN_BWD_THREADS);
  __syncthreads();

  // d coeff: each lane's sums into row `lane` of the tile, then the 32
  // rows added in lane order per entry, entry-major partials
  float* red = sm + lane * lay.pitch;
  for_warp(warp, [&](auto wc) {
    owned_rows_out<LMAX, decltype(wc)::value>(dc, red);
  });
  __syncthreads();
  for (int e = tid; e < NB3; e += FAN_BWD_THREADS) {
    float s = 0.f;
#pragma unroll 8
    for (int k = 0; k < 32; ++k) s += sm[k * lay.pitch + e];
    part[(size_t)e * gridDim.x + blockIdx.x] = s;
  }
}

// dcoeff[e] = scale[e / 3] * sum over blocks k of part[e][k]: one warp per
// entry, lanes over k in a fixed stride, then a fixed xor tree.
__global__ void __launch_bounds__(256)
sum_fan_partials(const float* __restrict__ part, int n_part, int n_entry,
                 const float* __restrict__ scale, float* __restrict__ out) {
  const int e = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (e >= n_entry) return;
  const float* row = part + (size_t)e * n_part;
  float s = 0.f;
  for (int k = lane; k < n_part; k += 32) s += row[k];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) out[e] = s * scale[e / 3];
}

// After the launch of an order-split backward on `blocks` blocks: its
// launch error, else the partials' sum into dcoeff.
inline int sum_partials_after(int blocks, int lmax, const float* part,
                              const float* scale, float* dcoeff,
                              cudaStream_t stream) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n_entry = (lmax + 1) * (lmax + 1) * 3;
  sum_fan_partials<<<(n_entry + 7) / 8, 256, 0, stream>>>(part, blocks,
                                                          n_entry, scale,
                                                          dcoeff);
  return (int)cudaGetLastError();
}

}  // namespace
