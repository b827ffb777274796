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
// Design, backward (K1b): d coeff is 363 sums, too many for one thread.
//   So the orders are split between the four warps of a block (a fixed
//   assignment per LMAX balanced by instruction count, order_owner: 28 to
//   32 basis rows each at lmax 10): each warp walks only its orders'
//   ladders, for every pixel-ray of the block, and keeps their d coeff
//   sums in registers (the basis value never leaves the register it was
//   computed in).  A block takes 64 pixels in chunks of 4 rays (256
//   pixel-rays) with one barrier per chunk: between two, each thread
//   builds two rays of the next chunk (ct, T_1, the even powers T_2k and
//   rays_lt * gsel, into shared memory), adds the warps' radiance parts
//   of the chunk before (in warp order) into d rays_lt, and its warp
//   walks the current chunk; the ray data and the radiance parts are
//   double-buffered.  d rays_lt is staged in shared memory and written
//   with 16-byte stores at the end.  Each block's d coeff sums go
//   through shared memory into per-block partials laid out entry-major;
//   a second kernel adds them in block order (one warp per entry, a
//   fixed tree) and applies the basis scale, so d coeff is bitwise the
//   same from run to run (no atomics).

#include "sh_common.cuh"

namespace {

constexpr int FWD_NP = 2;               // pixels per forward thread
constexpr int FWD_THREADS = 64;
constexpr int FWD_PIXELS = FWD_THREADS * FWD_NP;   // pixels per block
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

// Shared memory of a backward block, in floats: the per-pixel operands;
// two buffers of a chunk's rays (per pixel-ray the float4 (ct, T_1, lt *
// gsel [0]) and the float2 lt * gsel [1, 2], in two arrays, so that a
// warp's reads are conflict-free, then the even powers T_2, T_4, ... as
// float2 planes) and two of the warps' radiance parts; then the block's
// rays_lt / d rays_lt rows.  The d coeff reduction (32 lanes x the basis
// rows, an odd pitch) reuses the space at the end.
struct BwdSmem {
  static constexpr int PX_FIELDS = 19;   // tbn 9, vdt 3, alpha, gsel 2 x 3
  static constexpr int RADP = 3 * FAN_WARPS * FAN_CHUNK;  // one buffer
  int px, geo, geo_len, radp, rows, total_bytes, pitch;
  __host__ __device__ BwdSmem(int lmax, int r_total, int lt_bytes) {
    px = 0;
    geo = px + PX_FIELDS * FAN_BWD_PIXELS;
    geo_len = (6 + 2 * (lmax / 2)) * FAN_CHUNK;          // one buffer
    radp = geo + 2 * geo_len;
    rows = radp + 2 * RADP;
    const int nb3 = 3 * (lmax + 1) * (lmax + 1);
    pitch = nb3 | 1;
    const int main_bytes = rows * 4 + FAN_BWD_PIXELS * r_total * 3 * lt_bytes;
    const int red_bytes = 32 * pitch * 4;
    total_bytes = main_bytes > red_bytes ? main_bytes : red_bytes;
  }
};

// Warp W's walk of its orders for NP pixel-rays (j + 32 i): takes T_m
// from the chunk's even powers (times T_1 for odd m), adds r(l, m) * T_m
// * lt*gsel into its d coeff sums and returns its part of each radiance.
template <int LMAX, int W, int NP>
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
          const float2 t = tpow[(m / 2 - 1) * FAN_CHUNK + j + 32 * i];
          tc[i] = t.x; ts[i] = t.y;
          if constexpr (m % 2 == 1) next_power(tc[i], ts[i], t1c[i], t1s[i]);
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

// The per-pixel operands of a backward block, field-major (tbn 0-8, vdt
// 9-11, alpha 12, gsel of the spec rays 13-15 and of the diffuse rays
// 16-18); a dead pixel is a finite dummy with alpha 0.
__device__ __forceinline__ void stage_pixels(
    float* px, const float* __restrict__ tbn, const float* __restrict__ vdt,
    const float* __restrict__ alpha, const float* __restrict__ gs,
    const float* __restrict__ gd, int p0, int np, int r_total, int r_spec) {
  const int t = threadIdx.x;
  if (t >= FAN_BWD_PIXELS) return;
  float f[BwdSmem::PX_FIELDS] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f,
                                 1.f, 0.f, 0.f, 1.f, 0.f};
  const int p = p0 + t;
  if (t < np) {
#pragma unroll
    for (int i = 0; i < 9; ++i) f[i] = tbn[(size_t)p * 9 + i];
#pragma unroll
    for (int i = 0; i < 3; ++i) f[9 + i] = vdt[(size_t)p * 3 + i];
    const float al = alpha[p];
    f[12] = al;
    const float ws = al / (float)r_spec;
    const float wd = al / (float)max(r_total - r_spec, 1);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      f[13 + c] = gs[(size_t)p * 3 + c] * ws;
      f[16 + c] = gd[(size_t)p * 3 + c] * wd;
    }
  }
#pragma unroll
  for (int i = 0; i < BwdSmem::PX_FIELDS; ++i)
    px[i * FAN_BWD_PIXELS + t] = f[i];
}

// The rays of chunk r0 (nv pixel-rays, pixel-ray j = pixel j % 64, ray
// r0 + j / 64) into one geo buffer.  Thread t builds the rays of pixel
// t % 64 that are its, from one read of the pixel's operands.
template <int LMAX, typename LT>
__device__ __forceinline__ void build_rays(float* geo, const float* px,
                                           const LT* rows, int r0, int nv,
                                           int np, int row, int r_spec) {
  const int p = threadIdx.x % FAN_BWD_PIXELS;
  float tb[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) tb[i] = px[i * FAN_BWD_PIXELS + p];
  const float vx = px[9 * FAN_BWD_PIXELS + p], vy = px[10 * FAN_BWD_PIXELS + p],
              vz = px[11 * FAN_BWD_PIXELS + p], al = px[12 * FAN_BWD_PIXELS + p];
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
    fan_ray(tb, vx, vy, vz, al, r, is_spec, x, y, z);
    float ct, t1c, t1s;
    azimuth(x, y, z, ct, t1c, t1s);
    const int g0 = (is_spec ? 13 : 16) * FAN_BWD_PIXELS + p;
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
    static_for<2, LMAX + 1>([&](auto mc) {
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
    const int g0 = (r < r_spec ? 13 : 16) * FAN_BWD_PIXELS + p;
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

template <int LMAX, typename LT>
__global__ void __launch_bounds__(FAN_BWD_THREADS, 3)
sh_fan_bwd_kernel(const float* __restrict__ tbn, const float* __restrict__ vdt,
                  const float* __restrict__ alpha,
                  const LT* __restrict__ rays_lt, const float* __restrict__ gs,
                  const float* __restrict__ gd, int n_pix, int r_total,
                  int r_spec, LT* __restrict__ dlt, float* __restrict__ part) {
  constexpr int NB3 = 3 * (LMAX + 1) * (LMAX + 1);
  constexpr int NP = FAN_BWD_NP;
  extern __shared__ __align__(16) float sm[];
  const BwdSmem lay(LMAX, r_total, (int)sizeof(LT));
  float* px = sm + lay.px;
  float* geo = sm + lay.geo;
  float* radp = sm + lay.radp;
  LT* rows = reinterpret_cast<LT*>(sm + lay.rows);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p0 = blockIdx.x * FAN_BWD_PIXELS;
  const int np = min(FAN_BWD_PIXELS, n_pix - p0);
  const int row = r_total * 3;
  const int row_bytes = np * row * (int)sizeof(LT);
  copy_rows(rows, rays_lt + (size_t)p0 * row, row_bytes, tid, FAN_BWD_THREADS);
  stage_pixels(px, tbn, vdt, alpha, gs, gd, p0, np, r_total, r_spec);
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
  build_rays<LMAX>(geo, px, rows, 0, chunk_len(0), np, row, r_spec);
  __syncthreads();
  for (int k = 0; k < n_chunks; ++k) {
    const float* gk = geo + (k & 1) * lay.geo_len;
    const float4* ga = reinterpret_cast<const float4*>(gk);
    const float2* gb = reinterpret_cast<const float2*>(gk + 4 * FAN_CHUNK);
    const float2* tpow = reinterpret_cast<const float2*>(gk + 6 * FAN_CHUNK);
    float* rp = radp + (k & 1) * BwdSmem::RADP;
    if (k + 1 < n_chunks)
      build_rays<LMAX>(geo + ((k + 1) & 1) * lay.geo_len, px, rows,
                       (k + 1) * FAN_CHUNK_RAYS, chunk_len(k + 1), np, row,
                       r_spec);
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
        owned_orders<LMAX, decltype(wc)::value>(ct, t1c, t1s, ltg, tpow, j,
                                                dc, rad);
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
  const int smem = BwdSmem(lmax, r_total, (int)sizeof(LT)).total_bytes;
#define RNR_SH_CASE(L)                                                      \
  case L:                                                                   \
    if (int e = set_smem((const void*)sh_fan_bwd_kernel<L, LT>, smem))     \
      return e;                                                             \
    sh_fan_bwd_kernel<L, LT><<<blocks, FAN_BWD_THREADS, smem, stream>>>(    \
        tbn, vdt, alpha, lt, gs, gd, n_pix, r_total, r_spec, dlt, part);    \
    break;
  RNR_SH_SWITCH(RNR_SH_CASE)
#undef RNR_SH_CASE
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n_entry = (lmax + 1) * (lmax + 1) * 3;
  sum_fan_partials<<<(n_entry + 7) / 8, 256, 0, stream>>>(part, blocks,
                                                          n_entry, scale,
                                                          dcoeff);
  return (int)cudaGetLastError();
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
  return (n_pix + FAN_BWD_PIXELS - 1) / FAN_BWD_PIXELS * (lmax + 1) *
         (lmax + 1) * 3;
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
