// K8's 4x4 pair: the U-Net's 4x4 stride-2 conv (rnr_down4s) and 4x4
// stride-2 "SAME" transpose conv (rnr_convt4s), the same two functions as
// K6 (csrc/conv4x4.cu): NHWC bf16 input (C a multiple of 8: the wrapper
// pads other counts with zero channels), HWIO bf16 weights [4, 4, C, O8]
// (O8 = O rounded up to 8, zero-padded), f32 sums, no bias, a bf16 output
// or, for the data-gradient use, an f32 one (the *_f32out entry points:
// down4s is convt4s's dgrad, conv_pallas.py:1347-1355).
//   down4s:  y[i, j] = sum_{dy, dx < 4} xp[2i + dy, 2j + dx] w[dy, dx]
//            (xp: x with a ring of 1, zero or reflect) -> [N, H/2, W/2, O]
//   convt4s: y[2t + a, 2s + b] = sum_{r, q < 2} xq[t + a + r, s + b + q]
//            w[a + 2r, b + 2q]  (xq: x zero-padded by 1) -> [N, 2H, 2W, O]
//
// Replaces: rnr_tpu/ops/conv_pallas.py  _down4s_fwd_impl (:1138) /
//   _down4s_kernel (:1122) and _convt4s_fwd_impl (:1276) /
//   _convt4s_kernel (:1255), the 4x4 pair under conv_backend=p3s4 (and
//   slab).  There XLA builds the slab of packed rows in HBM and the
//   kernel puts the column shift on its output, which gave the TPU wide
//   dots.  Here the taps are descriptor moves over bands of the input
//   staged in shared memory: no slab, no shifted output, no wasted rows.
//
// Bound on the H100: tensor-core operations.  The five down convs of a
//   512^2 frame are 62 GFLOP (0.064 ms at 989 TFLOP/s), their f32 dgrads
//   and the five transpose convs 123 GFLOP each, against a few hundred
//   MB of activations (tens of microseconds at 3.35 TB/s).  Measured on
//   the H100 (chip_variants.py, the kernels phase's 15 shapes), no one
//   part holds this design: with the products, the loads after the first
//   ring or the output stores switched off it takes 76-82%, 84-87% and
//   89-91% of its time.  One or two consumer warpgroups an SM wait for
//   each unit's loads and then for its products, so the three add up.
//
// Design: implicit GEMM on wgmma, fed by TMA, as K3 (csrc/conv3x3.cu).
//   GEMM rows are output positions (down4s) or input positions s
//   (convt4s: each gives the two outputs 2s and 2s + 1 of one output
//   row, in two accumulators b = 0, 1), N is output channels (BN 64 or
//   128), and the reduction runs over units of (64 channels, two taps).
//   A unit's two taps read one input row at two column offsets that
//   differ by one position:
//   - down4s, unit (dy, p): taps dx = p and p + 2.  Column 2j + dx - 1
//     of input row 2i + dy - 1 is, for p = 1, the even column j or j + 1
//     and, for p = 0, the odd column j - 1 or j.  Two tensor maps over x
//     with the column stride doubled (the odd one based one position
//     in) give each parity as a dense row of positions.
//   - convt4s, unit (r, q) for output row parity a: taps (a + 2r, 2q +
//     b), b = 0, 1: input row t + a + r - 1, column s + q + b - 1.
//   The weight map views HWIO as [tap row * 2 + kx / 2][kx % 2][C][O8],
//   so one box brings a unit's two taps for 64 outputs.
//   A tile is BM = 64 or 128 GEMM rows: R = BM / SW row segments of SW
//   positions.  A segment of 64 or 128 positions is one TMA box of SW + 1
//   (tap 1 is the band's descriptor moved down one row); where a row has
//   at most 32 positions (the 16^2 and 32^2 levels), SW = 16 or 32 and a
//   segment takes a box of SW positions per tap.  TMA writes zeros
//   outside the tensor: the zero ring, the positions past a row's end and
//   the channels past C cost nothing.
//   Reflect (down4s only) takes the input row by index, and a patch warp
//   copies column 1 into column -1 (the odd band's first position) and,
//   at even W, column W - 2 into column W (the even band's last) in
//   shared memory.  Warp-specialised and persistent: as many blocks as
//   fit on the card walk the tiles; in each, one producer warpgroup (a
//   TMA thread and the patch warp) keeps a ring of up to 4 stages full
//   through full / empty mbarriers, running on into the next tile while
//   the consumers store this one's outputs; 1 or 2 consumer warpgroups
//   each issue 8 m64nBNk16 wgmma per unit, f32 sums in registers, and
//   wait for them before releasing the stage (waiting for the last but
//   one unit let ptxas serialise the products, C7515, and measured
//   slower); convt4s's two warpgroups take the producer's registers
//   (setmaxnreg 56 / 224) for their 128 accumulators a thread.
//   Epilogue, one accumulator at a time: registers -> a shared f32
//   buffer apart from the ring -> 16-byte stores along O (elementwise
//   where O's rows are not 16-byte multiples); convt4s's b = 0, 1 go to
//   neighbouring positions of one output row.
//   Split-K where the tiles fill less than a wave (the plan is the
//   wrapper's, ops/conv4_cuda.py::conv4s_plan): each split writes an f32
//   partial of the whole output and sum_splits adds them in split order,
//   launched by the same C call.  Every sum runs in a fixed order, no
//   atomics: bitwise equal results from run to run.  The tensor maps, the
//   epilogue's staging and stores, the split sum and the persistent
//   grid's size are K6's too (csrc/conv4x4_common.cuh).
//
// What ragged cases cost: C % 8 != 0 is padded by the wrapper (a copy of
//   x); C % 64 != 0 multiplies zeros in the last channel unit; O % 64 !=
//   0 wastes BN - O columns of the last output tile; a row of W not a
//   multiple of the tile wastes the last tile's positions; the 16^2 and
//   32^2 levels split K (partials of the whole output in f32).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "conv4x4_common.cuh"
#include "sm90.cuh"

namespace {

using namespace conv4;

constexpr int MAX_STAGES = 4;
constexpr int B_ATOM = 2 * KC * 128;   // a unit's two taps, 64 outputs

// Per launch: the GEMM's geometry and the plan.
struct Geo {
  int n, h, wd, c, o;   // input [n, h, wd, c] (c % 8 == 0), o outputs
  int gh, gw;           // GEMM rows per image, positions per row
  int sw, rows;         // positions of a row segment, segments of a tile
  int segr;             // shared rows of a segment's band (sw >= 64)
  int reflect;
  int units, per;       // reduction units, per split
  int stages, stage_bytes;
  long long gx, gy;     // tiles: row tiles (x 2 parities), column tiles x splits
  long long tiles;      // gx gy output tiles
  long long out_elems;  // elements of one output (of one f32 partial)
};

template <bool UP, int BN, int WGS>
struct Cfg {
  static constexpr int BM = 64 * WGS;
  static constexpr int THREADS = 128 * (WGS + 1);   // + the producer
  static constexpr int NA = BN / 64;                // weight boxes a unit
  static constexpr int ACCS = UP ? 2 : 1;
  static constexpr int ROWS = ACCS * BM;            // output rows of a tile
  static constexpr int LDC = BN + 4;                // f32 epilogue row
  // the epilogue's staging (one accumulator at a time) and its rows'
  // destinations, apart from the ring, so the ring runs on meanwhile
  static constexpr int EPI = BM * LDC * 4 + ROWS * 8;
  static constexpr int TAIL = EPI + 3 * MAX_STAGES * 8 + 1024;
};

// One tile of the walk: output row parity a (convt4s), first GEMM row,
// first position, first output, its split's units and partial.
struct Tile {
  int a, j0, o0, u0, u1, split;
  long long row0;
};

template <bool UP>
__device__ __forceinline__ Tile tile_of(long long t, const Geo& g, int bn) {
  Tile tl;
  const long long tx = t % g.gx, tyz = t / g.gx;
  const int ty = (int)(tyz % g.gy);
  const int col_tiles = (g.gw + g.sw - 1) / g.sw;
  tl.a = UP ? (int)(tx & 1) : 0;
  tl.row0 = (UP ? tx >> 1 : tx) * g.rows;
  tl.split = ty / col_tiles;
  tl.j0 = (ty - tl.split * col_tiles) * g.sw;
  tl.o0 = (int)(tyz / g.gy) * bn;
  tl.u0 = tl.split * g.per;
  tl.u1 = tl.u0 + g.per < g.units ? tl.u0 + g.per : g.units;
  return tl;
}

// the output row (of O values) of tile row mm, or -1: down4s row m is
// position m, convt4s row 2 m + b is output 2 (j0 + m) + b
template <bool UP>
__device__ __forceinline__ long long dest_row(const Geo& g, const Tile& tl,
                                              int mm) {
  const int m = UP ? mm >> 1 : mm;
  const int k = m / g.sw, jj = m - k * g.sw;
  const long long r = tl.row0 + k;
  const int j = tl.j0 + jj;
  if (r >= (long long)g.n * g.gh || j >= g.gw) return -1;
  if (!UP) return r * g.gw + j;
  const long long img = r / g.h;
  const int t = (int)(r - img * g.h);
  return (img * 2 * g.h + 2 * t + tl.a) * 2 * g.wd + 2 * j + (mm & 1);
}

// shared-memory row (of 128 bytes, from the band's start) that tap i
// reads for tile position m: segments of 64 positions or more share one
// band of sw + 1 (tap 1 is one row down), in slots of segr rows; shorter
// ones have a block of BM rows a tap
__device__ __forceinline__ int band_row(int i, int m, const Geo& g, int bm) {
  if (g.sw < 64) return i * bm + m;
  const int k = m / g.sw;
  return k * g.segr + (m - k * g.sw) + i;
}

// xmap0 / xmap1: down4s, x's even / odd columns as rows of positions;
// convt4s, x itself (xmap1 unused).  Boxes (64 channels, BM + 1 or SW
// positions, 1, 1), 128-byte swizzle.  wmap: w as [8][2][C][O8], boxes
// (64 outputs, 64 channels, 1, 2) for down4s, (.., 2, 1) for convt4s.
// Persistent: block b walks tiles b, b + gridDim.x, ..; tile t is (row
// tile [x 2 parities a for convt4s], column tile + split * column tiles,
// output tile), the first fastest.  y: the output, or the f32 partials.
template <bool UP, int BN, int WGS, typename OutT>
__global__ void __launch_bounds__(128 * (WGS + 1), 1)
conv4s_kernel(const __grid_constant__ CUtensorMap xmap0,
              const __grid_constant__ CUtensorMap xmap1,
              const __grid_constant__ CUtensorMap wmap,
              OutT* __restrict__ y, const Geo g) {
  using K = Cfg<UP, BN, WGS>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  // full[s]: stage s landed (the TMA thread's arrival with its bytes and
  // the patch warp's); tma[s]: the bytes of a band the patch warp fixes;
  // empty[s]: the consumers are done with it
  float* es = reinterpret_cast<float*>(smem + g.stages * g.stage_bytes);
  long long* dest = reinterpret_cast<long long*>(es + K::BM * K::LDC);
  const uint32_t full_bar = sm90::smem_addr(smem + g.stages * g.stage_bytes +
                                            K::EPI);
  const uint32_t tma_bar = full_bar + 8 * MAX_STAGES;
  const uint32_t empty_bar = tma_bar + 8 * MAX_STAGES;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < g.stages; ++s) {
      sm90::mbar_init(full_bar + 8 * s, 2);
      sm90::mbar_init(tma_bar + 8 * s, 1);
      sm90::mbar_init(empty_bar + 8 * s, 128 * WGS);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int bm = K::BM;
  const int wg = tid / 128;
  constexpr int T = UP ? 4 : 8;        // units of one channel chunk
  if (wg == WGS) {
    // ---- producer: warp 0 issues the TMA loads, warp 1 patches; the
    // ring runs on across tiles, so the next tile's loads fly while the
    // consumers store this one's outputs ----
    if constexpr (UP && WGS == 2) sm90::setmaxnreg_dec<56>();
    const int warp = (tid / 32) % 4, lane = tid % 32;
    if (warp >= 2) return;
    const uint32_t a_bytes = g.sw >= 64 ? (uint32_t)(g.rows * (g.sw + 1) * 128)
                                        : (uint32_t)(2 * bm * 128);
    uint32_t tphase = 0;
    int it = 0;                        // units issued, over every tile
#pragma unroll 1
    for (long long t = blockIdx.x; t < g.tiles; t += gridDim.x) {
      const Tile tl = tile_of<UP>(t, g, BN);
      // reflect's columns: -1 is column 1 (the odd band's first position
      // := its second); at even W, column W is W - 2 (the even band's
      // position for column W := the one before), on a row's last tile
      const int p_right = g.gw - 1 - tl.j0;
      const bool left = !UP && g.reflect && tl.j0 == 0;
      const bool right =
          !UP && g.reflect && (g.wd % 2 == 0) && p_right < g.sw;
#pragma unroll 1
      for (int u = tl.u0; u < tl.u1; ++u, ++it) {
        const int s = it % g.stages;
        if (it >= g.stages)
          sm90::mbar_wait(empty_bar + 8 * s, (it / g.stages - 1) & 1);
        const int c0 = (u / T) * KC, hi = (u % T) >> 1, lo = u & 1;
        const bool fix = lo == 0 ? left : right;
        unsigned char* st = smem + s * g.stage_bytes;
        const uint32_t sa = sm90::smem_addr(st);
        const uint32_t band = sa + K::NA * B_ATOM;
        if (warp == 0) {
          if (lane == 0) {
            const uint32_t bar = fix ? tma_bar + 8 * s : full_bar + 8 * s;
            sm90::mbar_arrive_tx(bar, K::NA * B_ATOM + a_bytes);
            // down4s: taps (hi, lo), (hi, lo + 2); convt4s: (a + 2 hi,
            // 2 lo), (a + 2 hi, 2 lo + 1)
            const int d2 = UP ? 0 : lo;
            const int d3 = UP ? 2 * (tl.a + 2 * hi) + lo : 2 * hi;
            for (int na = 0; na < K::NA; ++na)
              sm90::tma_load_4d(sa + na * B_ATOM, &wmap, tl.o0 + 64 * na, c0,
                                d2, d3, bar);
            const CUtensorMap* xm = (!UP && lo == 0) ? &xmap1 : &xmap0;
            const int col = UP ? tl.j0 - 1 + lo : (lo == 0 ? tl.j0 - 1 : tl.j0);
            for (int k = 0; k < g.rows; ++k) {
              const long long r = tl.row0 + k;
              const int img = (int)(r / g.gh);
              const int i = (int)(r - (long long)img * g.gh);
              int xr = UP ? i + tl.a + hi - 1 : 2 * i + hi - 1;
              if (!UP && g.reflect) xr = reflect_row(xr, g.h);
              if (g.sw >= 64) {
                sm90::tma_load_4d(band + k * g.segr * 128, xm, c0, col, xr,
                                  img, bar);
              } else {
                sm90::tma_load_4d(band + k * g.sw * 128, xm, c0, col, xr, img,
                                  bar);
                sm90::tma_load_4d(band + (bm + k * g.sw) * 128, xm, c0,
                                  col + 1, xr, img, bar);
              }
            }
            if (fix) sm90::mbar_arrive(full_bar + 8 * s);
          }
        } else {
          if (fix) {
            sm90::mbar_wait(tma_bar + 8 * s, (tphase >> s) & 1);
            tphase ^= 1u << s;
            unsigned char* bp = st + K::NA * B_ATOM;
            for (int e = lane; e < g.rows * 8; e += 32) {
              const int m = (e / 8) * g.sw, chunk = e % 8;
              if (lo == 0)
                sm90::sw128_copy_chunk(bp, band_row(0, m, g, bm),
                                       band_row(1, m, g, bm), chunk);
              else
                sm90::sw128_copy_chunk(bp, band_row(1, m + p_right, g, bm),
                                       band_row(0, m + p_right, g, bm),
                                       chunk);
            }
            sm90::fence_async_shared();
            __syncwarp();
          }
          if (lane == 0) sm90::mbar_arrive(full_bar + 8 * s);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 tile rows each ----
  if constexpr (UP && WGS == 2) sm90::setmaxnreg_inc<224>();
  const int lane = tid % 32;
  const int rbase = wg * 64 + (tid % 128) / 32 * 16 + lane / 4;
  float acc[K::ACCS][BN / 2];
  int it = 0;
#pragma unroll 1
  for (long long t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    const Tile tl = tile_of<UP>(t, g, BN);
#pragma unroll
    for (int b = 0; b < K::ACCS; ++b)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[b][i] = 0.f;
#pragma unroll 1
    for (int u = tl.u0; u < tl.u1; ++u, ++it) {
      const int s = it % g.stages;
      sm90::mbar_wait(full_bar + 8 * s, (it / g.stages) & 1);
      const uint32_t sa = sm90::smem_addr(smem + s * g.stage_bytes);
      const uint32_t band = sa + K::NA * B_ATOM;
#pragma unroll
      for (int b = 0; b < K::ACCS; ++b) sm90::fence_regs(acc[b]);
      sm90::wgmma_fence();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t arow = band + band_row(i, wg * 64, g, bm) * 128;
#pragma unroll
        for (int ks = 0; ks < KC / 16; ++ks) {
          // A: tile rows wg 64 .. of tap i, 16 channels from 16 ks
          // (K-major); B: tap i's [KC, BN] rows 16 ks .. (MN-major)
          const uint64_t da = sm90::desc_sw128(arow + ks * 32, 16, 1024);
          const uint64_t db =
              sm90::desc_sw128(sa + i * KC * 128 + ks * 16 * 128, B_ATOM, 1024);
          sm90::wgmma<0, 1>(acc[UP ? i : 0], da, db);
        }
      }
      sm90::wgmma_commit();
      // all of this unit's products before the stage is released: waiting
      // for the last but one lets ptxas serialise them (C7515)
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < K::ACCS; ++b) sm90::fence_regs(acc[b]);
      sm90::mbar_arrive(empty_bar + 8 * s);
    }

    // ---- epilogue, one accumulator at a time: registers -> shared (f32)
    // -> 16-byte stores along O; the producer loads the next tile ----
    OutT* yb = y + (size_t)tl.split * (size_t)g.out_elems;
    sm90::bar_sync(1, 128 * WGS);    // the last tile's stores read es
    for (int mm = tid; mm < K::ROWS; mm += 128 * WGS)
      dest[mm] = dest_row<UP>(g, tl, mm);
#pragma unroll
    for (int b = 0; b < K::ACCS; ++b) {
      if (b > 0) sm90::bar_sync(1, 128 * WGS);
      stage_frag<BN, K::LDC>(es, acc[b], 0, rbase, lane);
      sm90::bar_sync(1, 128 * WGS);
      store_rows<OutT, BN, K::LDC>(es, dest, K::ACCS, b, yb, g.o, tl.o0,
                                   K::BM, tid, 128 * WGS);
    }
  }
}

template <bool UP, int BN, int WGS, typename OutT>
int launch_cfg(const void* x, const void* w, OutT* y, Geo g, int splits,
               cudaStream_t stream) {
  using K = Cfg<UP, BN, WGS>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv4s_kernel<UP, BN, WGS, OutT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  g.segr = (g.sw + 1 + 7) / 8 * 8;
  const int a_bytes = g.sw >= 64
                          ? (g.rows * g.segr * 128 + 1023) / 1024 * 1024
                          : 2 * K::BM * 128;
  g.stage_bytes = K::NA * B_ATOM + a_bytes;
  g.stages = (SMEM_LIMIT - K::TAIL) / g.stage_bytes;
  if (g.stages > MAX_STAGES) g.stages = MAX_STAGES;
  if (g.stages < 2) return (int)cudaErrorInvalidConfiguration;
  const int smem = g.stages * g.stage_bytes + K::TAIL;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidConfiguration;

  const int cols = g.sw >= 64 ? g.sw + 1 : g.sw;
  CUtensorMap xmap0, xmap1, wmap;
  int err;
  if (UP) {
    err = sm90::nhwc_map(&xmap0, x, g.n, g.h, g.wd, g.c, cols);
    xmap1 = xmap0;
  } else {
    err = parity_map(&xmap0, x, g.n, g.h, g.wd, g.c, 1, 0, 0, cols);
    if (err == 0)
      err = parity_map(&xmap1, x, g.n, g.h, g.wd, g.c, 1, 0, 1, cols);
  }
  if (err == 0)
    err = weight_map(&wmap, w, g.c, (g.o + 7) / 8 * 8, UP ? 2 : 1, UP ? 1 : 2);
  if (err != 0) return err;
  const long long row_tiles = ((long long)g.n * g.gh + g.rows - 1) / g.rows;
  g.gx = row_tiles * (UP ? 2 : 1);
  g.gy = (long long)((g.gw + g.sw - 1) / g.sw) * splits;
  g.tiles = g.gx * g.gy * ((g.o + BN - 1) / BN);
  static int per_sm = 0, per_sm_smem = -1;
  const long long blocks =
      wave_blocks(conv4s_kernel<UP, BN, WGS, OutT>, K::THREADS, smem, g.tiles,
                  per_sm, per_sm_smem);
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  conv4s_kernel<UP, BN, WGS, OutT>
      <<<(unsigned)blocks, K::THREADS, smem, stream>>>(xmap0, xmap1, wmap, y, g);
  return (int)cudaGetLastError();
}

template <bool UP, typename OutT>
int launch_any(const void* x, const void* w, OutT* y, const Geo& g, int bn,
               int wgs, int splits, cudaStream_t stream) {
#define RNR_K8(BN_, WGS_)                                                    \
  if (bn == BN_ && wgs == WGS_)                                              \
    return launch_cfg<UP, BN_, WGS_, OutT>(x, w, y, g, splits, stream);
  RNR_K8(64, 1) RNR_K8(64, 2) RNR_K8(128, 1) RNR_K8(128, 2)
#undef RNR_K8
  return (int)cudaErrorInvalidConfiguration;
}

// The plan (bn, wgs, sw, splits, per) is ops/conv4_cuda.py::conv4s_plan's;
// it is checked here, not chosen.
template <bool UP, typename OutT>
int launch(const void* x, const void* w, void* y, void* part, int n, int h,
           int wd, int c, int o, int reflect, int bn, int wgs, int sw,
           int splits, int per, cudaStream_t stream) {
  Geo g{};
  g.n = n; g.h = h; g.wd = wd; g.c = c; g.o = o;
  g.gh = UP ? h : h / 2;
  g.gw = UP ? wd : wd / 2;
  g.reflect = UP ? 0 : reflect;
  if (n < 1 || c < 8 || c % 8 || o < 1 || g.gh < 1 || g.gw < 1)
    return (int)cudaErrorInvalidValue;
  if (g.reflect && (h < 2 || wd < 2)) return (int)cudaErrorInvalidValue;
  const int bm = 64 * wgs;
  if ((bn != 64 && bn != 128) || (wgs != 1 && wgs != 2) ||
      !(sw == 16 || sw == 32 || (sw % 64 == 0 && sw <= bm)))
    return (int)cudaErrorInvalidValue;
  g.sw = sw;
  g.rows = bm / sw;
  g.units = (UP ? 4 : 8) * ((c + KC - 1) / KC);
  g.per = per;
  if (splits < 1 || per < 1 || (long long)splits * per < g.units ||
      (long long)(splits - 1) * per >= g.units || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  g.out_elems = (long long)n * (UP ? 4LL * h * wd : (long long)g.gh * g.gw) * o;
  if (splits == 1)
    return launch_any<UP, OutT>(x, w, static_cast<OutT*>(y), g, bn, wgs, 1,
                                stream);
  float* pp = static_cast<float*>(part);
  const int e = launch_any<UP, float>(x, w, pp, g, bn, wgs, splits, stream);
  if (e != 0) return e;
  return launch_sum_splits(pp, static_cast<OutT*>(y), g.out_elems, splits,
                           stream);
}

}  // namespace

extern "C" int rnr_down4s(const void* x, const void* w, void* y, void* part,
                          int n, int h, int wd, int c, int o, int reflect,
                          int bn, int wgs, int sw, int splits, int per,
                          cudaStream_t stream) {
  return launch<false, bf16>(x, w, y, part, n, h, wd, c, o, reflect, bn, wgs,
                             sw, splits, per, stream);
}

// down4s with an f32 output: convt4s's data gradient (zero padding).
extern "C" int rnr_down4s_f32out(const void* x, const void* w, void* y,
                                 void* part, int n, int h, int wd, int c,
                                 int o, int reflect, int bn, int wgs, int sw,
                                 int splits, int per, cudaStream_t stream) {
  return launch<false, float>(x, w, y, part, n, h, wd, c, o, reflect, bn, wgs,
                              sw, splits, per, stream);
}

extern "C" int rnr_convt4s(const void* x, const void* w, void* y, void* part,
                           int n, int h, int wd, int c, int o, int bn,
                           int wgs, int sw, int splits, int per,
                           cudaStream_t stream) {
  return launch<true, bf16>(x, w, y, part, n, h, wd, c, o, 0, bn, wgs, sw,
                            splits, per, stream);
}

extern "C" int rnr_convt4s_f32out(const void* x, const void* w, void* y,
                                  void* part, int n, int h, int wd, int c,
                                  int o, int bn, int wgs, int sw, int splits,
                                  int per, cudaStream_t stream) {
  return launch<true, float>(x, w, y, part, n, h, wd, c, o, 0, bn, wgs, sw,
                             splits, per, stream);
}
