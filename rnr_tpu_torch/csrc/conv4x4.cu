// K6: the U-Net's 4x4 stride-2 conv (rnr_down4) and 4x4 stride-2 "SAME"
// transpose conv (rnr_convt4) under conv_backend "pallas".  NHWC bf16
// input (C a multiple of 8: the wrapper pads other counts with zero
// channels), HWIO bf16 weights [4, 4, C, O8] (O8 = O rounded up to 8,
// zero-padded), f32 sums, no bias (the U-Net adds it in the activation
// dtype), a bf16 output or, for the data-gradient use, an f32 one (the
// *_f32out entry points: convt4 is down4's dgrad under zero padding,
// down4 is convt4's dgrad, as conv_pallas.py:763-806 run them).
//
//   down4:  y[n, i, j] = sum_{dy, dx < 4} xp[n, 2i + dy, 2j + dx] w[dy, dx]
//           xp = x with a ring of 1, zero or reflect -> [N, H/2, W/2, O]
//           (H//2 at odd H, as rnr_tpu's kernel).
//   convt4: y[n, 2t + a, 2s + b] = sum_{r, q < 2}
//           xq[n, t + a + r, s + b + q] w[a + 2r, b + 2q]  (xq: x
//           zero-padded by 1) -> [N, 2H, 2W, O]  (lax.conv_transpose with
//           transpose_kernel=False, a correlation on the 2x-dilated input;
//           conv_pallas.py:617-627).
//
// Replaces: rnr_tpu/ops/conv_pallas.py  _down4_fwd_impl (:532) /
//   _down4_kernel (:481) and _convt4_fwd_impl (:664) / _convt4_kernel
//   (:617).  The TPU kernels stage the padded input's four row/column
//   parity planes (down4) or one band of xq (convt4) once per block and
//   run every tap's dot from them.  Here TMA does the parity split, with
//   no copy, and the taps are descriptor moves over the staged band.
//
// Bound on the H100: tensor-core operations.  The five down convs of a
//   512^2 frame are 62 GFLOP (0.064 ms at 989 TFLOP/s), their f32 dgrads
//   and the five transpose convs 123 GFLOP each, against a few hundred MB
//   of activations (tens of microseconds at 3.35 TB/s).
//
// Design: implicit GEMM on wgmma, fed by TMA, the structure of K8's pair
//   (csrc/conv4x4_slab.cu) with fewer, larger reduction units.  GEMM rows
//   are output positions (down4) or input positions (t, s) (convt4: each
//   gives the 2 x 2 outputs (2t + a, 2s + b), in four accumulators, one a
//   parity), N is output channels (BN 64, or 128 for down4), and the
//   reduction runs over units of 64 channels:
//   - down4, unit (64 channels, parity plane (pr, pc)): the plane's four
//     taps (dy, dx) = (pr + 2a, pc + 2b) read plane row i + a, column
//     j + b.  Four tensor maps over x with the row and column strides
//     doubled, one per row / column parity, give each plane as dense rows
//     of positions (plane (pr, pc) is x's rows of parity 1 - pr and
//     columns of parity 1 - pc, one back).  One band of R + 1 plane rows
//     x SW + 1 positions serves the four taps of R row segments.
//   - convt4, unit (64 channels, output row parity a): the eight taps
//     (a + 2r, kx), r < 2, kx < 4, read xq row t + a + r, column s + b +
//     q (kx = b + 2q) into accumulator (a, b).  One band of R + 1 rows x
//     SW + 2 positions serves all eight, both column parities b at once.
//   A tile is BM = 64 or 128 GEMM rows of one image: R = BM / SW row
//   segments of SW positions.  SW = 64 where rows are longer than 32
//   positions: a band row is one TMA box of SW + 1 (+ 2) positions, tap
//   (a, b) the band's descriptor moved down a band rows and b positions.
//   At the 16^2 and 32^2 levels SW = 16 or 32 and a band row takes one
//   box per column offset, so a tap's 64 rows are contiguous.  TMA writes
//   zeros outside the tensor: the zero ring, positions past a row's end,
//   rows past the image and channels past C cost nothing.  Reflect
//   (down4 only) takes each plane row by index, and a patch warp copies
//   the plane's column 1 into its column 0 (x's column 1 for -1) and, at
//   even W, its column W/2 - 1 into W/2 (x's W - 2 for W) in shared
//   memory.  The weights of a unit come in boxes of two or four taps
//   beside its band.  Warp-specialised and persistent: as many blocks as
//   fit on the card walk the tiles; in each, one producer warpgroup (a
//   TMA thread and the patch warp) keeps a ring of 2 stages full through
//   full / empty mbarriers, running on into the next tile while the
//   consumers store this one's outputs; 1 or 2 consumer warpgroups each
//   issue 16 m64nBNk16 (down4) or 32 m64n64k16 (convt4) wgmma per unit,
//   f32 sums in registers, and wait for them before releasing the stage
//   (waiting for an earlier unit lets ptxas serialise the products,
//   C7515); convt4's two warpgroups take the producer's registers
//   (setmaxnreg 56 / 224) for their four accumulators, 128 a thread.
//   Epilogue, 64 outputs of one accumulator at a time: registers -> a
//   shared f32 buffer apart from the ring -> 16-byte stores along O
//   (elementwise where O's rows are not 16-byte multiples); convt4's
//   parities (a, b) go to the 2 x 2 block of outputs of their GEMM row.
//   Split-K where the tiles fill less than a wave (the plan is the
//   wrapper's, ops/conv4_cuda.py::conv4_plan; convt4's splits are whole
//   chunks, both parities a, so a is static): each split writes an f32
//   partial of the whole output and sum_splits adds them in split order,
//   launched by the same C call.  Every sum runs in a fixed order, no
//   atomics: bitwise equal results from run to run.
//
// What ragged cases cost: C % 8 != 0 is padded by the wrapper (a copy of
//   x); C % 64 != 0 multiplies zeros in the last channel unit; O % BN != 0
//   wastes the last output tile's columns; rows or row segments that no
//   tile divides waste the last tile's positions; the 16^2 and 32^2
//   levels split K (partials of the whole output in f32).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "conv4x4_common.cuh"
#include "sm90.cuh"

namespace {

using namespace conv4;

constexpr int MAX_STAGES = 4;
constexpr int TAP_BYTES = KC * 128;   // one tap's 64 channels, 64 outputs
constexpr int LDE = 64 + 4;           // f32 epilogue row: 64 outputs a pass

// Per launch: the GEMM's geometry and the plan.
struct Geo {
  int n, h, wd, c, o;   // input [n, h, wd, c] (c % 8 == 0), o outputs
  int gh, gw;           // GEMM rows: rows of an image, positions of a row
  int sw, rows;         // positions of a row segment, segments of a tile
  int segr;             // shared rows of a band row (sw >= 64)
  int reflect;
  int units, per;       // reduction units, per split
  int stages, stage_bytes;
  long long row_tiles;  // row tiles of one image
  long long gx, gy;     // tiles: row tiles, column tiles x splits
  long long tiles;      // gx gy output tiles
  long long out_elems;  // elements of one output (of one f32 partial)
};

template <bool UP, int BN, int WGS>
struct Cfg {
  static constexpr int BM = 64 * WGS;
  static constexpr int THREADS = 128 * (WGS + 1);   // + the producer
  static constexpr int NA = BN / 64;                // weight boxes a tap
  static constexpr int TAPS = UP ? 8 : 4;           // taps of a unit
  static constexpr int UPC = UP ? 2 : 4;            // units of a chunk
  static constexpr int E = UP ? 2 : 1;              // a band row's extra
  static constexpr int ACCS = UP ? 4 : 1;           // parities (a, b)
  static constexpr int PASSES = ACCS * NA;          // epilogue passes
  static constexpr int B_BYTES = TAPS * NA * TAP_BYTES;
  // the epilogue's staging (64 outputs at a time) and its rows'
  // destinations, apart from the ring, so the ring runs on meanwhile
  static constexpr int EPI = BM * LDE * 4 + ACCS * BM * 8;
  static constexpr int TAIL = EPI + 3 * MAX_STAGES * 8 + 1024;
};

// One tile of the walk: image, first row, first position, first output,
// its split's units and partial.
struct Tile {
  int img, i0, j0, o0, u0, u1, split;
};

__device__ __forceinline__ Tile tile_of(long long t, const Geo& g, int bn) {
  Tile tl;
  const long long tx = t % g.gx, tyz = t / g.gx;
  const int ty = (int)(tyz % g.gy);
  const int col_tiles = (g.gw + g.sw - 1) / g.sw;
  tl.img = (int)(tx / g.row_tiles);
  tl.i0 = (int)(tx - tl.img * g.row_tiles) * g.rows;
  tl.split = ty / col_tiles;
  tl.j0 = (ty - tl.split * col_tiles) * g.sw;
  tl.o0 = (int)(tyz / g.gy) * bn;
  tl.u0 = tl.split * g.per;
  tl.u1 = tl.u0 + g.per < g.units ? tl.u0 + g.per : g.units;
  return tl;
}

// the output row (of O values) of tile row m, accumulator p (convt4:
// parity (a, b) = (p / 2, p % 2)), or -1
template <bool UP>
__device__ __forceinline__ long long dest_row(const Geo& g, const Tile& tl,
                                              int m, int p) {
  const int k = m / g.sw;
  const int i = tl.i0 + k, j = tl.j0 + (m - k * g.sw);
  if (i >= g.gh || j >= g.gw) return -1;
  if (!UP) return ((long long)tl.img * g.gh + i) * g.gw + j;
  return ((long long)tl.img * 2 * g.h + 2 * i + (p >> 1)) * 2 * g.wd +
         2 * j + (p & 1);
}

// shared-memory row (of 128 bytes, from the band's start) of band row kk,
// position pos, column offset cb: rows of sw >= 64 positions are one box
// of sw + E in slots of segr rows; shorter ones a block of (R + 1) x sw
// rows per column offset
__device__ __forceinline__ int band_pos(int cb, int kk, int pos,
                                        const Geo& g) {
  if (g.sw >= 64) return kk * g.segr + pos + cb;
  return (cb * (g.rows + 1) + kk) * g.sw + pos;
}

// convt4's eight taps of one unit (output row parity a) into the
// accumulators of parities (a, 0) and (a, 1): tap (r, kx) reads band row
// k + r at column offset b + q (kx = b + 2q)
__device__ __forceinline__ void convt_products(float (&acc0)[32],
                                               float (&acc1)[32],
                                               uint32_t sa, uint32_t band,
                                               int k, int pos, const Geo& g) {
#pragma unroll
  for (int slot = 0; slot < 8; ++slot) {
    const int r = slot >> 2, kx = slot & 3, b = kx & 1;
    const uint32_t arow = band + band_pos(b + (kx >> 1), k + r, pos, g) * 128;
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      const uint64_t da = sm90::desc_sw128(arow + ks * 32, 16, 1024);
      const uint64_t db = sm90::desc_sw128(
          sa + slot * TAP_BYTES + ks * 16 * 128, 8 * TAP_BYTES, 1024);
      if (b == 0)
        sm90::wgmma<0, 1>(acc0, da, db);
      else
        sm90::wgmma<0, 1>(acc1, da, db);
    }
  }
}

// xm0 .. xm3: down4, x's rows / columns of parity (q / 2, q % 2) as rows
// of positions (conv4::parity_map, both strides doubled); convt4, x itself
// (xm1 .. xm3 unused).  Boxes (64 channels, SW + E or SW positions, 1,
// 1), 128-byte swizzle.  wmap: w as [8][2][C][O8] (conv4::weight_map),
// boxes of two taps (dy, pc), (dy, pc + 2) for down4, four (ky, 0 .. 3)
// for convt4.  Persistent: block b walks tiles b, b + gridDim.x, ..; tile
// t is (row tile, column tile + split * column tiles, output tile), the
// first fastest.  y: the output, or the f32 partials.
template <bool UP, int BN, int WGS, typename OutT>
__global__ void __launch_bounds__(128 * (WGS + 1), 1)
conv4_kernel(const __grid_constant__ CUtensorMap xm0,
             const __grid_constant__ CUtensorMap xm1,
             const __grid_constant__ CUtensorMap xm2,
             const __grid_constant__ CUtensorMap xm3,
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
  long long* dest = reinterpret_cast<long long*>(es + K::BM * LDE);
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

  const int wg = tid / 128;
  if (wg == WGS) {
    // ---- producer: warp 0 issues the TMA loads, warp 1 patches; the
    // ring runs on across tiles, so the next tile's loads fly while the
    // consumers store this one's outputs ----
    if constexpr (UP && WGS == 2) sm90::setmaxnreg_dec<56>();
    const int warp = (tid / 32) % 4, lane = tid % 32;
    if (warp >= 2) return;
    const uint32_t a_bytes =
        g.sw >= 64 ? (uint32_t)((g.rows + 1) * (g.sw + K::E) * 128)
                   : (uint32_t)((K::E + 1) * (g.rows + 1) * g.sw * 128);
    uint32_t tphase = 0;
    int it = 0;                        // units issued, over every tile
#pragma unroll 1
    for (long long t = blockIdx.x; t < g.tiles; t += gridDim.x) {
      const Tile tl = tile_of(t, g, BN);
      // reflect's columns: plane column 0 of pc = 0 is x's column -1 :=
      // its column 1; at even W, plane column W/2 of pc = 1 is x's
      // column W := W/2 - 1, on a row's last tile
      const int p_right = g.gw - 1 - tl.j0;
      const bool left = !UP && g.reflect && tl.j0 == 0;
      const bool right =
          !UP && g.reflect && (g.wd % 2 == 0) && p_right < g.sw;
#pragma unroll 1
      for (int u = tl.u0; u < tl.u1; ++u, ++it) {
        const int s = it % g.stages;
        if (it >= g.stages)
          sm90::mbar_wait(empty_bar + 8 * s, (it / g.stages - 1) & 1);
        const int c0 = (u / K::UPC) * KC, sub = u % K::UPC;
        const int pr = sub >> 1, pc = sub & 1;   // down4's plane
        const bool fix = pc == 0 ? left : right;
        unsigned char* st = smem + s * g.stage_bytes;
        const uint32_t sa = sm90::smem_addr(st);
        const uint32_t band = sa + K::B_BYTES;
        if (warp == 0) {
          if (lane == 0) {
            const uint32_t bar = fix ? tma_bar + 8 * s : full_bar + 8 * s;
            sm90::mbar_arrive_tx(bar, K::B_BYTES + a_bytes);
            // weights: down4 slot 2a + b = tap (pr + 2a, pc + 2b); convt4
            // slot 4r + kx = tap (sub + 2r, kx)
            for (int na = 0; na < K::NA; ++na)
              for (int h2 = 0; h2 < 2; ++h2) {
                const int ky = UP ? sub + 2 * h2 : pr + 2 * h2;
                sm90::tma_load_4d(sa + (na * K::TAPS + h2 * K::TAPS / 2) *
                                           TAP_BYTES,
                                  &wmap, tl.o0 + 64 * na, c0, UP ? 0 : pc,
                                  2 * ky, bar);
              }
            const CUtensorMap* xm = &xm0;
            if (!UP) {
              const int q = (1 - pr) * 2 + (1 - pc);
              xm = q == 1 ? &xm1 : q == 2 ? &xm2 : q == 3 ? &xm3 : &xm0;
            }
            const int col = UP ? tl.j0 - 1 : tl.j0 + pc - 1;
            for (int kk = 0; kk <= g.rows; ++kk) {
              int xr;   // down4: the plane row's index in x's rows of its
                        // parity; convt4: x's row
              if (UP) {
                xr = tl.i0 + kk + sub - 1;
              } else {
                int r = 2 * (tl.i0 + kk) + pr - 1;
                if (g.reflect) r = reflect_row(r, g.h);
                xr = (r - (1 - pr)) / 2;
              }
              if (g.sw >= 64) {
                sm90::tma_load_4d(band + band_pos(0, kk, 0, g) * 128, xm, c0,
                                  col, xr, tl.img, bar);
              } else {
                for (int cb = 0; cb <= K::E; ++cb)
                  sm90::tma_load_4d(band + band_pos(cb, kk, 0, g) * 128, xm,
                                    c0, col + cb, xr, tl.img, bar);
              }
            }
            if (fix) sm90::mbar_arrive(full_bar + 8 * s);
          }
        } else {
          if (fix) {
            sm90::mbar_wait(tma_bar + 8 * s, (tphase >> s) & 1);
            tphase ^= 1u << s;
            unsigned char* bp = st + K::B_BYTES;
            for (int e = lane; e < (g.rows + 1) * 8; e += 32) {
              const int kk = e / 8, chunk = e % 8;
              if (pc == 0)
                sm90::sw128_copy_chunk(bp, band_pos(0, kk, 0, g),
                                       band_pos(1, kk, 0, g), chunk);
              else
                sm90::sw128_copy_chunk(bp, band_pos(1, kk, p_right, g),
                                       band_pos(0, kk, p_right, g), chunk);
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
  // this warpgroup's rows start at segment k, position pos
  const int k = wg * 64 / g.sw, pos = wg * 64 - k * g.sw;
  float acc[K::ACCS][BN / 2];
  // convt4's runs of units are whole chunks (the plan's per is even), so
  // parity a is the unrolled loop's: no branch picks the accumulators
  // (one in a divergent path serialised the products, C7520)
  constexpr int STEP = UP ? 2 : 1;
  int it = 0;
#pragma unroll 1
  for (long long t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    const Tile tl = tile_of(t, g, BN);
#pragma unroll
    for (int p = 0; p < K::ACCS; ++p)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[p][i] = 0.f;
#pragma unroll 1
    for (int u = tl.u0; u < tl.u1; u += STEP) {
#pragma unroll
      for (int a = 0; a < STEP; ++a, ++it) {
        const int s = it % g.stages;
        sm90::mbar_wait(full_bar + 8 * s, (it / g.stages) & 1);
        const uint32_t sa = sm90::smem_addr(smem + s * g.stage_bytes);
        const uint32_t band = sa + K::B_BYTES;
#pragma unroll
        for (int p = 0; p < K::ACCS; ++p) sm90::fence_regs(acc[p]);
        sm90::wgmma_fence();
        if constexpr (UP) {
          convt_products(acc[2 * a], acc[2 * a + 1], sa, band, k, pos, g);
        } else {
          // slot 2 ra + cb: tap (pr + 2 ra, pc + 2 cb) of the unit's
          // plane, band row k + ra, column offset cb
#pragma unroll
          for (int slot = 0; slot < 4; ++slot) {
            const uint32_t arow =
                band + band_pos(slot & 1, k + (slot >> 1), pos, g) * 128;
#pragma unroll
            for (int ks = 0; ks < KC / 16; ++ks) {
              // A: the tap's 64 rows, 16 channels from 16 ks (K-major); B:
              // its [KC, BN] rows 16 ks .. (MN-major)
              const uint64_t da = sm90::desc_sw128(arow + ks * 32, 16, 1024);
              const uint64_t db =
                  sm90::desc_sw128(sa + slot * TAP_BYTES + ks * 16 * 128,
                                   K::TAPS * TAP_BYTES, 1024);
              sm90::wgmma<0, 1>(acc[0], da, db);
            }
          }
        }
        sm90::wgmma_commit();
        // all of this unit's products before the stage is released: waiting
        // for an earlier one lets ptxas serialise them (C7515)
        sm90::wgmma_wait<0>();
#pragma unroll
        for (int p = 0; p < K::ACCS; ++p) sm90::fence_regs(acc[p]);
        sm90::mbar_arrive(empty_bar + 8 * s);
      }
    }

    // ---- epilogue, 64 outputs of one accumulator at a time: registers
    // -> shared (f32) -> 16-byte stores along O; the producer loads the
    // next tile ----
    OutT* yb = y + (size_t)tl.split * (size_t)g.out_elems;
    sm90::bar_sync(1, 128 * WGS);    // the last tile's stores read es
    for (int mm = tid; mm < K::ACCS * K::BM; mm += 128 * WGS)
      dest[mm] = dest_row<UP>(g, tl, mm / K::ACCS, mm % K::ACCS);
#pragma unroll
    for (int p = 0; p < K::PASSES; ++p) {
      if (p > 0) sm90::bar_sync(1, 128 * WGS);
      stage_frag<64, LDE>(es, acc[p / K::NA], (p % K::NA) * 32, rbase, lane);
      sm90::bar_sync(1, 128 * WGS);
      store_rows<OutT, 64, LDE>(es, dest, K::ACCS, p / K::NA, yb, g.o,
                                tl.o0 + (p % K::NA) * 64, K::BM, tid,
                                128 * WGS);
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
        conv4_kernel<UP, BN, WGS, OutT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  g.segr = (g.sw + K::E + 7) / 8 * 8;
  const int a_bytes =
      g.sw >= 64 ? ((g.rows + 1) * g.segr * 128 + 1023) / 1024 * 1024
                 : (K::E + 1) * (g.rows + 1) * g.sw * 128;
  g.stage_bytes = K::B_BYTES + a_bytes;
  g.stages = (SMEM_LIMIT - K::TAIL) / g.stage_bytes;
  if (g.stages > MAX_STAGES) g.stages = MAX_STAGES;
  if (g.stages < 2) return (int)cudaErrorInvalidConfiguration;
  const int smem = g.stages * g.stage_bytes + K::TAIL;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidConfiguration;

  const int cols = g.sw >= 64 ? g.sw + K::E : g.sw;
  CUtensorMap xm[4], wmap;
  int err = 0;
  if (UP) {
    err = sm90::nhwc_map(&xm[0], x, g.n, g.h, g.wd, g.c, cols);
    xm[1] = xm[2] = xm[3] = xm[0];
  } else {
    for (int q = 0; q < 4 && err == 0; ++q)
      err = parity_map(&xm[q], x, g.n, g.h, g.wd, g.c, 2, q >> 1, q & 1,
                       cols);
  }
  if (err == 0)
    err = weight_map(&wmap, w, g.c, (g.o + 7) / 8 * 8, UP ? 2 : 1, 2);
  if (err != 0) return err;
  g.row_tiles = (g.gh + g.rows - 1) / g.rows;
  g.gx = (long long)g.n * g.row_tiles;
  g.gy = (long long)((g.gw + g.sw - 1) / g.sw) * splits;
  g.tiles = g.gx * g.gy * ((g.o + BN - 1) / BN);
  static int per_sm = 0, per_sm_smem = -1;
  const long long blocks =
      wave_blocks(conv4_kernel<UP, BN, WGS, OutT>, K::THREADS, smem, g.tiles,
                  per_sm, per_sm_smem);
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  conv4_kernel<UP, BN, WGS, OutT><<<(unsigned)blocks, K::THREADS, smem,
                                    stream>>>(xm[0], xm[1], xm[2], xm[3],
                                              wmap, y, g);
  return (int)cudaGetLastError();
}

template <bool UP, typename OutT>
int launch_any(const void* x, const void* w, OutT* y, const Geo& g, int bn,
               int wgs, int splits, cudaStream_t stream) {
  if (bn == 64 && wgs == 1)
    return launch_cfg<UP, 64, 1, OutT>(x, w, y, g, splits, stream);
  if (bn == 64 && wgs == 2)
    return launch_cfg<UP, 64, 2, OutT>(x, w, y, g, splits, stream);
  if constexpr (!UP) {   // convt4's four accumulators take BN 64
    if (bn == 128 && wgs == 1)
      return launch_cfg<UP, 128, 1, OutT>(x, w, y, g, splits, stream);
    if (bn == 128 && wgs == 2)
      return launch_cfg<UP, 128, 2, OutT>(x, w, y, g, splits, stream);
  }
  return (int)cudaErrorInvalidConfiguration;
}

// The plan (bn, wgs, sw, splits, per) is ops/conv4_cuda.py::conv4_plan's;
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
  if ((bn != 64 && bn != 128) || (UP && bn != 64) || (wgs != 1 && wgs != 2) ||
      !(((sw == 16 || sw == 32) && wgs == 1) || (sw % 64 == 0 && sw <= bm)))
    return (int)cudaErrorInvalidValue;
  g.sw = sw;
  g.rows = bm / sw;
  g.units = (UP ? 2 : 4) * ((c + KC - 1) / KC);
  g.per = per;
  if (splits < 1 || per < 1 || (UP && per % 2) ||
      (long long)splits * per < g.units ||
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

extern "C" int rnr_down4(const void* x, const void* w, void* y, void* part,
                         int n, int h, int wd, int c, int o, int reflect,
                         int bn, int wgs, int sw, int splits, int per,
                         cudaStream_t stream) {
  return launch<false, bf16>(x, w, y, part, n, h, wd, c, o, reflect, bn, wgs,
                             sw, splits, per, stream);
}

// down4 with an f32 output: convt4's data gradient (zero padding).
extern "C" int rnr_down4_f32out(const void* x, const void* w, void* y,
                                void* part, int n, int h, int wd, int c,
                                int o, int reflect, int bn, int wgs, int sw,
                                int splits, int per, cudaStream_t stream) {
  return launch<false, float>(x, w, y, part, n, h, wd, c, o, reflect, bn, wgs,
                              sw, splits, per, stream);
}

extern "C" int rnr_convt4(const void* x, const void* w, void* y, void* part,
                          int n, int h, int wd, int c, int o, int bn, int wgs,
                          int sw, int splits, int per, cudaStream_t stream) {
  return launch<true, bf16>(x, w, y, part, n, h, wd, c, o, 0, bn, wgs, sw,
                            splits, per, stream);
}

// convt4 with an f32 output: down4's and down4s's data gradient under
// zero padding.
extern "C" int rnr_convt4_f32out(const void* x, const void* w, void* y,
                                 void* part, int n, int h, int wd, int c,
                                 int o, int bn, int wgs, int sw, int splits,
                                 int per, cudaStream_t stream) {
  return launch<true, float>(x, w, y, part, n, h, wd, c, o, 0, bn, wgs, sw,
                             splits, per, stream);
}
