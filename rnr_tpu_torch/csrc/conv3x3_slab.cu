// K8a: the 3x3 stride-1 convolution in the slab formulation, NHWC bf16
// input (C a multiple of 8: the wrapper pads other counts with zero
// channels), HWIO bf16 weights [3, 3, C, O8] (O8 = O rounded up to 8,
// zero-padded), f32 accumulation, + bias in f32, bf16 output
// (rnr_conv3x3s) or f32 output (rnr_conv3x3s_f32out: the data gradient,
// the same kernel run on the output gradient with rotated, io-transposed
// weights, as conv_pallas.py:1054-1088 runs _conv3x3_slab_fwd_impl).  The
// same function as K3 (csrc/conv3x3.cu), summed in the slab's order.
//
// The slab formulation packs the three input rows of an output row on the
// reduction axis and puts the column shift on the output:
//   Y[j', (dx, o)] = sum_{dy, c} xp[i + dy, j', c] w[dy, dx, c, o]
//                    (packed depth k = dy*C + c, 3C; width 3O)
//   y[i, j] = (Y[j, (0, o)] + Y[j + 1, (1, o)]) + Y[j + 2, (2, o)] + b[o]
// with xp = x and a ring of 1 (zero, "same", or reflect) and j' over the
// W + 2 slab columns.  The packed weights' block (dy, dx) is w[dy, dx]:
// the weight map reads the HWIO weights as the packed [3C, 3O] matrix of
// _pack_w_slab (conv_pallas.py:907), no packed copy is made.
//
// Replaces: rnr_tpu/ops/conv_pallas.py  _conv3x3_slab_fwd_impl (:917) /
//   _slab_kernel (:860), the 3x3 conv of every U-Net level under
//   conv_backend=slab3 and slab.  There XLA builds the slab in HBM at 3x
//   the activation bytes (_make_slab, :892), rounds 3C up to 128 lanes
//   (_slab_kc, :877) and W + 2 up to 8, pads the rows to the tile and
//   falls back to the tap-wise kernel past a 13 MB VMEM tile (:926).  Here
//   the slab is never built: its rows are bands of x staged by TMA, every
//   shape is taken, no fallback.
//
// Bound on the H100: tensor-core operations (as K3; the 14 convs of a
//   512^2 frame are about 0.45 TFLOP, 0.46 ms at 989 TFLOP/s, against
//   about 0.2 GB of activations).  Measured on the H100
//   (chip_variants.py, the frame's 14 shapes): with its output stores,
//   loads after the first ring or products switched off the forward takes
//   87%, 91% and 73% of its time; the first version's epilogue, stores
//   of 2 outputs a thread straight from registers, had taken half.
//
// Design: wgmma over TMA bands, the slab's shift on descriptors.  A tile
//   is BM = 64 or 128 output columns of one grid row (64 a consumer
//   warpgroup) x BN = 64 output channels (80 where O8 is 72 or 80: O = 78
//   on the last conv in one tile).  The reduction runs over units of
//   (band dy, 64 channels): one TMA box brings the BM + 2 columns of input
//   row i + dy - 1 from column j0 - 1 (64 channels, 128-byte swizzled
//   rows, sm90.cuh), one box per 64 outputs the packed weights' three
//   blocks (dy, dx = 0, 1, 2) [64 channels][64 outputs].  Y[j + dx, (dx,
//   o)] feeds output j, so the dx block's products read the staged band
//   through its descriptor moved down dx rows, into one of three
//   accumulators, one per dx, each over the full packed depth 3C.  Each
//   thread holds the same (row, column) of all three, so the epilogue
//   sums (Y0 + Y1) + Y2 in registers, in the slab's order, with no
//   shuffle and no Y tile (the first version's 80-row Y tile computed 14
//   dead rows of 80).  TMA writes zeros outside the tensor: zero padding,
//   columns past W and channels past C cost nothing.  Reflect takes the
//   input row by index and a patch warp copies the band's column 1 / W -
//   2 into column -1 / W on a row's first and last tile.  Persistent and
//   warp-specialised: as many blocks as fit walk the tiles; one producer
//   warpgroup (a TMA warp and the patch warp) keeps a ring of 2 to 4
//   stages full through full / empty mbarriers and runs on into the next
//   tile; 1 or 2 consumer warpgroups each issue 12 m64nBNk16 wgmma per
//   unit (3 dx x 4 steps of 16 channels), one unit behind the next
//   (wait_group 1), then stage their 64 rows of (Y0 + Y1) + Y2 + bias in
//   the output type in shared memory apart from the ring and store them
//   16 bytes a thread along O (elementwise where O's rows are not 16-byte
//   multiples).  The plan (BN, warpgroups, ring tiles) is
//   ops/conv_cuda.py::k8a_plan's: two warpgroups where a grid row has
//   more than 64 columns and the tiles fill the card, else one (the 32^2
//   and 64^2 levels).  Fixed order of sums: bitwise equal results from
//   run to run.
//
// The data gradient under reflect padding (pad = 2): the full correlation
//   of g with a 2-pixel zero ring on the (H + 2) x (W + 2) grid, read
//   from g by TMA's zeros; the interior goes straight to dx, the ring to
//   a side buffer that fold_ring_kernel (conv3x3_common.cuh) adds onto dx
//   in ops/conv_cuda.py::_dgrad's order of adds, in the same C call (no
//   F.pad(g), no clone, no eight strided adds).  The grid's W + 2 columns
//   cost a row a tile more than W (a third more columns at 256^2, twice
//   as many at 128^2), so there the plan takes ring tiles: row tiles over
//   columns 1 .. W and, for columns 0 and W + 1 (each one tap dx of one
//   input column), strips of BM grid rows: one TMA box of the column's BM
//   + 2 rows, tap dy its descriptor moved down dy rows, the weights of
//   the one dx in one box [3 dy][64][64], all into accumulator 0 (the
//   other two bands are zeros: (Y + 0) + 0 is Y exactly).  At 512^2 the
//   strips measured slower than the fifth tile a row they save.
//
// What ragged cases cost: C % 8 != 0 (C = 108) is padded by the wrapper
//   (a copy of x); C % 64 != 0 multiplies zeros in the last unit; O % 64
//   != 0 wastes the last tile's columns; W not a multiple of BM wastes the
//   last tile's columns; three accumulators a thread hold BN to 64 (80),
//   so the band is staged once per 64 outputs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "conv3x3_common.cuh"
#include "sm90.cuh"

namespace {

using namespace conv3;   // bf16, PAD_*, reflect, out_row, the stores

constexpr int KC = 64;         // input channels per unit: one band row

constexpr int SMEM_LIMIT = 232448;     // a block's shared memory on sm_90

template <int BN, int WGS, typename OutT>
struct Cfg {
  static constexpr int BM = 64 * WGS;            // output columns of a row
  static constexpr int THREADS = 128 * (WGS + 1);  // + the producer
  static constexpr int SEG = BM + 2;             // band rows (slab columns)
  static constexpr int A_BYTES = (SEG * 128 + 1023) / 1024 * 1024;
  // weights: per 64 outputs one TMA box [3 dx][KC][64]
  static constexpr int NA = (BN + 63) / 64;
  static constexpr int B_ATOM = 3 * KC * 128;
  static constexpr int STAGE = NA * B_ATOM + A_BYTES;
  // each consumer warpgroup's output rows, staged apart from the ring (so
  // the ring runs on meanwhile): rows of BN + 16 bytes, conflict-free
  // writes of 2 outputs a thread
  static constexpr int LDS = BN + 16 / (int)sizeof(OutT);
  static constexpr int EPI = 64 * LDS * (int)sizeof(OutT);
  // + the barriers, and up to 1024 bytes of alignment
  static constexpr int TAIL = WGS * EPI + 3 * 4 * 8 + 1024;
  static constexpr int FIT = (SMEM_LIMIT - TAIL) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int SMEM = STAGES * STAGE + TAIL;
  static_assert(B_ATOM % 1024 == 0 && STAGE % 1024 == 0, "swizzle atoms");
  static_assert(STAGES >= 2, "a ring of two stages at least");
};

// Per launch: the output grid and its tiles.  Row tiles take BM columns
// of one grid row from column j_lo; under pad 2 they cover the grid's
// columns 1 .. W and ring tiles take its columns 0 and W + 1 in strips of
// BM rows.
struct Geo {
  int n, h, wd, c, o, pad;
  int ho, j_lo, j_hi;     // grid rows per image; row tiles' columns
  int col_tiles, row_tiles, strips, o_tiles;
  int chunks;             // units of 64 channels
};

// One tile of the walk: row tiles (column tile fastest, then grid row,
// then output tile), then ring tiles (side, strip, image, output tile).
struct Tile {
  int img, row, j0, o0;   // ring: row = the strip's first grid row
  int side;               // -1: a row tile; 0 / 1: grid column 0 / W + 1
};

template <int BM, int BN, bool RING>
__device__ __forceinline__ Tile tile_of(int t, const Geo& g) {
  Tile tl;
  if (!RING || t < g.row_tiles) {
    const int rows = g.n * g.ho;
    const int r = t / g.col_tiles;
    tl.j0 = g.j_lo + (t - r * g.col_tiles) * BM;
    const int rr = r % rows;
    tl.o0 = r / rows * BN;
    tl.img = rr / g.ho;
    tl.row = rr - tl.img * g.ho;
    tl.side = -1;
  } else {
    t -= g.row_tiles;
    tl.side = t & 1;
    t >>= 1;
    tl.row = t % g.strips * BM;
    t /= g.strips;
    tl.img = t % g.n;
    tl.o0 = t / g.n * BN;
    tl.j0 = tl.side ? g.wd + 1 : 0;
  }
  return tl;
}

// two neighbouring outputs into the staged rows, rounded once
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// x [N, H, W, C] through xmap (boxes (64 channels, SEG columns, 1, 1)),
// w [3, 3, C, O8] through wmap as the packed matrix (boxes (64 outputs, KC
// channels, 3 dx)), both 128-byte swizzled, bias [O] (null: none) -> y
// (rows of O as out_row lays them out).  Pad 2's ring tiles read x's
// column strips through cmap (boxes (64 channels, 1, SEG rows, 1)) and
// the weights of one dx through tmap (boxes (64 outputs, KC, 1, 3 dy)).
// Persistent: block b walks tiles b, b + gridDim.x, ..; the producer's
// ring runs on into the next tile while the consumers store this one's
// outputs.  RING: the instance of pad 2, which has ring tiles (kept apart:
// their code in the other instances measured 20-60% slower there).
template <int BN, int WGS, bool RING, typename OutT>
__global__ void __launch_bounds__(128 * (WGS + 1), 1)
slab_kernel(const __grid_constant__ CUtensorMap xmap,
            const __grid_constant__ CUtensorMap wmap,
            const __grid_constant__ CUtensorMap cmap,
            const __grid_constant__ CUtensorMap tmap,
            const float* __restrict__ bias, OutT* __restrict__ y,
            const Geo g) {
  using K = Cfg<BN, WGS, OutT>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  // full[s]: stage s landed (the TMA warp's arrival with its bytes, and
  // the patch warp's); tma[s]: the bytes of a band whose reflect columns
  // the patch warp fixes; empty[s]: the consumers are done with it
  const uint32_t full_bar =
      sm90::smem_addr(smem + K::STAGES * K::STAGE + WGS * K::EPI);
  const uint32_t tma_bar = full_bar + 8 * K::STAGES;
  const uint32_t empty_bar = tma_bar + 8 * K::STAGES;

  const int tid = threadIdx.x;
  const int ext = g.pad == PAD_FULL ? 1 : 0;
  const int tiles = g.row_tiles + (RING ? 2 * g.strips * g.n * g.o_tiles : 0);
  if (tid == 0) {
    for (int s = 0; s < K::STAGES; ++s) {
      sm90::mbar_init(full_bar + 8 * s, 2);
      sm90::mbar_init(tma_bar + 8 * s, 1);
      sm90::mbar_init(empty_bar + 8 * s, 128 * WGS);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == WGS) {
    // ---- producer: warp 0 issues the TMA loads, warp 1 patches ----
    const int warp = (tid / 32) % 4, lane = tid % 32;
    if (warp >= 2) return;
    uint32_t tphase = 0;
    int it = 0;                        // units issued, over every tile
#pragma unroll 1
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile tl = tile_of<K::BM, BN, RING>(t, g);
      // the band's slab columns j0 .. (x columns j0 - 1 - ext ..): under
      // reflect, column -1 is column 1 (band row 0 from row 2) and column
      // W is column W - 2
      const int t_left = g.pad == PAD_REFLECT && tl.j0 == 0 ? 0 : -1;
      const int t_right = g.pad == PAD_REFLECT && g.wd - tl.j0 + 1 < K::SEG
                              ? g.wd - tl.j0 + 1 : -1;
      const bool fix = t_left >= 0 || t_right >= 0;
      const int units = !RING || tl.side < 0 ? 3 * g.chunks : g.chunks;
#pragma unroll 1
      for (int u = 0; u < units; ++u, ++it) {
        const int s = it % K::STAGES;
        if (it >= K::STAGES)
          sm90::mbar_wait(empty_bar + 8 * s, (it / K::STAGES - 1) & 1);
        const bool patch = fix;
        unsigned char* st = smem + s * K::STAGE;
        const uint32_t sa = sm90::smem_addr(st);
        if (warp == 0) {
          if (lane == 0) {
            const uint32_t bar = patch ? tma_bar + 8 * s : full_bar + 8 * s;
            const uint32_t band = sa + K::NA * K::B_ATOM;
            sm90::mbar_arrive_tx(bar, K::NA * K::B_ATOM + K::SEG * 128);
            if (!RING || tl.side < 0) {
              // band dy: the packed matrix's rows dy C + c0 .., columns
              // (dx, o0 ..); input row i + dy - 1 - ext
              const int c0 = (u / 3) * KC, dy = u % 3;
              for (int a = 0; a < K::NA; ++a)
                sm90::tma_load_3d(sa + a * K::B_ATOM, &wmap, tl.o0 + 64 * a,
                                  c0, 3 * dy, bar);
              int xr = tl.row + dy - 1 - ext;
              if (g.pad == PAD_REFLECT) xr = reflect(xr, g.h);
              sm90::tma_load_4d(band, &xmap, c0, tl.j0 - 1 - ext, xr, tl.img,
                                bar);
            } else if constexpr (RING) {
              // grid column 0 reads x's column 0 through tap dx = 2 alone,
              // column W + 1 column W - 1 through dx = 0: the column's
              // rows from the strip's first - 2, the weights (dy, dx) for
              // dy = 0, 1, 2
              const int c0 = u * KC, dx = tl.side ? 0 : 2;
              for (int a = 0; a < K::NA; ++a)
                sm90::tma_load_4d(sa + a * K::B_ATOM, &tmap, tl.o0 + 64 * a,
                                  c0, dx, 0, bar);
              sm90::tma_load_4d(band, &cmap, c0, tl.side ? g.wd - 1 : 0,
                                tl.row - 2, tl.img, bar);
            }
            if (patch) sm90::mbar_arrive(full_bar + 8 * s);
          }
        } else {
          if (patch) {
            sm90::mbar_wait(tma_bar + 8 * s, (tphase >> s) & 1);
            tphase ^= 1u << s;
            unsigned char* band = st + K::NA * K::B_ATOM;
            const int chunk = lane % 8;
            if (lane < 8 && t_left >= 0) sm90::sw128_copy_chunk(band, 0, 2, chunk);
            if (lane >= 8 && lane < 16 && t_right >= 0)
              sm90::sw128_copy_chunk(band, t_right, t_right - 2, chunk);
            sm90::fence_async_shared();
            __syncwarp();
          }
          if (lane == 0) sm90::mbar_arrive(full_bar + 8 * s);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 tile rows each.  A row tile's acc[dx] is
  //      the Y band dx of output column j (slab column j + dx); a ring
  //      tile's one band is its column's, so acc[0] takes it whole (the
  //      other two bands are zeros there: (Y + 0) + 0 is Y exactly) ----
  const int lane = tid % 32, t128 = tid % 128;
  const int rbase = t128 / 32 * 16 + lane / 4;     // of the warpgroup's 64
  OutT* es = reinterpret_cast<OutT*>(smem + K::STAGES * K::STAGE + wg * K::EPI);
  constexpr int V = 16 / sizeof(OutT);             // outputs a 16-byte store
  const bool vec = (g.o * (int)sizeof(OutT)) % 16 == 0;
  float acc[3][BN / 2];
  int it = 0;
#pragma unroll 1
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile tl = tile_of<K::BM, BN, RING>(t, g);
    const int units = !RING || tl.side < 0 ? 3 * g.chunks : g.chunks;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[dx][i] = 0.f;
#pragma unroll 1
    for (int u = 0; u < units; ++u, ++it) {
      const int s = it % K::STAGES;
      sm90::mbar_wait(full_bar + 8 * s, (it / K::STAGES) & 1);
      const uint32_t sa = sm90::smem_addr(smem + s * K::STAGE);
      const uint32_t band = sa + K::NA * K::B_ATOM;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) sm90::fence_regs(acc[dx]);
      sm90::wgmma_fence();
      // tap k: A = band rows wg 64 + k .., 16 channels from 16 ks
      // (K-major); B = weight block k's [KC, BN] rows 16 ks .. (MN-major).
      // Row tiles: k = dx, into acc[dx]; ring tiles: k = dy, into acc[0]
      if (!RING || tl.side < 0) {
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int ks = 0; ks < KC / 16; ++ks)
            sm90::wgmma<0, 1>(
                acc[k],
                sm90::desc_sw128(band + (wg * 64 + k) * 128 + ks * 32, 16, 1024),
                sm90::desc_sw128(sa + k * KC * 128 + ks * 16 * 128, K::B_ATOM,
                                 1024));
      } else if constexpr (RING) {
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int ks = 0; ks < KC / 16; ++ks)
            sm90::wgmma<0, 1>(
                acc[0],
                sm90::desc_sw128(band + (wg * 64 + k) * 128 + ks * 32, 16, 1024),
                sm90::desc_sw128(sa + k * KC * 128 + ks * 16 * 128, K::B_ATOM,
                                 1024));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();         // unit u - 1's products are done
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) sm90::fence_regs(acc[dx]);
      if (u > 0) sm90::mbar_arrive(empty_bar + 8 * ((it - 1) % K::STAGES));
    }
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) sm90::fence_regs(acc[dx]);
    sm90::mbar_arrive(empty_bar + 8 * ((it - 1) % K::STAGES));

    // ---- epilogue, per warpgroup: (Y0 + Y1) + Y2 + bias -> its staged
    //      rows (OutT) -> 16-byte stores along O; the producer loads the
    //      next tile meanwhile ----
    sm90::bar_sync(1 + wg, 128);     // the last tile's stores read es
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4), oc = tl.o0 + col;
      const float b0 = bias && oc < g.o ? bias[oc] : 0.f;
      const float b1 = bias && oc + 1 < g.o ? bias[oc + 1] : 0.f;
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int k = 4 * j + 2 * v;
        store_pair(es + (rbase + 8 * v) * K::LDS + col,
                   (acc[0][k] + acc[1][k]) + acc[2][k] + b0,
                   (acc[0][k + 1] + acc[1][k + 1]) + acc[2][k + 1] + b1);
      }
    }
    sm90::bar_sync(1 + wg, 128);
    for (int e = t128; e < 64 * (BN / V); e += 128) {
      const int m = e / (BN / V), cv = (e % (BN / V)) * V;
      const int oc = tl.o0 + cv, mm = wg * 64 + m;
      long long d = -1;
      if (RING && tl.side >= 0) {
        if (tl.row + mm < g.ho)
          d = out_row(g.pad, tl.img, tl.row + mm, tl.j0, g.n, g.h, g.wd);
      } else if (tl.j0 + mm <= g.j_hi) {
        d = out_row(g.pad, tl.img, tl.row, tl.j0 + mm, g.n, g.h, g.wd);
      }
      if (d < 0 || oc >= g.o) continue;
      const OutT* src = es + m * K::LDS + cv;
      OutT* dst = y + d * g.o + oc;
      if (vec && oc + V <= g.o) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int q = 0; q < V && oc + q < g.o; ++q) dst[q] = src[q];
      }
    }
  }
}

// w [3, 3, C, O8] bf16 as the packed matrix's blocks: dims (O8, C, 9 =
// (dy, dx)), boxes [3 dx][KC channels][64 outputs] with the 128-byte
// swizzle; zeros past C and O8
int weight_map(CUtensorMap* map, const void* w, int c, int o8) {
  const cuuint64_t dims[3] = {(cuuint64_t)o8, (cuuint64_t)c, 9};
  const cuuint64_t strides[2] = {(cuuint64_t)o8 * 2, (cuuint64_t)c * o8 * 2};
  const cuuint32_t box[3] = {64, KC, 3};
  return sm90::bf16_map(map, w, 3, dims, strides, box,
                        CU_TENSOR_MAP_SWIZZLE_128B);
}

// the same weights as dims (O8, C, 3 dx, 3 dy), boxes [3 dy][KC][64] of
// one dx: a ring tile's three blocks (dy, dx)
int tap_rows_map(CUtensorMap* map, const void* w, int c, int o8) {
  const cuuint64_t dims[4] = {(cuuint64_t)o8, (cuuint64_t)c, 3, 3};
  const cuuint64_t strides[3] = {(cuuint64_t)o8 * 2, (cuuint64_t)c * o8 * 2,
                                 (cuuint64_t)c * o8 * 6};
  const cuuint32_t box[4] = {64, KC, 1, 3};
  return sm90::bf16_map(map, w, 4, dims, strides, box,
                        CU_TENSOR_MAP_SWIZZLE_128B);
}

// x [N, H, W, C] with boxes (64 channels, 1 column, `rows` rows, 1): a
// column strip lands as `rows` rows of one position's 64 channels
int column_map(CUtensorMap* map, const void* x, int n, int h, int wd, int c,
               int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)wd, (cuuint64_t)h,
                              (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)c * 2, (cuuint64_t)wd * c * 2,
                                 (cuuint64_t)h * wd * c * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return sm90::bf16_map(map, x, 4, dims, strides, box,
                        CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int BN, int WGS, bool RING, typename OutT>
int launch_cfg(const void* x, const void* w, const float* b, OutT* y, Geo g,
               cudaStream_t stream) {
  using K = Cfg<BN, WGS, OutT>;
  static bool attr = false;
  static int per_sm = 0;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        slab_kernel<BN, WGS, RING, OutT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
    if (e != cudaSuccess) return (int)e;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, slab_kernel<BN, WGS, RING, OutT>, K::THREADS, K::SMEM);
    attr = true;
  }
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (sms < 1 || per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int o8 = (g.o + 7) / 8 * 8;
  CUtensorMap xmap, wmap, cmap, tmap;
  int err = sm90::nhwc_map(&xmap, x, g.n, g.h, g.wd, g.c, K::SEG);
  if (err == 0) err = weight_map(&wmap, w, g.c, o8);
  if (err == 0 && g.pad == PAD_FULL)
    err = column_map(&cmap, x, g.n, g.h, g.wd, g.c, K::SEG);
  if (err == 0 && g.pad == PAD_FULL) err = tap_rows_map(&tmap, w, g.c, o8);
  if (err != 0) return err;
  if (g.pad != PAD_FULL) cmap = tmap = wmap;   // not read
  // row tiles over the grid's columns 0 .. W - 1 (+ 2 under pad 2); with
  // ring tiles, over columns 1 .. W, and ring tiles over 0 and W + 1
  const int ext = g.pad == PAD_FULL ? 1 : 0;
  g.ho = g.h + 2 * ext;
  g.j_lo = RING ? 1 : 0;
  g.j_hi = RING ? g.wd : g.wd - 1 + 2 * ext;
  g.col_tiles = (g.j_hi - g.j_lo + K::BM) / K::BM;
  g.o_tiles = (g.o + BN - 1) / BN;
  g.strips = (g.ho + K::BM - 1) / K::BM;
  const long long tiles =
      (long long)g.col_tiles * g.n * g.ho * g.o_tiles +
      (RING ? 2LL * g.strips * g.n * g.o_tiles : 0);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  g.row_tiles = g.col_tiles * g.n * g.ho * g.o_tiles;
  // persistent: as many blocks as fit on the card at once, at most one a
  // tile
  const int blocks = tiles < sms * per_sm ? (int)tiles : sms * per_sm;
  slab_kernel<BN, WGS, RING, OutT><<<blocks, K::THREADS, K::SMEM, stream>>>(
      xmap, wmap, cmap, tmap, b, y, g);
  return (int)cudaGetLastError();
}

// The plan (bn, wgs) is ops/conv_cuda.py::k8a_plan's; it is checked
// here, not chosen.
template <bool RING, typename OutT>
int launch(const void* x, const void* w, const void* bias, void* y, int n,
           int h, int wd, int c, int o, int pad, int bn, int wgs, int ring,
           cudaStream_t stream) {
  if (n < 1 || h < 1 || wd < 1 || c < 8 || c % 8 || o < 1 || pad < 0 ||
      pad > PAD_FULL || ring < 0 || ring > 1 || (ring && pad != PAD_FULL))
    return (int)cudaErrorInvalidValue;
  if (pad == PAD_REFLECT && (h < 2 || wd < 2)) return (int)cudaErrorInvalidValue;
  if (bn == 80 && (o + 7) / 8 * 8 <= 64) return (int)cudaErrorInvalidValue;
  Geo g{};
  g.n = n; g.h = h; g.wd = wd; g.c = c; g.o = o; g.pad = pad;
  g.chunks = (c + KC - 1) / KC;
  auto* bp = static_cast<const float*>(bias);
  auto* yp = static_cast<OutT*>(y);
#define RNR_K8A(BN_, WGS_)                                                  \
  if (bn == BN_ && wgs == WGS_)                                             \
    return ring                                                             \
               ? launch_cfg<BN_, WGS_, RING, OutT>(x, w, bp, yp, g, stream)  \
               : launch_cfg<BN_, WGS_, false, OutT>(x, w, bp, yp, g, stream);
  RNR_K8A(64, 1) RNR_K8A(64, 2) RNR_K8A(80, 1) RNR_K8A(80, 2)
#undef RNR_K8A
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int rnr_conv3x3s(const void* x, const void* w, const void* bias,
                            void* y, int n, int h, int wd, int c, int o,
                            int pad, int bn, int wgs, int ring,
                            cudaStream_t stream) {
  if (pad == PAD_FULL) return (int)cudaErrorInvalidValue;
  return launch<false, bf16>(x, w, bias, y, n, h, wd, c, o, pad, bn, wgs,
                             ring, stream);
}

// The same conv with an f32 output: the dgrad of conv3x3s (no rounding of
// the data gradient to bf16 before the reflect fold).  Pad 2 (no bias) is
// the reflect dgrad: y holds N H W + N R rows of O; the full correlation's
// interior goes to the first N H W (dx), its ring to the rest, and
// fold_ring_kernel then adds the ring onto dx: dx is done.
extern "C" int rnr_conv3x3s_f32out(const void* x, const void* w,
                                   const void* bias, void* y, int n, int h,
                                   int wd, int c, int o, int pad, int bn,
                                   int wgs, int ring, cudaStream_t stream) {
  if (pad == PAD_FULL && (bias != nullptr || h < 2 || wd < 2))
    return (int)cudaErrorInvalidValue;    // the reflect dgrad: no bias
  const int e = launch<true, float>(x, w, bias, y, n, h, wd, c, o, pad, bn,
                                    wgs, ring, stream);
  if (e != 0 || pad != PAD_FULL) return e;
  return conv3::fold_ring(static_cast<float*>(y), n, h, wd, o, stream);
}
