// K8b: the weight gradient of the 3x3 stride-1 convolution in the slab
// formulation:
//     dWcat[dy*C + c, dx*O + o] = sum over n, i, j' of
//                                 xp[n, i + dy, j', c] * g[n, i, j' - dx, o]
// over the W + 2 slab columns j' (g is zero outside [0, W)), unpacked to
// dW [3, 3, C, O] f32 (the block (dy, dx) of dWcat is dW[dy, dx]).  NHWC
// bf16 input x and output gradient g (C and O multiples of 8: the wrapper
// pads other counts with zero channels), f32 sums.  xp is x under a ring
// of zero ("same") or reflect padding, applied while x is staged: neither
// the slab [N, H, W+2, 3C] nor the shifted gradient g3 [N, H, W+2, 3O] is
// built.
//
// Replaces: rnr_tpu/ops/conv_pallas.py  _conv3x3_slab_wgrad_impl (:982) /
//   _slab_wgrad_kernel (:961).  The TPU kernel zeroes its one [KC, 3O]
//   output block at grid step (0, 0) and adds every tile's product into
//   it across its sequential grid; XLA builds the slab and g3 in HBM.  On
//   the card blocks run at the same time, so that accumulation becomes
//   split-K: each block sums its own run of pixels into a partial, and a
//   second kernel adds the partials in split order.  No atomics: two runs
//   on the same inputs give bitwise equal results.
//
// Bound on the H100: tensor-core operations (the 14 weight gradients of a
//   512^2 frame are about 0.45 TFLOP, 0.44 ms at 989 TFLOP/s, against
//   about 0.2 GB of activations).  Measured on the H100
//   (chip_variants.py, the frame's 14 shapes): with its products, its
//   loads after the first ring or its split sum switched off it takes
//   70%, 80% and 92% of its time.
//
// Design: wgmma with both operands MN-major in shared memory, fed by TMA.
//   A block owns the slab's tile of dWcat: 64 channels of band dy x the
//   three dx bands of 64 outputs, in three m64n64 accumulators of its one
//   warpgroup.  Pixels are walked in units of 64 columns j of one image
//   row i: per unit one TMA box brings the band of xp's row i + dy - 1,
//   slab columns j0 .. j0 + 65 (x columns j0 - 1 ..), and one the g tile
//   of columns j0 .. j0 + 63, 128-byte swizzled rows (sm90.cuh).  Slab
//   column j + dx pairs with g column j in band dx, so the dx block reads
//   the staged band through its descriptor moved down dx rows: one band
//   and one g tile feed all three (dx, o) blocks.  TMA writes zeros
//   outside the tensor: zero padding, columns past W (g = 0 there) and
//   channels past C or O cost nothing.  Reflect takes the row by index
//   and the warpgroup patches its band's column -1 / W from column 1 / W
//   - 2 in shared memory on a row's first and last unit.  Thread 0 keeps
//   a ring of 4 stages full; a stage takes its next unit once the
//   warpgroup has waited for all of this unit's 12 products (waiting for
//   the last but one lets ptxas serialise them, C7515).  Three blocks an
//   SM (70 KB of shared memory each) overlap one block's waits with the
//   others' products.  Split-K: the plan is fixed by the shapes alone
//   (ops/conv_cuda.py::k8b_plan), at most one wave of three blocks an
//   SM, each split a run of whole units; the partials are summed in split
//   order by a second kernel in the same C call.
//
// What ragged and reflect cases cost: C = 108 and O = 78 are padded to
//   112 / 80 by the wrapper (a copy each); channel tiles past C or O
//   multiply zeros (O = 80: the second tile is 16 / 64 full); W not a
//   multiple of 64 wastes the last unit's columns (half at 32^2); the g
//   tile is staged once per band dy (three times per unit and tile pair).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "conv3x3_common.cuh"
#include "sm90.cuh"

namespace {

using conv3::bf16;

constexpr int BK = 64;         // output columns of one row per unit
constexpr int CT = 64;         // channels of band dy per block (dWcat rows)
constexpr int BN = 64;         // outputs per dx band (dWcat columns / 3)
constexpr int STAGES = 4;
constexpr int THREADS = 128;   // one warpgroup

constexpr int SEG = BK + 2;                       // band rows (slab columns)
constexpr int X_BAND = (SEG * 128 + 1023) / 1024 * 1024;
constexpr int G_BYTES = BK * 128;
constexpr int TX = SEG * 128 + G_BYTES;           // TMA bytes per unit
constexpr int STAGE = X_BAND + G_BYTES;
constexpr int SMEM = STAGES * STAGE + STAGES * 8 + 1024;

// x [N, H, W, C] through xmap (boxes (64 channels, 66 columns, 1, 1)), g
// [N, H, W, O] through gmap (boxes (64 outputs, 64 columns, 1, 1)), both
// 128-byte swizzled -> part[split] [3, 3, C, O], the sums over the units
// [split * per, split * per + per) of all images' rows.  Block (band dy x
// channel tile, output tile, split).
__global__ void __launch_bounds__(THREADS, 3)
slab_wgrad_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap gmap,
                  float* __restrict__ part, int n, int h, int wd, int c,
                  int o, int reflect, int per) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  // full[s]: the unit's TMA bytes landed
  const uint32_t full_bar = sm90::smem_addr(smem + STAGES * STAGE);
  const int tid = threadIdx.x;
  const int c_tiles = (c + CT - 1) / CT;
  const int dy = blockIdx.x / c_tiles;
  const int ct0 = (blockIdx.x - dy * c_tiles) * CT, o0 = blockIdx.y * BN;
  const int split = blockIdx.z;
  const int cpr = (wd + BK - 1) / BK;               // units per row
  const int total = n * h * cpr;
  const int ubeg = split * per;
  const int units = (ubeg + per < total ? ubeg + per : total) - ubeg;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) sm90::mbar_init(full_bar + 8 * s, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  auto unit_at = [&](int u, int& img, int& i, int& j0) {
    const int uid = ubeg + u;
    img = uid / (h * cpr);
    const int rem = uid - img * h * cpr;
    i = rem / cpr;
    j0 = (rem - i * cpr) * BK;
  };
  // thread 0 issues a unit's loads: band dy of xp and the g tile
  auto load = [&](int u) {
    const int s = u % STAGES;
    int img, i, j0;
    unit_at(u, img, i, j0);
    const uint32_t st = sm90::smem_addr(smem + s * STAGE);
    const uint32_t bar = full_bar + 8 * s;
    sm90::mbar_arrive_tx(bar, TX);
    const int row = reflect ? conv3::reflect(i + dy - 1, h) : i + dy - 1;
    sm90::tma_load_4d(st, &xmap, ct0, j0 - 1, row, img, bar);
    sm90::tma_load_4d(st + X_BAND, &gmap, o0, j0, i, img, bar);
  };
  if (tid == 0)
    for (int u = 0; u < STAGES && u < units; ++u) load(u);

  float acc[3][BN / 2];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[dx][i] = 0.f;
#pragma unroll 1
  for (int u = 0; u < units; ++u) {
    const int s = u % STAGES;
    sm90::mbar_wait(full_bar + 8 * s, (u / STAGES) & 1);
    unsigned char* band = smem + s * STAGE;
    if (reflect) {
      // xp's column -1 is column 1 and column W is column W - 2: patched
      // (zeros from TMA) on a row's first and last unit, before the
      // products read the band
      int img, i, j0;
      unit_at(u, img, i, j0);
      if (j0 == 0 || j0 + BK >= wd) {
        if (tid < 8 && j0 == 0) sm90::sw128_copy_chunk(band, 0, 2, tid);
        if (tid >= 8 && tid < 16 && j0 + BK >= wd)
          sm90::sw128_copy_chunk(band, wd - j0 + 1, wd - j0 - 1, tid - 8);
        sm90::fence_async_shared();
        __syncthreads();
      }
    }
    const uint32_t xa = sm90::smem_addr(band);
    const uint32_t ga = xa + X_BAND;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) sm90::fence_regs(acc[dx]);
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      // A = band^T: 64 channels (the row) x 16 slab columns from 16 ks +
      // dx (MN-major); B = g: 16 columns x 64 outputs (MN-major)
      const uint64_t db = sm90::desc_sw128(ga + ks * 16 * 128, 8192, 1024);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const uint64_t da =
            sm90::desc_sw128(xa + (ks * 16 + dx) * 128, 8192, 1024);
        sm90::wgmma<1, 1>(acc[dx], da, db);
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) sm90::fence_regs(acc[dx]);
    // every warp's products of stage s are done: it takes unit u + STAGES
    __syncthreads();
    if (tid == 0 && u + STAGES < units) load(u + STAGES);
  }

  // ---- epilogue: the three dx blocks -> the split's partial dW[dy, dx] ----
  const int lane = tid % 32, r = tid / 32 * 16 + lane / 4;
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    float* dst = part + ((size_t)split * 9 + dy * 3 + dx) * c * o;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int oc = o0 + 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int ci = ct0 + r + 8 * v;
        if (ci < c && oc < o)
          *reinterpret_cast<float2*>(dst + (size_t)ci * o + oc) =
              make_float2(acc[dx][4 * j + 2 * v], acc[dx][4 * j + 2 * v + 1]);
      }
    }
  }
}

}  // namespace

// x [N, H, W, C] bf16, g [N, H, W, O] bf16 (C, O multiples of 8) -> dw
// [3, 3, C, O] f32.  The N H ceil(W / 64) units of 64 columns of a row are
// cut into `splits` runs of `per` units; with splits > 1, `part` is
// scratch of splits * 9 * C * O floats and a second kernel sums it into dw
// in split order; with splits == 1 the one pass writes dw and `part` is
// not read.
extern "C" int rnr_conv3x3s_wgrad(const void* x, const void* g, void* part,
                                  void* dw, int n, int h, int wd, int c,
                                  int o, int reflect, int splits, int per,
                                  cudaStream_t stream) {
  if (n < 1 || h < 1 || wd < 1 || c < 8 || c % 8 || o < 8 || o % 8)
    return (int)cudaErrorInvalidValue;
  if (reflect && (h < 2 || wd < 2)) return (int)cudaErrorInvalidValue;
  const long long units = (long long)n * h * ((wd + BK - 1) / BK);
  if (splits < 1 || splits > 65535 || per < 1 ||
      (long long)splits * per < units || (long long)(splits - 1) * per >= units)
    return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        slab_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  CUtensorMap xmap, gmap;
  int e = sm90::nhwc_map(&xmap, x, n, h, wd, c, SEG);
  if (e == 0) e = sm90::nhwc_map(&gmap, g, n, h, wd, o, BK);
  if (e != 0) return e;
  float* dst = static_cast<float*>(splits > 1 ? part : dw);
  dim3 grid((unsigned)(3 * ((c + CT - 1) / CT)), (unsigned)((o + BN - 1) / BN),
            (unsigned)splits);
  slab_wgrad_kernel<<<grid, THREADS, SMEM, stream>>>(
      xmap, gmap, dst, n, h, wd, c, o, reflect, per);
  e = (int)cudaGetLastError();
  if (e != 0 || splits == 1) return e;
  return conv3::sum_splits(part, dw, 9LL * c * o, splits, stream);
}
