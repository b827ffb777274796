// K3b: weight gradient of the 3x3 stride-1 convolution:
//     dW[dy, dx, c, o] = sum over n, h, w of  x_pad[n, h+dy, w+dx, c] * g[n, h, w, o]
// NHWC bf16 input x and output gradient g (C and O multiples of 8: the
// wrapper pads other counts with zero channels), f32 sums, f32
// [3, 3, C, O] output.  x_pad is x under zero ("same") or reflect
// padding, applied while x is staged: no padded copy of x is made.
//
// Replaces: rnr_tpu/ops/conv_pallas.py  _conv3x3_wgrad_impl (:308) /
//   _wgrad_kernel (:272).  The TPU kernel adds every row tile into one
//   revisited [3, 3, C, O] output block across its sequential grid.
//   CUDA blocks run at the same time, so that accumulation becomes
//   split-K: each block sums its own slice of pixels into a partial, and
//   a second kernel adds the partials in split order.  No atomics: two
//   runs on the same inputs give bitwise equal results.
//
// Bound on the H100: tensor-core operations.  Per tap a GEMM with M x N
//   = C x O and a deep K = N*H*W (262,144 at 512^2); the 14 weight
//   gradients of a 512^2 frame are about 0.45 TFLOP (0.44 ms at 989
//   TFLOP/s) against about 0.2 GB of activations.
//
// Design: wgmma with both operands MN-major in shared memory, fed by TMA.
//   Pixels are walked in units of 64 columns of one image row.  Tap (dy,
//   dx) pairs g at column j with x_pad at row i + dy - 1, column j + dx -
//   1, so a unit stages one band of 66 x columns per dy (64 channels) and
//   one g tile (64 outputs), each one TMA box of 128-byte swizzled rows
//   (sm90.cuh); tap dx is the dy band's descriptor moved down dx rows.  So
//   one staged x band and one g tile feed all nine taps of the block (the
//   earlier design staged both once per tap).  TMA writes zeros outside
//   the tensor: zero padding, columns past W (g = 0 there, so they add
//   exact zeros) and channel tiles past C or O cost nothing.  Reflect
//   takes the row by index and patches the band's column -1 / W from
//   column 1 / W - 2 in shared memory (the consumer warpgroup that reads
//   the band, only on a row's first and last unit).  A block owns one
//   64 x 64 tile of dW for all nine taps: three warpgroups, one per dy,
//   each holding three m64n64k16 accumulators (96 registers: a wider
//   tile spills); thread 0 keeps a ring of 4 stages full by TMA, through
//   full / empty mbarriers, so the next three units' copies fly while the
//   warpgroups run a unit's 36 products.  Splits: fixed by the shapes
//   alone (ops/conv_cuda.py::k3b_plan), at most one wave of blocks, each
//   a run of whole units; partials summed in split order.
//
// What ragged and reflect cases cost: C = 108 (x of the first conv) and
//   O = 78 (g of the last conv) are padded to 112 / 80 by the wrapper
//   (a copy each); C or O tiles past C or O multiply zeros (O = 80: the
//   second tile is 16 / 64 full); W not a multiple of 64 wastes the last
//   unit's columns past W (none at 512^2 .. 64^2, half at 32^2); reflect
//   costs 16 16-byte copies per band and a warpgroup barrier on each
//   row's first and last unit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "conv3x3_common.cuh"
#include "sm90.cuh"

namespace {

using conv3::bf16;

constexpr int BK = 64;         // output columns of one row per unit
constexpr int CT = 64;         // input channels per block (dW rows)
constexpr int BN = 64;         // outputs per block (dW columns)
constexpr int STAGES = 4;
constexpr int THREADS = 384;   // three warpgroups, one per dy

constexpr int SEG = BK + 2;                       // band rows (positions)
constexpr int X_BAND = (SEG * 128 + 1023) / 1024 * 1024;
constexpr int X_BYTES = 3 * X_BAND;
constexpr int G_BYTES = BK * 128;
constexpr int TX = 3 * SEG * 128 + G_BYTES;        // TMA bytes per unit
constexpr int STAGE = X_BYTES + G_BYTES;
constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;

// x [N, H, W, C] through xmap (boxes (64 channels, 66 columns, 1, 1)), g
// [N, H, W, O] through gmap (boxes (64 outputs, 64 columns, 1, 1)), both
// 128-byte swizzled -> part[split] [9, C, O], the sums over the units
// [split * cps, split * cps + cps) of all images' rows.
__global__ void __launch_bounds__(THREADS)
wgrad_kernel(const __grid_constant__ CUtensorMap xmap,
             const __grid_constant__ CUtensorMap gmap, float* __restrict__ part,
             int n, int h, int wd, int c, int o, int reflect, int cps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  // full[s]: the unit's TMA bytes landed; empty[s]: the consumers are
  // done with the stage
  const uint32_t full_bar = sm90::smem_addr(smem + STAGES * STAGE);
  const uint32_t empty_bar = full_bar + 8 * STAGES;
  const int tid = threadIdx.x;
  const int ct0 = blockIdx.x * CT, o0 = blockIdx.y * BN;
  const int split = blockIdx.z;
  const int cpr = (wd + BK - 1) / BK;               // units per row
  const int total = n * h * cpr;
  const int ubeg = split * cps;
  const int units = (ubeg + cps < total ? ubeg + cps : total) - ubeg;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(full_bar + 8 * s, 1);
      sm90::mbar_init(empty_bar + 8 * s, THREADS);
    }
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
  // thread 0 issues a unit's loads: three x bands and a g tile
  auto load = [&](int u) {
    const int s = u % STAGES;
    int img, i, j0;
    unit_at(u, img, i, j0);
    const uint32_t st = sm90::smem_addr(smem + s * STAGE);
    const uint32_t bar = full_bar + 8 * s;
    sm90::mbar_arrive_tx(bar, TX);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int row = reflect ? conv3::reflect(i + dy - 1, h) : i + dy - 1;
      sm90::tma_load_4d(st + dy * X_BAND, &xmap, ct0, j0 - 1, row, img, bar);
    }
    sm90::tma_load_4d(st + X_BYTES, &gmap, o0, j0, i, img, bar);
  };
  if (tid == 0)
    for (int u = 0; u < STAGES && u < units; ++u) load(u);

  // ---- three warpgroups: dy = warpgroup, taps (dy, 0 .. 2) ----
  float acc[3][BN / 2];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[dx][i] = 0.f;
  const int dy = tid / 128;
#pragma unroll 1
  for (int u = 0; u < units; ++u) {
    const int s = u % STAGES;
    sm90::mbar_wait(full_bar + 8 * s, (u / STAGES) & 1);
    unsigned char* band = smem + s * STAGE + dy * X_BAND;
    if (reflect) {
      // x_pad column -1 is column 1 and column W is column W - 2: this
      // warpgroup patches its own band (zeros from TMA) on a row's first
      // and last unit, before its products read it
      int img, i, j0;
      unit_at(u, img, i, j0);
      if (j0 == 0 || j0 + BK >= wd) {
        const int t = tid % 128;
        if (t < 8 && j0 == 0) sm90::sw128_copy_chunk(band, 0, 2, t);
        if (t >= 8 && t < 16 && j0 + BK >= wd)
          sm90::sw128_copy_chunk(band, wd - j0 + 1, wd - j0 - 1, t - 8);
        sm90::fence_async_shared();
        sm90::bar_sync(1 + dy, 128);
      }
    }
    const uint32_t xa = sm90::smem_addr(band);
    const uint32_t ga = sm90::smem_addr(smem + s * STAGE + X_BYTES);
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) sm90::fence_regs(acc[dx]);
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      // A = x^T: 64 channels (the row) x 16 positions from 16 ks + dx
      // (MN-major); B = g: 16 positions x 64 outputs (MN-major)
      const uint64_t db = sm90::desc_sw128(ga + ks * 16 * 128, 8192, 1024);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const uint64_t da =
            sm90::desc_sw128(xa + (ks * 16 + dx) * 128, 8192, 1024);
        sm90::wgmma<1, 1>(acc[dx], da, db);
      }
    }
    sm90::wgmma_commit();
    // all of this unit's products done (waiting for the last but one
    // group instead lets the compiler serialise the 36 products: C7515)
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) sm90::fence_regs(acc[dx]);
    sm90::mbar_arrive(empty_bar + 8 * s);
    // the stage, free once every warpgroup is done with it, takes unit
    // u + STAGES
    if (tid == 0 && u + STAGES < units) {
      sm90::mbar_wait(empty_bar + 8 * s, (u / STAGES) & 1);
      load(u + STAGES);
    }
  }

  // ---- epilogue: this warpgroup's three taps -> the split's partial ----
  const int lane = tid % 32, row = (tid % 128) / 32 * 16 + lane / 4;
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    float* dst = part + ((size_t)split * 9 + dy * 3 + dx) * c * o;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int oc = o0 + 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int ci = ct0 + row + 8 * v;
        if (ci < c && oc < o)
          *reinterpret_cast<float2*>(dst + (size_t)ci * o + oc) =
              make_float2(acc[dx][4 * j + 2 * v], acc[dx][4 * j + 2 * v + 1]);
      }
    }
  }
}

int launch(const bf16* x, const bf16* g, float* dst, int n, int h, int wd,
           int c, int o, int reflect, int splits, int cps,
           cudaStream_t stream) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  CUtensorMap xmap, gmap;
  int e = sm90::nhwc_map(&xmap, x, n, h, wd, c, SEG);
  if (e == 0) e = sm90::nhwc_map(&gmap, g, n, h, wd, o, BK);
  if (e != 0) return e;
  dim3 grid((unsigned)((c + CT - 1) / CT), (unsigned)((o + BN - 1) / BN),
            (unsigned)splits);
  wgrad_kernel<<<grid, THREADS, SMEM, stream>>>(xmap, gmap, dst, n, h, wd, c,
                                                o, reflect, cps);
  return (int)cudaGetLastError();
}

}  // namespace

// x [N, H, W, C] bf16, g [N, H, W, O] bf16 (C, O multiples of 8) -> dw
// [3, 3, C, O] f32.  The N H ceil(W / 64) units of 64 columns of a row
// are cut into `splits` runs of `chunk` / 64 units (`chunk` a multiple
// of 64); with splits > 1, `part` is scratch of splits * 9 * C * O floats
// and a second kernel reduces it into dw; with splits == 1 the one pass
// writes dw and `part` is not read.
extern "C" int rnr_conv3x3_wgrad(const void* x, const void* g, void* part,
                                 void* dw, int n, int h, int wd, int c, int o,
                                 int reflect, int splits, int chunk,
                                 cudaStream_t stream) {
  if (n < 1 || h < 1 || wd < 1 || c < 8 || c % 8 || o < 8 || o % 8)
    return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > 65535 || chunk < BK || chunk % BK)
    return (int)cudaErrorInvalidValue;
  const long long units = (long long)n * h * ((wd + BK - 1) / BK);
  const int cps = chunk / BK;
  if ((long long)splits * cps < units) return (int)cudaErrorInvalidValue;
  float* dst = static_cast<float*>(splits > 1 ? part : dw);
  auto* xp = static_cast<const bf16*>(x);
  auto* gp = static_cast<const bf16*>(g);
  const int e = launch(xp, gp, dst, n, h, wd, c, o, reflect, splits, cps, stream);
  if (e != 0 || splits == 1) return e;
  return conv3::sum_splits(part, dw, 9LL * c * o, splits, stream);
}
