// P1: a chain of matrix products summed in one accumulator,
//     y = bf16( sum over t < T of x . w[t] ),
// x [M, K8] bf16, w [T, K8, N8] bf16 (K8, N8 multiples of 8: the wrapper
// pads K and N with zeros), f32 accumulation, y [M, N] bf16.
//
// Replaces: tools/tpu_probe_r5.py  gemm_chain_pallas (:81) /
//   _gemm_chain_kernel (:67), the probe of section A that runs the 3x3
//   conv kernels' geometry (M = slab rows, T back-to-back products per
//   tile, as the 9 taps) as a bare GEMM chain.  It lies on no path of the
//   package; chip_smoke.py's kernels phase runs it at section A's shapes.
//   The TPU kernel keeps one [rows, K] x tile in VMEM per grid step and
//   the whole w.
//
// Bound on the H100: tensor-core operations at section A's shapes but the
//   first (2 M K N T operations against 2 (M K + T K N + M N) bytes:
//   0.010-0.040 ms a shape).  A library GEMM of the same function
//   multiplies x repeated T times along K, reading up to T times the x
//   bytes; here x is read once.
//
// Design: a persistent, warp-specialised GEMM on wgmma over TMA.  A tile
//   is BM = 128 MW GEMM rows (two consumer warpgroups of MW m64 blocks)
//   x BN = 64, 128 or 256 columns (BN follows N; MW = 2 below 256, 1 at
//   256).  The reduction runs over K chunks of 64: one TMA box of x
//   [BM, 64] (one 128-byte swizzled row a GEMM row, sm90.cuh) is loaded
//   once per chunk into an x ring and serves all T products of the chunk,
//   which read w[t]'s [64, BN] slice (BN / 64 swizzled [64][64] atoms,
//   MN-major) from a w ring of (chunk, t) units: the sum over t is just
//   more K into the same accumulators.  Where N fits one tile and all of
//   w's T x chunks units fit beside an x ring of at least two stages
//   (9 x 64 x 64 bf16 = 72 KB at K = N = 64), w is loaded once per block
//   and stays resident, so only x streams.  One producer thread keeps
//   both rings full through full / empty mbarriers and runs on into the
//   next tile (its warpgroup gives its registers to the consumers:
//   setmaxnreg 40 / 232); each consumer warpgroup issues 4 MW
//   m64nBNk16 products a unit, one unit behind the next (wait_group 1),
//   and releases a w stage once its unit's products are done, an x stage
//   once its chunk's last unit's are.  The epilogue stages each
//   warpgroup's 64 rows at a time in bf16 apart from the rings and stores
//   16 bytes a thread along N (elementwise where N % 8 != 0), while the
//   producer loads the next tile.  Tiles are walked n-tile fastest, so
//   the blocks sharing x rows run together.  The plan (BN, MW, w
//   residency, stages, grid) is ops/gemm_chain_cuda.py::gemm_chain_plan's,
//   checked here.
//
// Order of sums: per output, K chunk by K chunk, within a chunk t by t,
//   within a product 16-deep steps in the tensor core's order; no split
//   K, so the result is bitwise the same from run to run.  The plain
//   version sums t by t, each over all of K: another order of exact bf16
//   products in f32, one bf16 rounding at the end, within one rounding
//   step (2^-7 of max) of it.
//
// Ragged cases: K8 and N8 are the wrapper's zero padding; TMA writes
//   zeros past K8, N8 and M, so the last chunk's, tile's and columns'
//   padding is multiplied like the rest, and rows past M and columns past
//   N are not stored.
//
// Measured over section A's 8 shapes (chip_variants.py, NVIDIA H100 80GB
//   HBM3, 700 W): without the products the kernel takes 66% of its time,
//   with the loads after the first ring skipped 96%, without the output
//   stores 91%; w resident takes 92% of w streamed's time at the first
//   shape.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int KC = 64;             // K per chunk: one swizzled row
constexpr int WGS = 2;             // consumer warpgroups
constexpr int THREADS = 128 * (WGS + 1);   // + the producer's
constexpr int ATOM = KC * 128;     // one [64 k][64 n] bf16 atom of w
constexpr int MAX_XST = 4, MAX_WST = 8;
constexpr int BARS = 256;          // the barriers' bytes
constexpr int SMEM_LIMIT = 232448; // a block's shared memory on sm_90

template <int BN, int MW>
struct Cfg {
  static constexpr int BM = 64 * WGS * MW;
  static constexpr int NA = BN / 64;             // w atoms a unit
  static constexpr int X_STAGE = BM * 128;
  static constexpr int W_UNIT = NA * ATOM;
  // a warpgroup's 64 staged output rows of BN + 8 bf16: conflict-free
  // writes of 2 outputs a thread
  static constexpr int LDS = BN + 8;
  static constexpr int EPI = 64 * LDS * 2;
  static_assert(X_STAGE % 1024 == 0 && W_UNIT % 1024 == 0, "swizzle atoms");
};

struct Geo {
  int m, n, k8, n8, t;
  int chunks, n_tiles, tiles;
  int xst, wst;   // ring stages (wst: 0 where w is resident)
};

// the shared memory of a launch: 1024 bytes of alignment slack, the x
// ring, w's ring (or all of w), the epilogue's rows, the barriers; as
// ops/gemm_chain_cuda.py::gemm_chain_smem counts it
template <int BN, int MW>
int smem_of(const Geo& g, bool res) {
  using K = Cfg<BN, MW>;
  const int w = res ? g.t * g.chunks * K::W_UNIT : g.wst * K::W_UNIT;
  return 1024 + g.xst * K::X_STAGE + w + WGS * K::EPI + BARS;
}

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// x [M, K8] through xmap (boxes (64, BM), 128-byte swizzled), w [T, K8,
// N8] through wmap (boxes (64 columns, 64 k, 1)) -> y [M, N].  Persistent:
// block b walks tiles b, b + gridDim.x, ..; RES: w resident (one n tile).
template <int BN, int MW, bool RES>
__global__ void __launch_bounds__(THREADS, 1)
gemm_chain_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  bf16* __restrict__ y, const Geo g) {
  using K = Cfg<BN, MW>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t xring = sm90::smem_addr(smem);
  const uint32_t wring = xring + g.xst * K::X_STAGE;
  const int wbytes = RES ? g.t * g.chunks * K::W_UNIT : g.wst * K::W_UNIT;
  bf16* epi = reinterpret_cast<bf16*>(smem + g.xst * K::X_STAGE + wbytes);
  const uint32_t xfull = sm90::smem_addr(epi + WGS * K::EPI / 2);
  const uint32_t xempty = xfull + 8 * MAX_XST;
  const uint32_t wfull = xempty + 8 * MAX_XST;
  const uint32_t wempty = wfull + 8 * MAX_WST;
  const uint32_t wres = wempty + 8 * MAX_WST;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < g.xst; ++s) {
      sm90::mbar_init(xfull + 8 * s, 1);
      sm90::mbar_init(xempty + 8 * s, 128 * WGS);
    }
    for (int s = 0; s < g.wst; ++s) {
      sm90::mbar_init(wfull + 8 * s, 1);
      sm90::mbar_init(wempty + 8 * s, 128 * WGS);
    }
    sm90::mbar_init(wres, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == WGS) {
    // ---- producer: one thread issues every TMA load ----
    sm90::setmaxnreg_dec<40>();
    if (tid % 128 != 0) return;
    if constexpr (RES) {
      // all of w's units of the one n tile, once
      sm90::mbar_arrive_tx(wres, g.t * g.chunks * K::W_UNIT);
      for (int t = 0; t < g.t; ++t)
        for (int c = 0; c < g.chunks; ++c)
          for (int a = 0; a < K::NA; ++a)
            sm90::tma_load_3d(
                wring + (t * g.chunks + c) * K::W_UNIT + a * ATOM, &wmap,
                64 * a, c * KC, t, wres);
    }
    int xi = 0, wi = 0;   // chunks and units issued, over every tile
#pragma unroll 1
    for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
      const int n0 = tile % g.n_tiles * BN;
      const int m0 = tile / g.n_tiles * K::BM;
#pragma unroll 1
      for (int c = 0; c < g.chunks; ++c, ++xi) {
        const int xs = xi % g.xst;
        if (xi >= g.xst)
          sm90::mbar_wait(xempty + 8 * xs, (xi / g.xst - 1) & 1);
        sm90::mbar_arrive_tx(xfull + 8 * xs, K::X_STAGE);
        sm90::tma_load_2d(xring + xs * K::X_STAGE, &xmap, c * KC, m0,
                          xfull + 8 * xs);
        if constexpr (!RES) {
#pragma unroll 1
          for (int t = 0; t < g.t; ++t, ++wi) {
            const int ws = wi % g.wst;
            if (wi >= g.wst)
              sm90::mbar_wait(wempty + 8 * ws, (wi / g.wst - 1) & 1);
            sm90::mbar_arrive_tx(wfull + 8 * ws, K::W_UNIT);
            for (int a = 0; a < K::NA; ++a)
              sm90::tma_load_3d(wring + ws * K::W_UNIT + a * ATOM, &wmap,
                                n0 + 64 * a, c * KC, t, wfull + 8 * ws);
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: MW m64 blocks of the tile's rows each ----
  sm90::setmaxnreg_inc<232>();
  const int lane = tid % 32, t128 = tid % 128;
  const int rbase = t128 / 32 * 16 + lane / 4;     // of a block's 64 rows
  bf16* es = epi + wg * 64 * K::LDS;
  const bool vec = g.n % 8 == 0;
  float acc[MW][BN / 2];
  if constexpr (RES) sm90::mbar_wait(wres, 0);
  int xi = 0, wi = 0;
#pragma unroll 1
  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
    const int n0 = tile % g.n_tiles * BN;
    const int m0 = tile / g.n_tiles * K::BM;
#pragma unroll
    for (int i = 0; i < MW; ++i)
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[i][j] = 0.f;
    int u = 0;   // units of this tile
#pragma unroll 1
    for (int c = 0; c < g.chunks; ++c, ++xi) {
      const int xs = xi % g.xst;
      sm90::mbar_wait(xfull + 8 * xs, (xi / g.xst) & 1);
      const uint32_t xa = xring + xs * K::X_STAGE + wg * MW * 64 * 128;
#pragma unroll 1
      for (int t = 0; t < g.t; ++t, ++u) {
        uint32_t wa;
        if constexpr (RES) {
          wa = wring + (t * g.chunks + c) * K::W_UNIT;
        } else {
          const int ws = wi % g.wst;
          sm90::mbar_wait(wfull + 8 * ws, (wi / g.wst) & 1);
          wa = wring + ws * K::W_UNIT;
        }
#pragma unroll
        for (int i = 0; i < MW; ++i) sm90::fence_regs(acc[i]);
        sm90::wgmma_fence();
        // A: block i's 64 rows, 16 of the chunk's K from 16 ks (K-major);
        // B: w[t]'s [16, BN] rows 16 ks .. (MN-major, atoms ATOM apart)
#pragma unroll
        for (int ks = 0; ks < KC / 16; ++ks)
#pragma unroll
          for (int i = 0; i < MW; ++i)
            sm90::wgmma<0, 1>(
                acc[i], sm90::desc_sw128(xa + i * 64 * 128 + ks * 32, 16, 1024),
                sm90::desc_sw128(wa + ks * 16 * 128, ATOM, 1024));
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();       // the unit before is done
#pragma unroll
        for (int i = 0; i < MW; ++i) sm90::fence_regs(acc[i]);
        if (u > 0) {
          if constexpr (!RES)
            sm90::mbar_arrive(wempty + 8 * ((wi - 1) % g.wst));
          if (t == 0) sm90::mbar_arrive(xempty + 8 * ((xi - 1) % g.xst));
        }
        if constexpr (!RES) ++wi;
      }
    }
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < MW; ++i) sm90::fence_regs(acc[i]);
    if constexpr (!RES) sm90::mbar_arrive(wempty + 8 * ((wi - 1) % g.wst));
    sm90::mbar_arrive(xempty + 8 * ((xi - 1) % g.xst));

    // ---- epilogue, per warpgroup and block: its 64 rows -> staged bf16
    //      rows -> 16-byte stores along N; the producer loads meanwhile ----
#pragma unroll
    for (int i = 0; i < MW; ++i) {
      sm90::bar_sync(1 + wg, 128);   // the last block's stores read es
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
#pragma unroll
        for (int v = 0; v < 2; ++v)
          store_pair(es + (rbase + 8 * v) * K::LDS + col, acc[i][4 * j + 2 * v],
                     acc[i][4 * j + 2 * v + 1]);
      }
      sm90::bar_sync(1 + wg, 128);
      const int r0 = m0 + (wg * MW + i) * 64;
      for (int e = t128; e < 64 * (BN / 8); e += 128) {
        const int mr = e / (BN / 8), cv = e % (BN / 8) * 8;
        const int row = r0 + mr, oc = n0 + cv;
        if (row >= g.m || oc >= g.n) continue;
        const bf16* src = es + mr * K::LDS + cv;
        bf16* dst = y + (size_t)row * g.n + oc;
        if (vec) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int q = 0; q < 8 && oc + q < g.n; ++q) dst[q] = src[q];
        }
      }
    }
  }
}

template <int BN, int MW, bool RES>
int launch_cfg(const void* x, const void* w, bf16* y, const Geo& g,
               int grid, cudaStream_t stream) {
  using K = Cfg<BN, MW>;
  const int smem = smem_of<BN, MW>(g, RES);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_chain_kernel<BN, MW, RES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[2] = {(cuuint64_t)g.k8, (cuuint64_t)g.m};
  const cuuint64_t xstr[1] = {(cuuint64_t)g.k8 * 2};
  const cuuint32_t xbox[2] = {KC, (cuuint32_t)K::BM};
  int err = sm90::bf16_map(&xmap, x, 2, xdims, xstr, xbox,
                           CU_TENSOR_MAP_SWIZZLE_128B);
  const cuuint64_t wdims[3] = {(cuuint64_t)g.n8, (cuuint64_t)g.k8,
                               (cuuint64_t)g.t};
  const cuuint64_t wstr[2] = {(cuuint64_t)g.n8 * 2,
                              (cuuint64_t)g.k8 * g.n8 * 2};
  const cuuint32_t wbox[3] = {64, KC, 1};
  if (err == 0)
    err = sm90::bf16_map(&wmap, w, 3, wdims, wstr, wbox,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  gemm_chain_kernel<BN, MW, RES><<<grid, THREADS, smem, stream>>>(
      xmap, wmap, y, g);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, K8] bf16, w [T, K8, N8] bf16 (N8 = N rounded up to 8) -> y [M, N]
// bf16.  The plan (bn, mw, res, xst, wst, grid) is
// ops/gemm_chain_cuda.py::gemm_chain_plan's; it is checked here, not
// chosen.
extern "C" int rnr_gemm_chain(const void* x, const void* w, void* y, int m,
                              int k8, int n, int taps, int bn, int mw,
                              int res, int xst, int wst, int grid,
                              cudaStream_t stream) {
  if (m < 1 || k8 < 8 || k8 % 8 || n < 1 || taps < 1 || grid < 1 ||
      xst < 2 || xst > MAX_XST || res < 0 || res > 1 ||
      (res ? wst != 0 : wst < 2 || wst > MAX_WST) ||
      !((bn == 64 || bn == 128) && mw == 2) && !(bn == 256 && mw == 1))
    return (int)cudaErrorInvalidValue;
  Geo g{};
  g.m = m; g.n = n; g.k8 = k8; g.n8 = (n + 7) / 8 * 8; g.t = taps;
  g.chunks = (k8 + KC - 1) / KC;
  g.n_tiles = (g.n8 + bn - 1) / bn;
  g.xst = xst; g.wst = wst;
  if (res && g.n_tiles != 1) return (int)cudaErrorInvalidValue;
  const long long m_tiles = ((long long)m + 128 * mw - 1) / (128 * mw);
  const long long tiles = m_tiles * g.n_tiles;
  if (tiles > 0x7fffffff || grid > tiles) return (int)cudaErrorInvalidValue;
  g.tiles = (int)tiles;
  auto* yp = static_cast<bf16*>(y);
#define RNR_P1(BN_, MW_)                                                    \
  if (bn == BN_ && mw == MW_)                                               \
    return res ? launch_cfg<BN_, MW_, true>(x, w, yp, g, grid, stream)      \
               : launch_cfg<BN_, MW_, false>(x, w, yp, g, grid, stream);
  RNR_P1(64, 2) RNR_P1(128, 2) RNR_P1(256, 1)
#undef RNR_P1
  return (int)cudaErrorInvalidValue;
}
