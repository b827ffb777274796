// K3: 3x3 stride-1 convolution, NHWC bf16 input, HWIO bf16 weights, f32
// accumulation, + bias in f32, bf16 output (rnr_conv3x3) or f32 output
// (rnr_conv3x3_f32out, the data gradient: the same kernel run on the
// output gradient with rotated, io-transposed weights, as
// conv_pallas.py:409-451 runs _conv3x3_fwd_impl).  Zero ("same") or
// reflect padding is applied while the input is staged: no padded copy
// of the input is made.
//
// Replaces: rnr_tpu/ops/conv_pallas.py  conv3x3 (:379) /
//   _conv3x3_fwd_impl (:192) / _conv_kernel (:158), the implicit-GEMM
//   3x3 conv of every U-Net level under conv_backend=pallas3, pallas and
//   p3s4.  The TPU kernel pre-pads in XLA, DMAs row halos and falls back
//   to XLA past a VMEM budget; this kernel takes every shape with C a
//   multiple of 8 (the wrapper pads other C with zero channels) and any
//   O, with no fallback.
//
// Bound on the H100: tensor-core operations.  The 14 convs of one 512^2
//   frame are about 0.45 TFLOP (0.46 ms at 989 TFLOP/s) against about
//   0.2 GB of activations (0.06 ms at 3.35 TB/s).
//
// Design: implicit GEMM on wgmma, fed by TMA.  A block owns BM = 64 or
//   128 consecutive output columns of one image row (GEMM rows) and BN =
//   64, 80 (O = 78: one tile) or 128 output channels; the reduction runs
//   over 9 taps x C in units of (64 channels, tap row dy).  For a unit,
//   one TMA box brings the band of BM + 2 input columns of row i + dy - 1
//   (64 channels, 128-byte swizzled rows, sm90.cuh) and one box per 64
//   outputs the three taps' weights [3][64, 64].  The band serves all
//   three taps dx of its row: tap dx is the band's descriptor moved down
//   dx rows, so each input element is staged 3 times per output tile,
//   not 9.  TMA writes zeros outside the tensor: zero padding, the
//   columns of a tile past W and channel tiles past C cost nothing.
//   Reflect takes the input row by index and a second producer warp
//   copies the band's column 1 / W - 2 into column -1 / W on a row's
//   first and last tile.  Warp-specialised: one producer warpgroup (a TMA
//   warp and that patch warp) keeps a ring of 3 or 4 stages full through
//   full / empty mbarriers, and 1 or 2 consumer warpgroups each issue 12
//   m64nBNk16 wgmma per unit (3 taps x 4 steps of 16 channels), f32
//   accumulators in registers, one unit behind the next (wait_group 1).
//   The host takes BM 64 (and BN 64) where BM 128 gives fewer blocks than
//   SMs (the 32^2 and 64^2 levels).  Epilogue: accumulators -> shared
//   memory -> + bias in f32 -> 16-byte stores along O (elementwise where
//   O's rows are not 16-byte multiples: O = 78 in bf16).  Fixed order of
//   sums: bitwise equal results from run to run.
//
// The data gradient under reflect padding (pad = 2, "full"): the full
//   correlation of g with a 2-pixel zero ring, (H + 2) x (W + 2) outputs,
//   read from g by TMA's zeros (no F.pad(g) in device memory); the
//   interior outputs go straight to dx, the ring to a side buffer that
//   fold_ring_kernel (conv3x3_common.cuh) adds onto dx's border lines
//   with the exact adjoint of reflect-pad, in ops/conv_cuda.py::_dgrad's
//   order of adds; both launched by one call of rnr_conv3x3_f32out.
//
// What ragged and reflect cases cost: C % 8 != 0 (C = 108 on the first
//   conv) is padded to a multiple of 8 by the wrapper (a copy of x); O
//   % 8 != 0 pads the weights (a few KB) and wastes BN - O columns; W
//   not a multiple of BM wastes the last tile's columns (half the
//   products at 32^2); the reflect dgrad's W + 2 columns take one more
//   column tile per row for the 2 ring columns (a fifth at 512^2, a third
//   at 256^2); reflect costs the patch warp's 16 copies of 16 bytes per
//   unit on a row's end tiles.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "conv3x3_common.cuh"
#include "sm90.cuh"

namespace {

using namespace conv3;   // bf16, PAD_*, reflect, out_row, the stores

constexpr int KC = 64;         // input channels per pipeline unit: one row

template <int BN, int WGS>
struct Cfg {
  static constexpr int BM = 64 * WGS;            // output columns of a row
  static constexpr int THREADS = 128 * (WGS + 1);  // + the producer
  static constexpr int SEG = BM + 2;             // band rows (positions)
  static constexpr int A_BYTES = (SEG * 128 + 1023) / 1024 * 1024;
  // weights: per 64 outputs one TMA box [3 taps][KC][64]
  static constexpr int NA = (BN + 63) / 64;
  static constexpr int B_ATOM = 3 * KC * 128;
  static constexpr int STAGE = NA * B_ATOM + A_BYTES;
  static constexpr int STAGES = NA == 1 ? 4 : 3;
  static constexpr int PIPE = STAGES * STAGE;
  static constexpr int LDC = BN + 4;             // f32 epilogue row
  static constexpr int EPI = BM * LDC * 4;
  static constexpr int MAIN = PIPE > EPI ? PIPE : EPI;
  // + the output rows, the barriers, and up to 1024 bytes of alignment
  static constexpr int SMEM = MAIN + BM * 8 + 3 * STAGES * 8 + 1024;
  static_assert(B_ATOM % 1024 == 0 && STAGE % 1024 == 0, "swizzle atoms");
};

// x [N, H, W, C] through xmap (boxes (64 channels, SEG columns, 1, 1)),
// w [9, C, O8] through wmap (boxes (64 outputs, KC channels, 3 taps)),
// both 128-byte swizzled, bias [O] (null: none) -> y: [N, H, W, O] for
// pad 0 / 1; for pad 2, N H W rows of O (dx's interior) then N R rows of
// the ring (R = 2 (W + 2) + 2 H per image: top, bottom, left, right).
// Block (column tile, image row, output tile).
template <int BN, int WGS, typename OutT>
__global__ void __launch_bounds__(128 * (WGS + 1))
conv3x3_kernel(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap wmap,
               const float* __restrict__ bias, OutT* __restrict__ y, int n,
               int h, int wd, int c, int o, int pad) {
  using K = Cfg<BN, WGS>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  long long* dest = reinterpret_cast<long long*>(smem + K::MAIN);
  // full[s]: stage s landed (the TMA warp's arrival with its bytes, and
  // the patch warp's); tma[s]: the bytes of a band whose reflect columns
  // the patch warp fixes; empty[s]: the consumers are done with it
  const uint32_t full_bar = sm90::smem_addr(smem + K::MAIN + K::BM * 8);
  const uint32_t tma_bar = full_bar + 8 * K::STAGES;
  const uint32_t empty_bar = tma_bar + 8 * K::STAGES;

  const int tid = threadIdx.x;
  const int ext = pad == PAD_FULL ? 1 : 0;
  const int ho = h + 2 * ext;
  const int img = blockIdx.y / ho, row = blockIdx.y - img * ho;
  const int j0 = blockIdx.x * K::BM;
  const int o0 = blockIdx.z * BN;

  // dest[m]: the output row (of O values) of column j0 + m, or -1
  for (int m = tid; m < K::BM; m += K::THREADS)
    dest[m] = out_row(pad, img, row, j0 + m, n, h, wd);
  if (tid == 0) {
    for (int s = 0; s < K::STAGES; ++s) {
      sm90::mbar_init(full_bar + 8 * s, 2);
      sm90::mbar_init(tma_bar + 8 * s, 1);
      sm90::mbar_init(empty_bar + 8 * s, 128 * WGS);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  // the band's columns j0 - 1 - ext .. : under reflect, column -1 is
  // column 1 (band row 0 from row 2) and column W is column W - 2
  const int t_left = pad == PAD_REFLECT && j0 == 0 ? 0 : -1;
  const int t_right = pad == PAD_REFLECT && wd - j0 + 1 < K::SEG ? wd - j0 + 1 : -1;
  const bool fix = t_left >= 0 || t_right >= 0;
  const int units = (c + KC - 1) / KC * 3;
  const int wg = tid / 128;
  if (wg == WGS) {
    // ---- producer: warp 0 issues the TMA loads, warp 1 patches ----
    const int warp = (tid / 32) % 4, lane = tid % 32;
    uint32_t tphase = 0;
    if (warp >= 2) return;
#pragma unroll 1
    for (int u = 0; u < units; ++u) {
      const int s = u % K::STAGES;
      if (u >= K::STAGES)
        sm90::mbar_wait(empty_bar + 8 * s, (u / K::STAGES - 1) & 1);
      const int c0 = (u / 3) * KC, dy = u % 3;
      unsigned char* st = smem + s * K::STAGE;
      const uint32_t sa = sm90::smem_addr(st);
      if (warp == 0) {
        if (lane == 0) {
          const uint32_t bar = fix ? tma_bar + 8 * s : full_bar + 8 * s;
          sm90::mbar_arrive_tx(bar, K::NA * K::B_ATOM + K::SEG * 128);
          for (int a = 0; a < K::NA; ++a)
            sm90::tma_load_3d(sa + a * K::B_ATOM, &wmap, o0 + 64 * a, c0,
                              3 * dy, bar);
          int xr = row + dy - 1 - ext;
          if (pad == PAD_REFLECT) xr = reflect(xr, h);
          sm90::tma_load_4d(sa + K::NA * K::B_ATOM, &xmap, c0, j0 - 1 - ext, xr,
                            img, bar);
          if (fix) sm90::mbar_arrive(full_bar + 8 * s);
        }
      } else {
        if (fix) {
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
    return;
  }

  // ---- consumer warpgroups: 64 columns each, one unit behind the next ----
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (int u = 0; u < units; ++u) {
    const int s = u % K::STAGES;
    sm90::mbar_wait(full_bar + 8 * s, (u / K::STAGES) & 1);
    const uint32_t sa = sm90::smem_addr(smem + s * K::STAGE);
    const uint32_t band = sa + K::NA * K::B_ATOM;
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        // A: band rows wg 64 + dx .., 16 channels from 16 ks (K-major);
        // B: tap dx's [KC, BN] rows 16 ks .. (MN-major)
        const uint64_t da =
            sm90::desc_sw128(band + (wg * 64 + dx) * 128 + ks * 32, 16, 1024);
        const uint64_t db = sm90::desc_sw128(sa + dx * KC * 128 + ks * 16 * 128,
                                             K::B_ATOM, 1024);
        sm90::wgmma<0, 1>(acc, da, db);
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();           // unit u - 1's products are done
    sm90::fence_regs(acc);
    if (u > 0) sm90::mbar_arrive(empty_bar + 8 * ((u - 1) % K::STAGES));
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  sm90::bar_sync(1, 128 * WGS);      // no consumer reads the ring any more

  // ---- epilogue: accumulators -> shared (f32) -> + bias -> OutT ----
  float* cs = reinterpret_cast<float*>(smem);
  {
    const int lane = tid % 32, r = wg * 64 + (tid % 128) / 32 * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<float2*>(cs + r * K::LDC + col) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(cs + (r + 8) * K::LDC + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  sm90::bar_sync(1, 128 * WGS);
  constexpr int V = 16 / sizeof(OutT);
  const bool vec = (o * (int)sizeof(OutT)) % 16 == 0;
  for (int e = tid; e < K::BM * (BN / V); e += 128 * WGS) {
    const int m = e / (BN / V), cv = (e % (BN / V)) * V;
    const long long d = dest[m];
    const int oc = o0 + cv;
    if (d < 0 || oc >= o) continue;
    const float* src = cs + m * K::LDC + cv;
    OutT* dst = y + d * o + oc;
    if (vec) {
      float v[V];
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = src[k] + (bias ? bias[oc + k] : 0.f);
      store_vec(dst, v);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (oc + k < o) store_one(dst + k, src[k] + (bias ? bias[oc + k] : 0.f));
    }
  }
}

// w [9, C, O8] bf16 as boxes [3 taps][KC channels][64 outputs] with the
// 128-byte swizzle; zeros past C and O8
int weight_map(CUtensorMap* map, const void* w, int c, int o8) {
  const cuuint64_t dims[3] = {(cuuint64_t)o8, (cuuint64_t)c, 9};
  const cuuint64_t strides[2] = {(cuuint64_t)o8 * 2, (cuuint64_t)c * o8 * 2};
  const cuuint32_t box[3] = {64, KC, 3};
  return sm90::bf16_map(map, w, 3, dims, strides, box,
                        CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int BN, int WGS, typename OutT>
int launch_cfg(const void* x, const void* w, const float* b, OutT* y, int n,
               int h, int wd, int c, int o, int pad, cudaStream_t stream) {
  using K = Cfg<BN, WGS>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv3x3_kernel<BN, WGS, OutT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  CUtensorMap xmap, wmap;
  int err = sm90::nhwc_map(&xmap, x, n, h, wd, c, K::SEG);
  if (err == 0) err = weight_map(&wmap, w, c, (o + 7) / 8 * 8);
  if (err != 0) return err;
  const int ext = pad == PAD_FULL ? 1 : 0;
  dim3 grid((unsigned)((wd + 2 * ext + K::BM - 1) / K::BM),
            (unsigned)(n * (h + 2 * ext)), (unsigned)((o + BN - 1) / BN));
  conv3x3_kernel<BN, WGS, OutT><<<grid, K::THREADS, K::SMEM, stream>>>(
      xmap, wmap, b, y, n, h, wd, c, o, pad);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch(const void* x, const void* w, const void* bias, void* y, int n,
           int h, int wd, int c, int o, int pad, cudaStream_t stream) {
  if (n < 1 || h < 1 || wd < 1 || c < 8 || c % 8 || o < 1 || pad < 0 ||
      pad > PAD_FULL || (long long)n * (h + 2) > 65535)
    return (int)cudaErrorInvalidValue;
  if (pad == PAD_REFLECT && (h < 2 || wd < 2)) return (int)cudaErrorInvalidValue;
  const int ext = pad == PAD_FULL ? 1 : 0;
  const long long rows = (long long)n * (h + 2 * ext);
  const int wo = wd + 2 * ext;
  const int o8 = (o + 7) / 8 * 8;
  // BN: one tile up to 80 outputs, else tiles of 128; BM 128 columns
  // unless that gives fewer blocks than the card's 132 SMs, then 64 (and
  // BN 64)
  int bn = o8 <= 64 ? 64 : (o8 <= 80 ? 80 : 128);
  auto blocks = [&](int bm, int bnn) {
    return (wo + bm - 1) / bm * rows * ((o + bnn - 1) / bnn);
  };
  const int wgs = blocks(128, bn) >= 132 ? 2 : 1;
  if (wgs == 1 && bn == 128 && blocks(64, 128) < 132) bn = 64;
  auto* bp = static_cast<const float*>(bias);
  auto* yp = static_cast<OutT*>(y);
#define RNR_K3(BN_, WGS_)                                                \
  if (bn == BN_ && wgs == WGS_)                                          \
    return launch_cfg<BN_, WGS_, OutT>(x, w, bp, yp, n, h, wd, c, o, pad, \
                                       stream);
  RNR_K3(64, 1) RNR_K3(64, 2) RNR_K3(80, 1) RNR_K3(80, 2) RNR_K3(128, 1)
  RNR_K3(128, 2)
#undef RNR_K3
  return (int)cudaErrorInvalidConfiguration;
}

}  // namespace

extern "C" int rnr_conv3x3(const void* x, const void* w, const void* bias,
                           void* y, int n, int h, int wd, int c, int o,
                           int pad, cudaStream_t stream) {
  if (pad == PAD_FULL) return (int)cudaErrorInvalidValue;
  return launch<bf16>(x, w, bias, y, n, h, wd, c, o, pad, stream);
}

// The same conv with an f32 output: the dgrad of conv3x3 (no rounding of
// the data gradient to bf16 before the reflect fold).  Pad 2 (no bias)
// is the reflect dgrad: y holds N H W + N R rows of O; the full
// correlation's interior goes to the first N H W (dx), its ring to the
// rest, and fold_ring_kernel then adds the ring onto dx: dx is done.
extern "C" int rnr_conv3x3_f32out(const void* x, const void* w,
                                  const void* bias, void* y, int n, int h,
                                  int wd, int c, int o, int pad,
                                  cudaStream_t stream) {
  if (pad == PAD_FULL && (bias != nullptr || h < 2 || wd < 2))
    return (int)cudaErrorInvalidValue;    // the reflect dgrad: no bias
  const int e = launch<float>(x, w, bias, y, n, h, wd, c, o, pad, stream);
  if (e != 0 || pad != PAD_FULL) return e;
  return conv3::fold_ring(static_cast<float*>(y), n, h, wd, o, stream);
}
