// K4: stratified nearest neighbour.  For each query row i and each column
// stratum s of STRATUM vertices, the index of the vertex j in the stratum
// that maximises  score(i, j) = 2 x_i . x_j - |x_j|^2  (the nearest one:
// the row term |x_i|^2 cannot change a per-row argmax).  x is read as
// bf16, the scores are f32, the first maximum wins ties, the index is
// clamped to V - 1; out is int32 [V, ceil(V / 16)], any C up to 512.
//
// Replaces: rnr_tpu/ops/knn_pallas.py  stratified_knn (:81) /
//   _stratified_kernel (:44), which fuses the [V, V] score matmul with the
//   per-stratum argmax in VMEM so the score matrix never reaches HBM.
//
// Bound on the H100: at V = 7500, C = 64 one call is 2 V^2 C = 7.2 GFLOP
//   of bf16 products (7.3 us at 989 TFLOP/s) against 0.96 MB of x and 14
//   MB of indices (4.2 us at 3.35 TB/s).  What bounds this kernel is
//   neither: it is the epilogue on the CUDA cores.  Each of the 56 M
//   scores takes an FMA (2 acc - |x_j|^2), a compare and two selects in
//   its lane, and a share of the cross-lane merge, about 6 instructions a
//   score, with the dependent compare chains of only two warps per
//   scheduler to hide.  Measured on the H100 (chip_variants.py), the
//   products alone take about a third of the epilogue's time.
//
// Design: a GEMM on wgmma with the argmax fused in registers, persistent.
//   Work items are (128 query rows, 256 candidate columns = 16 strata);
//   a grid of one block per SM walks a contiguous range of items in row
//   order, so the block's rows stay in shared memory while its columns
//   stream past.  Operands are x itself, K-major (C contiguous): A is the
//   item's rows, B its columns, both TMA boxes of 64 channels as
//   128-byte-swizzled rows (sm90.cuh).  One producer thread keeps a ring
//   of 2-4 stages of B (32 KB, plus the columns' |x_j|^2 by a bulk copy)
//   and 1-2 slots of A full through mbarriers; its warpgroup hands its
//   registers to the consumers (setmaxnreg: 40 and 232 a thread).  Two
//   consumer warpgroups each own 64 of the rows and issue m64n256k16
//   products over the item's channels into 128 f32 accumulators, the
//   first with scale-d 0 (no zeroing); the two warpgroups drift out of
//   phase over the ring, so one's products run on the tensor cores while
//   the other's epilogue issues.  (Splitting an item into two halves of
//   128 columns, each half's products issued under the other's epilogue,
//   was measured slower: ptxas serialised the products, C7514.)  The
//   epilogue reads the accumulator layout directly: a stratum's 16
//   columns of a row are 4 values in each lane of one quad, so each lane
//   takes its best of 4 in column order (strict >: the first maximum),
//   and two xor-shuffle rounds (1, then 2) merge the quad as a
//   reduce-scatter: each round keeps half the strata and sends the other
//   half, so lane q ends holding strata 4q .. 4q + 3 of its two rows,
//   written with one 16-byte store per row where the row stride allows.
//   |x_j|^2 is computed once per column, in a fixed order, by a small
//   pass in the same C call (which also writes +inf for the columns past
//   V, so they never win; the kernel is launched while it runs, by
//   programmatic dependent launch, and its producer waits for it before
//   the first copy); every row tile reads the same value, so
//   identical columns tie exactly and the lower index wins.  The output
//   is integer and every sum runs in a fixed order: bitwise equal from
//   run to run.
//
// Ragged cases: the first pass writes x's rows as bf16 (rounding an f32
//   x there, so the wrapper launches no conversion of its own),
//   zero-padded to a multiple of 64 channels (TMA rows must be 16-byte
//   multiples); the padding's products are issued like the rest (C = 3
//   costs the products of C = 64, C = 130 those of 192), so no product
//   hangs on a runtime branch.
//   V not a multiple of the tiles costs the last row tile's and column
//   tile's zero-filled rows (TMA writes zeros past V); rows past V are not
//   stored.  C > 64 streams its chunks of 64 channels through the ring;
//   C = 512 keeps 128 KB of A in shared memory, leaving room
//   for 2 stages of B and one A slot: a row-tile change then waits for
//   the previous tile's products before A is reloaded.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int STRATUM = 16;   // stratum width (fixed, as in the GCN)
constexpr int MAX_C = 512;
constexpr int BM = 128;       // query rows per item: 2 warpgroups x 64
constexpr int BN = 256;       // candidate columns per item: 16 strata
constexpr int KC = 64;        // channels per 128-byte row
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
constexpr int A_CHUNK = BM * 128;         // 64 channels of the rows
constexpr int B_BYTES = BN * 128;         // 64 channels of the columns
constexpr int STAGE = B_BYTES + BN * 4;   // + |x_j|^2 of the columns
constexpr int BARRIERS = 256;
constexpr int SMEM_LIMIT = 232448;        // a block's shared memory, sm_90
static_assert(A_CHUNK % 1024 == 0 && STAGE % 1024 == 0, "swizzle atoms");

struct Plan {
  int nchunks;       // 64-channel chunks of the (padded) rows
  int a_slots;       // buffers of A (2: the next row tile loads early)
  int stages;        // buffers of B
  int smem;
};

Plan make_plan(int c) {
  Plan p;
  p.nchunks = (c + KC - 1) / KC;
  const int a_bytes = p.nchunks * A_CHUNK;
  const int usable = SMEM_LIMIT - 1024 - BARRIERS;
  p.a_slots = 2 * a_bytes + 2 * STAGE <= usable ? 2 : 1;
  p.stages = (usable - p.a_slots * a_bytes) / STAGE;
  if (p.stages > 4) p.stages = 4;
  p.smem = p.a_slots * a_bytes + p.stages * STAGE + BARRIERS + 1024;
  return p;
}

// The first pass: x (f32, rounded to bf16 here) -> xp, its rows as bf16
// zero-padded to cp channels (TMA reads rows of 16-byte multiples), and
// |x_j|^2 in f32 of the bf16 values for j < V (a warp per row:
// lane-strided partial sums, then a fixed xor tree, so every call sums
// in the same order); +inf for V <= j < vpad.
__global__ void __launch_bounds__(256)
knn_prep_kernel(const float* __restrict__ x, int v, int c, int vpad,
                float* __restrict__ sq, bf16* __restrict__ xp, int cp) {
  sm90::launch_dependents();   // the kernel may start its set-up now
  const int j = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (j >= vpad) return;
  if (j >= v) {
    if (lane == 0) sq[j] = CUDART_INF_F;
    return;
  }
  const float* row = x + (size_t)j * c;
  float s = 0.f;
  for (int k = lane; k < cp; k += 32) {
    const bf16 b = __float2bfloat16_rn(k < c ? row[k] : 0.f);
    const float f = __bfloat162float(b);
    s = __fmaf_rn(f, f, s);
    xp[(size_t)j * cp + k] = b;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) sq[j] = s;
}

// (v, i) := (ov, oi) where the other candidate is larger, or equal with a
// lower index: the first maximum of the two
__device__ __forceinline__ void merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// Round 1 and 2 of the quad's reduce-scatter for one row: lane q holds
// its best of 4 for every stratum (bv, bi); round 1 (lanes q, q ^ 1)
// keeps the strata whose bit 2 is q & 1 and sends the others, round 2
// (lanes q, q ^ 2) those whose bit 3 is q >> 1, so lane q ends with
// strata 4 q .. 4 q + 3, stored as one int4 where the row allows.
__device__ __forceinline__ void row_store(const float (&bv)[16],
                                          const int (&bi)[16], int q, int i,
                                          int v, int ns, int ct,
                                          int* __restrict__ out) {
  const bool b0 = q & 1, b1 = q & 2;
  float v1[8];
  int i1[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int lo_s = (k / 4) * 8 + k % 4, hi_s = lo_s + 4;
    float kv = b0 ? bv[hi_s] : bv[lo_s];
    int ki = b0 ? bi[hi_s] : bi[lo_s];
    const float sv = b0 ? bv[lo_s] : bv[hi_s];
    const int si = b0 ? bi[lo_s] : bi[hi_s];
    merge(kv, ki, __shfl_xor_sync(0xffffffffu, sv, 1),
          __shfl_xor_sync(0xffffffffu, si, 1));
    v1[k] = kv;
    i1[k] = ki;
  }
  int res[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float kv = b1 ? v1[4 + k] : v1[k];
    int ki = b1 ? i1[4 + k] : i1[k];
    const float sv = b1 ? v1[k] : v1[4 + k];
    const int si = b1 ? i1[k] : i1[4 + k];
    merge(kv, ki, __shfl_xor_sync(0xffffffffu, sv, 2),
          __shfl_xor_sync(0xffffffffu, si, 2));
    res[k] = min(ct * BN + ki, v - 1);
  }
  if (i >= v) return;
  const int s0 = ct * STRATUM + 4 * q;
  int* dst = out + (size_t)i * ns + s0;
  if ((ns & 3) == 0 && s0 + 3 < ns) {
    *reinterpret_cast<int4*>(dst) = make_int4(res[0], res[1], res[2], res[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (s0 + k < ns) dst[k] = res[k];
  }
}

// An item's epilogue for this lane's two rows r and r + 8: per stratum
// the 4 accumulators of each row (columns 16 s + 2 q + {0, 1, 8, 9}) as
// scores, and their best in column order; stratum by stratum, so the
// accumulators die as their strata are done.  Then each row's store.
__device__ __forceinline__ void item_epilogue(const float (&acc)[128],
                                              const float* sq, int q, int r,
                                              int v, int ns, int ct,
                                              int* __restrict__ out) {
  float bv[2][16];
  int bi[2][16];
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    const float2 a = *reinterpret_cast<const float2*>(sq + 16 * s + 2 * q);
    const float2 b = *reinterpret_cast<const float2*>(sq + 16 * s + 8 + 2 * q);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // 2 acc exactly, one rounding for the subtraction: the plain
      // version's 2 (x x^T) - |x_j|^2
      const float v0 = __fmaf_rn(2.f, acc[8 * s + 2 * h], -a.x);
      const float v1 = __fmaf_rn(2.f, acc[8 * s + 2 * h + 1], -a.y);
      const float v2 = __fmaf_rn(2.f, acc[8 * s + 4 + 2 * h], -b.x);
      const float v3 = __fmaf_rn(2.f, acc[8 * s + 4 + 2 * h + 1], -b.y);
      float best = v0;
      int o = 0;
      if (v1 > best) { best = v1; o = 1; }   // strict: the first maximum
      if (v2 > best) { best = v2; o = 8; }
      if (v3 > best) { best = v3; o = 9; }
      bv[h][s] = best;
      bi[h][s] = 16 * s + 2 * q + o;
    }
  }
  row_store(bv[0], bi[0], q, r, v, ns, ct, out);
  row_store(bv[1], bi[1], q, r + 8, v, ns, ct, out);
}

// One chunk of 64 channels: 4 products m64n256k16 into acc, the item's
// first with scale-d 0; waits for them.
template <bool FIRST>
__device__ __forceinline__ void chunk_products(float (&acc)[128],
                                               uint32_t a_ch, uint32_t b_ch) {
  sm90::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KC / 16; ++ks) {
    const uint64_t da = sm90::desc_sw128(a_ch + ks * 32, 16, 1024);
    const uint64_t db = sm90::desc_sw128(b_ch + ks * 32, 16, 1024);
    if (FIRST && ks == 0)
      sm90::wgmma_n256<0, 0, 0>(acc, da, db);
    else
      sm90::wgmma_n256<0, 0, 1>(acc, da, db);
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
}

// xmap: the bf16 rows [V, cp] (C padded to 64), boxes of (64 channels,
// 128 rows), 128-byte swizzle.  sq: |x_j|^2 [n_ct * 256].
__global__ void __launch_bounds__(THREADS, 1)
stratified_knn_kernel(const __grid_constant__ CUtensorMap xmap,
                      const float* __restrict__ sq, int* __restrict__ out,
                      int v, int ns, int n_ct, long long items, Plan p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  const int a_bytes = p.nchunks * A_CHUNK;
  unsigned char* a_base = smem;
  unsigned char* b_base = smem + p.a_slots * a_bytes;
  const uint32_t bars = sm90::smem_addr(b_base + p.stages * STAGE);
  const uint32_t full_bar = bars, empty_bar = bars + 32;   // 4 stages each
  const uint32_t afull_bar = bars + 64, aempty_bar = bars + 80;  // 2 slots

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      sm90::mbar_init(full_bar + 8 * s, 1);
      sm90::mbar_init(empty_bar + 8 * s, CONSUMERS);
    }
    for (int s = 0; s < p.a_slots; ++s) {
      sm90::mbar_init(afull_bar + 8 * s, 1);
      sm90::mbar_init(aempty_bar + 8 * s, CONSUMERS);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const long long it0 = items * blockIdx.x / gridDim.x;
  const long long it1 = items * (blockIdx.x + 1) / gridDim.x;

  if (tid >= CONSUMERS) {
    // ---- producer: one thread issues every copy; its warpgroup gives
    // its registers to the consumers ----
    sm90::setmaxnreg_dec<40>();
    if (tid != CONSUMERS) return;
    sm90::grid_dependency_wait();   // the first pass's rows and |x_j|^2
    int L = 0, na = 0, cur = -1;
    for (long long it = it0; it < it1; ++it) {
      const int rt = (int)(it / n_ct), ct = (int)(it % n_ct);
      if (rt != cur) {
        const int slot = na % p.a_slots;
        if (na >= p.a_slots)
          sm90::mbar_wait(aempty_bar + 8 * slot, (na / p.a_slots - 1) & 1);
        const uint32_t bar = afull_bar + 8 * slot;
        sm90::mbar_arrive_tx(bar, a_bytes);
        const uint32_t dst = sm90::smem_addr(a_base + slot * a_bytes);
        for (int ch = 0; ch < p.nchunks; ++ch)
          sm90::tma_load_2d(dst + ch * A_CHUNK, &xmap, ch * KC, rt * BM, bar);
        ++na;
        cur = rt;
      }
      for (int ch = 0; ch < p.nchunks; ++ch, ++L) {
        const int s = L % p.stages;
        if (L >= p.stages)
          sm90::mbar_wait(empty_bar + 8 * s, (L / p.stages - 1) & 1);
        const uint32_t bar = full_bar + 8 * s;
        const uint32_t dst = sm90::smem_addr(b_base + s * STAGE);
        sm90::mbar_arrive_tx(bar, STAGE);
        sm90::tma_load_2d(dst, &xmap, ch * KC, ct * BN, bar);
        sm90::tma_load_2d(dst + B_BYTES / 2, &xmap, ch * KC, ct * BN + BN / 2,
                          bar);
        sm90::bulk_load(dst + B_BYTES, sq + (size_t)ct * BN, BN * 4, bar);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 ----
  sm90::setmaxnreg_inc<232>();
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int q = lane & 3;
  float acc[128];
  int L = 0, na = 0, cur = -1, slot = 0;
  for (long long it = it0; it < it1; ++it) {
    const int rt = (int)(it / n_ct), ct = (int)(it % n_ct);
    if (rt != cur) {
      slot = na % p.a_slots;
      sm90::mbar_wait(afull_bar + 8 * slot, (na / p.a_slots) & 1);
      ++na;
      cur = rt;
    }
    const uint32_t a_rows =
        sm90::smem_addr(a_base + slot * a_bytes) + wg * 64 * 128;
    int s = 0;
    for (int ch = 0; ch < p.nchunks; ++ch, ++L) {
      s = L % p.stages;
      sm90::mbar_wait(full_bar + 8 * s, (L / p.stages) & 1);
      const uint32_t a_ch = a_rows + ch * A_CHUNK;
      const uint32_t b_ch = sm90::smem_addr(b_base + s * STAGE);
      if (ch == 0)
        chunk_products<true>(acc, a_ch, b_ch);
      else
        chunk_products<false>(acc, a_ch, b_ch);
      // the last chunk's stage holds |x_j|^2: kept through the epilogue
      if (ch < p.nchunks - 1) sm90::mbar_arrive(empty_bar + 8 * s);
    }
    // A is done with when the next item is on another row tile
    if (it + 1 == it1 || (int)((it + 1) / n_ct) != rt)
      sm90::mbar_arrive(aempty_bar + 8 * slot);
    const float* sqs =
        reinterpret_cast<const float*>(b_base + s * STAGE + B_BYTES);
    item_epilogue(acc, sqs, q, rt * BM + wg * 64 + warp * 16 + lane / 4, v,
                  ns, ct, out);
    sm90::mbar_arrive(empty_bar + 8 * s);
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

}  // namespace

// x [V, C] f32 -> out [V, ceil(V / 16)] int32.
// work: the caller's scratch of (ceil(V / 256) * 256) f32 for |x_j|^2,
// then V rows of C padded to 64 bf16 (ops/knn_cuda.py knn_work_bytes).
// Two launches: the first pass, then the kernel.
extern "C" int rnr_stratified_knn(const void* x, void* out, void* work, int v,
                                  int c, cudaStream_t stream) {
  if (v < 1 || c < 1 || c > MAX_C) return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        stratified_knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const int ns = (v + STRATUM - 1) / STRATUM;
  const int n_rt = (v + BM - 1) / BM, n_ct = (v + BN - 1) / BN;
  const int vpad = n_ct * BN;
  const int cp = (c + KC - 1) / KC * KC;
  float* sq = static_cast<float*>(work);
  bf16* xp = reinterpret_cast<bf16*>(sq + vpad);
  knn_prep_kernel<<<(vpad + 7) / 8, 256, 0, stream>>>(
      static_cast<const float*>(x), v, c, vpad, sq, xp, cp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  CUtensorMap xmap;
  const cuuint64_t dims[2] = {(cuuint64_t)cp, (cuuint64_t)v};
  const cuuint64_t strides[1] = {(cuuint64_t)cp * 2};
  const cuuint32_t box[2] = {KC, BM};
  const int err = sm90::bf16_map(&xmap, xp, 2, dims, strides, box,
                                 CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  const Plan p = make_plan(c);
  const long long items = (long long)n_rt * n_ct;
  int grid = sm_count();
  if (grid < 1) return (int)cudaErrorInvalidDevice;
  if (grid > items) grid = (int)items;
  // launched while the first pass runs (programmatic dependent launch):
  // its set-up overlaps the pass, its producer waits for the pass's
  // results before the first copy
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, stratified_knn_kernel, xmap,
                                 (const float*)sq, static_cast<int*>(out), v,
                                 ns, n_ct, items, p);
}
