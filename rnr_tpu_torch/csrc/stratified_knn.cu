// Stratified nearest neighbour: for each query row i and each column
// stratum s of STRATUM vertices, the index of the vertex j in the stratum
// that maximises  score(i, j) = 2 x_i . x_j - |x_j|^2  (the nearest one:
// the row term |x_i|^2 cannot change a per-row argmax).  The first
// maximum wins ties; the index is clamped to V - 1.
//
// Replaces: rnr_tpu/ops/knn_pallas.py  stratified_knn (:81) /
//   _stratified_kernel (:44), which fuses the [V, V] score matmul with the
//   per-stratum argmax in VMEM so the score matrix never reaches HBM.
//
// Bound on the H100: FP32 FMA throughput.  At V = 7500, C = 64 one call is
//   2 V^2 C = 7.2 GFLOP against 2 * V * C * 2 bytes of input, so the
//   kernel is far above the memory roofline.
// Design: a register-tiled SGEMM.  A block owns 64 query rows x 64
//   columns (4 strata); each of its 256 threads accumulates a 4 x 4 score
//   tile in f32 from bf16 inputs staged as f32 in shared memory, 32
//   channels at a time.  The per-stratum argmax is a 4-lane shuffle
//   reduction (a stratum's 16 columns live in 4 neighbouring lanes), so
//   the score matrix never leaves registers, as on the TPU.  Tensor cores
//   are left for a later version: the selection needs the f32 scores of
//   every column, and this first version keeps to plain FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TILE = 64;      // rows and columns per block
constexpr int KC = 32;        // channels staged per step
constexpr int STRATUM = 16;   // stratum width (fixed, as in the GCN)

__global__ void __launch_bounds__(256)
stratified_knn_kernel(const __nv_bfloat16* __restrict__ x, int v, int c,
                      int n_strata, int* __restrict__ out) {
  __shared__ float xr[KC][TILE + 1];   // query rows, [channel][row]
  __shared__ float xc[KC][TILE + 1];   // columns,    [channel][col]
  __shared__ float sq_s[TILE];

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // column group: cols tx*4 .. tx*4+3
  const int ty = tid / 16;   // row group:    rows ty*4 .. ty*4+3
  const int row0 = blockIdx.y * TILE;
  const int col0 = blockIdx.x * TILE;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  float sq = 0.f;   // |x_j|^2 of column tid (threads 0..63)

  for (int k0 = 0; k0 < c; k0 += KC) {
    // stage 64 x 32 of rows and of columns: 8 elements per thread each,
    // neighbouring threads on neighbouring channels of one vertex
    for (int e = tid; e < TILE * KC; e += 256) {
      const int r = e / KC, kk = e % KC, ch = k0 + kk;
      const int gr = row0 + r, gc = col0 + r;
      xr[kk][r] = (gr < v && ch < c) ? __bfloat162float(x[(size_t)gr * c + ch]) : 0.f;
      xc[kk][r] = (gc < v && ch < c) ? __bfloat162float(x[(size_t)gc * c + ch]) : 0.f;
    }
    __syncthreads();
    if (tid < TILE) {
#pragma unroll 8
      for (int kk = 0; kk < KC; ++kk) sq += xc[kk][tid] * xc[kk][tid];
    }
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = xr[kk][ty * 4 + q];
        b[q] = xc[kk][tx * 4 + q];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
    }
    __syncthreads();
  }
  if (tid < TILE) sq_s[tid] = sq;
  __syncthreads();

  // per row: best of this thread's 4 columns, then across the 4 lanes
  // that hold one stratum (lanes tx & ~3 .. (tx & ~3) + 3)
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    float best = -CUDART_INF_F;
    int best_j = 0x7fffffff;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = col0 + tx * 4 + q;
      if (j < v) {
        const float s = 2.f * acc[p][q] - sq_s[tx * 4 + q];
        if (s > best) { best = s; best_j = j; }   // strict: first max wins
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oj = __shfl_xor_sync(0xffffffffu, best_j, off);
      if (ob > best || (ob == best && oj < best_j)) { best = ob; best_j = oj; }
    }
    const int i = row0 + ty * 4 + p;
    const int s = (col0 / STRATUM) + tx / 4;
    if ((tx & 3) == 0 && i < v && s < n_strata) {
      out[(size_t)i * n_strata + s] = min(best_j, v - 1);
    }
  }
}

}  // namespace

extern "C" int rnr_stratified_knn(const void* x, void* out, int v, int c,
                                  cudaStream_t stream) {
  const int n_strata = (v + STRATUM - 1) / STRATUM;
  const int tiles = (v + TILE - 1) / TILE;
  dim3 grid(tiles, tiles);
  stratified_knn_kernel<<<grid, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), v, c, n_strata,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
