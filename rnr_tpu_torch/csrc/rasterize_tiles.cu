// K7: the per-tile z-buffer of the tile-binned rasterizer.
//
// For each image tile t of batch element n, walk the tile's candidate
// faces (ids[n, t, 0 .. counts[n, t]), ascending face id, from the binning
// of ops/rasterize_cuda.py::bin_faces) and keep, per pixel, the face with
// the least perspective depth zp in (near, far): edge-inclusive inside
// tests in NDC, barycentrics from the face's inverse matrix at the integer
// pixel coordinates, clamped to [0, 1] and renormalised, 1/zp = sum w/z.
// The z-test is strict, so the first candidate wins a tie.  Output:
// depth [N, S, S] f32 (`far` where empty) and idx [N, S, S] int32 (-1), in
// raster orientation (row = pixel y).
//
// Replaces: rnr_tpu/ops/rasterize_pallas.py  rasterize_pallas (:174) /
//   _raster_kernel (:107), one grid step per 32 x 128 tile with the tile's
//   candidates in VMEM and a [32, 128] depth / index carry.
//
// Bound on the H100: f32 operations.  The least work keeps 3 comparisons
//   per (pixel, candidate), each edge test's two sides being per row and
//   per column of the tile, and the weights and depth (32 operations) per
//   covered pixel; the bytes are one read of the candidate lists and one
//   8 B write per pixel.  This kernel recomputes both sides of every edge
//   test per pixel.
// Design: a 32 x 128 tile has only 64 tiles at 512^2, half the SMs, so a
//   block takes a 16 x 32 part of a tile (128 threads, a warp across 32
//   columns, 4 rows each) and walks the whole tile's list; a tile's blocks
//   share its candidates through L2.  Candidates are staged through
//   shared memory CHUNK at a time (ids, then their 18 floats: xyz of the
//   vertices and the 3x3 face_inv); each pixel's depth and index stay in
//   registers.  The inside tests and the depths decide a discrete winner,
//   so this source is built with -fmad=false (ops/_build.py) and keeps
//   rnr_tpu's expression order: every sum and product rounds as in the
//   plain version, and `/` stays the IEEE division.  The weights and the
//   depth are computed only for pixels inside the face: outside it the
//   test fails whatever they are.

#include <cuda_runtime.h>

namespace {

constexpr int BW = 32;                  // pixel columns per block
constexpr int BH = 16;                  // pixel rows per block
constexpr int RPT = 4;                  // pixel rows per thread
constexpr int THREADS = BW * BH / RPT;  // 128
constexpr int ROW_STEP = BH / RPT;      // rows between a thread's pixels
constexpr int CHUNK = 128;              // candidates staged per pass
constexpr int FACE_FLOATS = 18;

// clamp to [0, 1] that lets NaN through, as torch.clamp and jnp.clip do
__device__ __forceinline__ float clamp01(float v) {
  v = (v < 0.f) ? 0.f : v;
  return (v > 1.f) ? 1.f : v;
}

__global__ void __launch_bounds__(THREADS)
raster_tiles_kernel(const float* __restrict__ table,
                    const int* __restrict__ ids,
                    const int* __restrict__ counts, int f, int n_tiles,
                    int k_cap, int s, int tile_h, int tile_w, int sub_x,
                    float near, float far, float* __restrict__ depth_out,
                    int* __restrict__ idx_out) {
  __shared__ float sd[CHUNK * FACE_FLOATS];
  __shared__ int sid[CHUNK];

  const int n = blockIdx.z;
  const int t = blockIdx.y;
  const int n_tx = s / tile_w;
  const int ty = t / n_tx, tx = t % n_tx;
  const int sx = blockIdx.x % sub_x, sy = blockIdx.x / sub_x;
  const int lane = threadIdx.x % BW;
  const int wrow = threadIdx.x / BW;

  const float sf = static_cast<float>(s);
  const int col = sx * BW + lane;
  const int xg = tx * tile_w + col;
  const float xi = static_cast<float>(xg);
  const float xp = ((2.f * xi + 1.f) - sf) / sf;
  float yi[RPT], yp[RPT], depth[RPT];
  int yg[RPT], best[RPT];
  bool valid[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int row = sy * BH + wrow + j * ROW_STEP;
    valid[j] = (col < tile_w) && (row < tile_h);
    yg[j] = ty * tile_h + row;
    yi[j] = static_cast<float>(yg[j]);
    yp[j] = ((2.f * yi[j] + 1.f) - sf) / sf;
    depth[j] = far;
    best[j] = -1;
  }

  const size_t tile = static_cast<size_t>(n) * n_tiles + t;
  const int count = counts[tile];
  const int* list = ids + tile * k_cap;
  const float* tab = table + static_cast<size_t>(n) * f * FACE_FLOATS;

  for (int base = 0; base < count; base += CHUNK) {
    const int m = min(CHUNK, count - base);
    __syncthreads();   // the previous chunk is consumed
    for (int e = threadIdx.x; e < m; e += THREADS) sid[e] = list[base + e];
    __syncthreads();
    for (int e = threadIdx.x; e < m * FACE_FLOATS; e += THREADS) {
      const int c = e / FACE_FLOATS;
      const int id = sid[c];
      sd[e] = (id >= 0)
                  ? tab[static_cast<size_t>(id) * FACE_FLOATS +
                        (e - c * FACE_FLOATS)]
                  : 0.f;
    }
    __syncthreads();

    for (int c = 0; c < m; ++c) {
      const float* d = sd + c * FACE_FLOATS;
      const int fid = sid[c];
      const float x0 = d[0], y0 = d[1], z0 = d[2];
      const float x1 = d[3], y1 = d[4], z1 = d[5];
      const float x2 = d[6], y2 = d[7], z2 = d[8];
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const bool in0 = (yp[j] - y0) * (x1 - x0) >= (xp - x0) * (y1 - y0);
        const bool in1 = (yp[j] - y1) * (x2 - x1) >= (xp - x1) * (y2 - y1);
        const bool in2 = (yp[j] - y2) * (x0 - x2) >= (xp - x2) * (y0 - y2);
        if (!(in0 && in1 && in2) || fid < 0) continue;
        const float w0 = clamp01(d[9] * xi + d[10] * yi[j] + d[11]);
        const float w1 = clamp01(d[12] * xi + d[13] * yi[j] + d[14]);
        const float w2 = clamp01(d[15] * xi + d[16] * yi[j] + d[17]);
        float wsum = w0 + w1 + w2;
        wsum = (wsum == 0.f) ? 1e-30f : wsum;
        float inv_zp = (w0 / z0 + w1 / z1 + w2 / z2) / wsum;
        inv_zp = (inv_zp == 0.f) ? 1e-30f : inv_zp;
        const float zp = 1.f / inv_zp;
        if (zp > near && zp < far && zp < depth[j]) {
          depth[j] = zp;
          best[j] = fid;
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    if (!valid[j]) continue;
    const size_t o = (static_cast<size_t>(n) * s + yg[j]) * s + xg;
    depth_out[o] = depth[j];
    idx_out[o] = best[j];
  }
}

}  // namespace

// table [n, f, 18] f32, ids [n, n_tiles, k_cap] int32, counts [n, n_tiles]
// int32 -> depth [n, s, s] f32, idx [n, s, s] int32.  Tiles are tile_h x
// tile_w, row-major, s divisible by both.
extern "C" int rnr_rasterize_tiles(const void* table, const void* ids,
                                   const void* counts, void* depth,
                                   void* idx, int n, int f, int n_tiles,
                                   int k_cap, int s, int tile_h, int tile_w,
                                   float near, float far,
                                   cudaStream_t stream) {
  if (n == 0 || n_tiles == 0) return static_cast<int>(cudaSuccess);
  const int sub_x = (tile_w + BW - 1) / BW;
  const int sub_y = (tile_h + BH - 1) / BH;
  dim3 grid(sub_x * sub_y, n_tiles, n);
  raster_tiles_kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(table), static_cast<const int*>(ids),
      static_cast<const int*>(counts), f, n_tiles, k_cap, s, tile_h, tile_w,
      sub_x, near, far, static_cast<float*>(depth), static_cast<int*>(idx));
  return static_cast<int>(cudaGetLastError());
}
