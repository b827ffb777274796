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
// raster orientation (row = pixel y).  The tiles cover the frame from its
// top-left corner, ceil(S / tile_h) x ceil(S / tile_w) of them; those of
// the last row and column are cut by the frame's edge (a partial tile: its
// pixels past S are neither walked nor written), so one tile shape serves
// every S.
//
// Replaces: rnr_tpu/ops/rasterize_pallas.py  rasterize_pallas (:174) /
//   _raster_kernel (:107), one grid step per 32 x 128 tile with the tile's
//   candidates in VMEM and a [32, 128] depth / index carry.
//
// Bound on the H100: one read of the candidate lists and one 8 B write
//   per pixel, against the operations no exact implementation skips: 3
//   comparisons per (pixel, candidate) pair where the candidate passes the
//   inside test (such a pair can win its pixel, so no exact cull drops it)
//   and the weights and depth (32 operations) per covered pixel
//   (chip_smoke.py raster_work).
//
// The cull, exact.  An edge test (yp - y0) * (x1 - x0) >= (xp - x0) *
//   (y1 - y0) has a left side L(yp) that depends on the pixel's row only
//   and a right side R(xp) on its column only.  Each is monotone: the
//   subtraction of a fixed value and the product with a fixed value round
//   monotonically in IEEE f32 (this source is built with -fmad=false, so
//   nothing is fused), yp and xp rise with the pixel's row and column, and
//   L and R are computed here with the per-pixel expressions themselves.
//   So over a rectangle of pixels L is largest at its first or last row
//   and R least at its first or last column, and when all four
//   comparisons L(end row) < R(end column) hold, the edge fails at every
//   pixel of the rectangle: the candidate can win none of them and is
//   dropped, which leaves every bit of the output unchanged.  NaN and
//   infinities: a comparison with NaN is false, so a NaN at an end row or
//   column keeps the candidate.  A NaN inside the rectangle comes only
//   from (+-inf) * 0 at the one row (column) where yp - y0 (xp - x0) is 0
//   beside an infinite x1 - x0 (y1 - y0); that pixel's own test then
//   fails too, and the rows on either side are -inf and +inf, monotone,
//   so the end rows bound the rest.  A vertex at +-inf gives infinite
//   sides at every row or NaN at every row, which the comparisons handle
//   alike.
//
// Design: a block takes a BH x BW part of a tile (BW / 32 warps across,
//   BH / WH down; a warp WH rows x 32 columns, a lane one column and WH
//   rows) and stages the tile's list one candidate a thread per pass: it
//   tests each against the block's rectangle and compacts the survivors,
//   with their 18 floats and id, into shared memory in list order (warp
//   ballot, then the warps' counts in warp order).  Each warp then tests
//   the survivors 32 at a time against its own WH x 32 rectangle (a
//   ballot) and walks the ones that remain, in list order, so the tie
//   rule holds; its pixels' depth and index stay in registers.  The next
//   pass's candidates are loaded during the walk (their ids one pass
//   earlier still).  The inside tests and the depths decide a discrete
//   winner, so every sum and product rounds as in the plain version,
//   rnr_tpu's expression order is kept and `/` stays the IEEE division.
//   The weights and the depth are computed only for pixels inside the
//   face: outside it the test fails whatever they are.
//   ops/rasterize_cuda.py cull_keep computes the same cull in torch.
//   Measured on the G-buffer phase's sphere at 512^2 (chip_variants.py
//   --kernels K7, NVIDIA H100 80GB HBM3, 700 W, us per call queued): the
//   time is set by the warps at the sphere's pole, where the busiest
//   4 x 32 strip keeps 429 candidates; this shape (1-row warps in 8 x 32 blocks) 65.08, 1-row warps in 4 x 32
//   blocks 63.41 and in 16 x 32 68.47, 2-row warps 82.41-90.10, 4-row
//   warps 126.45-165.48; this shape without the cull 190.22 (the design
//   before, every 16 x 32 block walking all of its tile's 1,274
//   candidates: 312.60), without the warps' cull 84.87, and the staging
//   and cull alone 11.79.

#include <cuda_runtime.h>

namespace {

// The block shape: BH x BW pixels, warps of WH rows x 32 columns (the
// shape of ops/rasterize_cuda.py BLOCK).
constexpr int BH = 8;
constexpr int BW = 32;
constexpr int WH = 1;
constexpr int THREADS = BH * BW / WH;
constexpr int FACE_FLOATS = 18;
constexpr int SLOT = 20;                // floats of a staged survivor

// clamp to [0, 1] that lets NaN through, as torch.clamp and jnp.clip do
__device__ __forceinline__ float clamp01(float v) {
  v = (v < 0.f) ? 0.f : v;
  return (v > 1.f) ? 1.f : v;
}

// pixel_ndc: the NDC coordinate of pixel centre i
__device__ __forceinline__ float ndc(int i, float sf) {
  return ((2.f * static_cast<float>(i) + 1.f) - sf) / sf;
}

// A rectangle of pixels: yp of its first and last rows, xp of its first
// and last columns; empty when it holds no pixel of the image.
struct Rect {
  float ya, yb, xa, xb;
  bool empty;
};

__device__ __forceinline__ Rect rect(int y0, int y1, int x0, int x1,
                                     float sf) {
  return {ndc(y0, sf), ndc(y1, sf), ndc(x0, sf), ndc(x1, sf),
          y1 < y0 || x1 < x0};
}

// The edge from (xs, ys) to (xe, ye) fails at every pixel of q: both ends'
// left sides below both ends' right sides.
__device__ __forceinline__ bool edge_out(const Rect& q, float xs, float ys,
                                         float xe, float ye) {
  const float la = (q.ya - ys) * (xe - xs), lb = (q.yb - ys) * (xe - xs);
  const float ra = (q.xa - xs) * (ye - ys), rb = (q.xb - xs) * (ye - ys);
  return la < ra && la < rb && lb < ra && lb < rb;
}

// The face (vertices d[0..1], d[3..4], d[6..7] in NDC) is inside at no
// pixel of q.
__device__ __forceinline__ bool culled(const Rect& q, float x0, float y0,
                                       float x1, float y1, float x2,
                                       float y2) {
  return q.empty || edge_out(q, x0, y0, x1, y1) ||
         edge_out(q, x1, y1, x2, y2) || edge_out(q, x2, y2, x0, y0);
}

__global__ void __launch_bounds__(THREADS)
raster_tiles_kernel(const float* __restrict__ table,
                    const int* __restrict__ ids,
                    const int* __restrict__ counts, int f, int n_tiles,
                    int k_cap, int s, int tile_h, int tile_w, int sub_x,
                    float near, float far, float* __restrict__ depth_out,
                    int* __restrict__ idx_out) {
  constexpr int WARPS = THREADS / 32;
  constexpr int WX = BW / 32;           // warps across the block
  __shared__ __align__(16) float sd[THREADS * SLOT];
  __shared__ int sid[THREADS];
  __shared__ int warp_n[WARPS];

  const int n = blockIdx.z;
  const int t = blockIdx.y;
  const int n_tx = (s + tile_w - 1) / tile_w;
  const int ty = t / n_tx, tx = t % n_tx;
  const int sx = blockIdx.x % sub_x, sy = blockIdx.x / sub_x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wy = warp / WX, wx = warp % WX;
  const float sf = static_cast<float>(s);

  // the tile's rows and columns inside the frame (fewer in an edge
  // tile), then the block's and the warp's pixels among them, in image
  // coordinates
  const int y_t = ty * tile_h, x_t = tx * tile_w;
  const int th = min(tile_h, s - y_t), tw = min(tile_w, s - x_t);
  const int br = sy * BH, bc = sx * BW;
  const int wr = br + wy * WH, wc = bc + wx * 32;
  const Rect block_rect =
      rect(y_t + br, y_t + min(br + BH, th) - 1, x_t + bc,
           x_t + min(bc + BW, tw) - 1, sf);
  const Rect warp_rect =
      rect(y_t + wr, y_t + min(wr + WH, th) - 1, x_t + wc,
           x_t + min(wc + 32, tw) - 1, sf);

  const int col = wc + lane;
  const int xg = x_t + col;
  const float xi = static_cast<float>(xg);
  const float xp = ndc(xg, sf);
  float yi[WH], yp[WH], depth[WH];
  int yg[WH], best[WH];
  bool valid[WH];
#pragma unroll
  for (int j = 0; j < WH; ++j) {
    const int row = wr + j;
    valid[j] = (col < tw) && (row < th);
    yg[j] = y_t + row;
    yi[j] = static_cast<float>(yg[j]);
    yp[j] = ndc(yg[j], sf);
    depth[j] = far;
    best[j] = -1;
  }

  const size_t tile = static_cast<size_t>(n) * n_tiles + t;
  const int count = counts[tile];
  const int* list = ids + tile * k_cap;
  const float2* tab = reinterpret_cast<const float2*>(
      table + static_cast<size_t>(n) * f * FACE_FLOATS);

  // this thread's candidate of the pass (id and 18 floats), and the id of
  // its candidate of the next pass
  float fd[FACE_FLOATS];
  auto fetch = [&](int id) {
#pragma unroll
    for (int i = 0; i < FACE_FLOATS / 2; ++i) {
      const float2 v = id >= 0 ? tab[static_cast<size_t>(id) * 9 + i]
                               : make_float2(0.f, 0.f);
      fd[2 * i] = v.x;
      fd[2 * i + 1] = v.y;
    }
  };
  int id = tid < count ? list[tid] : -1;
  fetch(id);
  int id_next = THREADS + tid < count ? list[THREADS + tid] : -1;

  for (int base = 0; base < count; base += THREADS) {
    // the block's cull, and the survivors compacted in list order
    const bool keep =
        id >= 0 && !culled(block_rect, fd[0], fd[1], fd[3], fd[4], fd[6],
                           fd[7]);
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_n[warp] = __popc(mask);
    __syncthreads();
    int at = 0, n_keep = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = warp_n[w];
      at += w < warp ? c : 0;
      n_keep += c;
    }
    if (keep) {
      const int slot = at + __popc(mask & ((1u << lane) - 1u));
      float* d = sd + slot * SLOT;
#pragma unroll
      for (int i = 0; i < FACE_FLOATS; ++i) d[i] = fd[i];
      sid[slot] = id;
    }
    __syncthreads();

    // the next pass's candidates load during the walk
    id = id_next;
    fetch(id);
    const int e2 = base + 2 * THREADS + tid;
    id_next = e2 < count ? list[e2] : -1;

    // the warp's cull over the survivors, then its walk in list order
    for (int g = 0; g < n_keep; g += 32) {
      bool hit = false;
      if (g + lane < n_keep) {
        const float* d = sd + (g + lane) * SLOT;
        hit = !culled(warp_rect, d[0], d[1], d[3], d[4], d[6], d[7]);
      }
      unsigned todo = __ballot_sync(0xffffffffu, hit);
      while (todo) {
        const int c = g + __ffs(todo) - 1;
        todo &= todo - 1u;
        const float4* d4 = reinterpret_cast<const float4*>(sd + c * SLOT);
        const float4 a = d4[0], b = d4[1], e = d4[2];
        const float x0 = a.x, y0 = a.y, z0 = a.z;
        const float x1 = a.w, y1 = b.x, z1 = b.y;
        const float x2 = b.z, y2 = b.w, z2 = e.x;
        const float* d = sd + c * SLOT;
        const int fid = sid[c];
#pragma unroll
        for (int j = 0; j < WH; ++j) {
          const bool in0 = (yp[j] - y0) * (x1 - x0) >= (xp - x0) * (y1 - y0);
          const bool in1 = (yp[j] - y1) * (x2 - x1) >= (xp - x1) * (y2 - y1);
          const bool in2 = (yp[j] - y2) * (x0 - x2) >= (xp - x2) * (y0 - y2);
          if (!(in0 && in1 && in2)) continue;
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
  }

#pragma unroll
  for (int j = 0; j < WH; ++j) {
    if (!valid[j]) continue;
    const size_t o = (static_cast<size_t>(n) * s + yg[j]) * s + xg;
    depth_out[o] = depth[j];
    idx_out[o] = best[j];
  }
}

}  // namespace

// table [n, f, 18] f32, ids [n, n_tiles, k_cap] int32, counts [n, n_tiles]
// int32 -> depth [n, s, s] f32, idx [n, s, s] int32.  Tiles are tile_h x
// tile_w, ceil(s / tile_h) x ceil(s / tile_w) of them, row-major; those of
// the last row and column are cut by the frame.
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
