// The bilinear taps of one mipmap level, shared by the gather
// (mipmap_gather.cu, K2) and its backward scatter (mipmap_scatter.cu, K2b)
// so that both read and write the same texels with the same weights.
//
// Tap semantics are those of rnr_tpu/ops/interpolate.py
// interpolate_bilinear / texture_pallas._taps: corner indices clamped to
// the grid, the weight anchor shifted one texel back at the right/bottom
// edge, weights zero outside [0, S-1]^2.
#pragma once

#include <cuda_runtime.h>

constexpr int MAX_LEVELS = 4;

// up to MAX_LEVELS levels of one launch: their base pointers (the
// texture, or its gradient) and sides
template <typename P>
struct Levels {
  P ptr[MAX_LEVELS];
  int size[MAX_LEVELS];
  int n;
};

template <typename P>
Levels<P> make_levels(const P (&ptrs)[MAX_LEVELS],
                      const int (&sizes)[MAX_LEVELS], int n) {
  Levels<P> lv;
  for (int i = 0; i < MAX_LEVELS; ++i) {
    lv.ptr[i] = ptrs[i];
    lv.size[i] = sizes[i];
  }
  lv.n = n;
  return lv;
}

// the four taps of a pixel at one level: texel columns x0, x1 and rows
// y0, y1, and the weights in the order 00, 10, 01, 11 (first index y,
// second x), zero where the pixel is not `live`
struct Taps {
  int x0, x1, y0, y1;
  float w[4];
};

__device__ __forceinline__ Taps level_taps(float u, float vv, int s,
                                           bool live) {
  const float sm1 = (float)(s - 1);
  // coordinates and weights with explicit rounding (no FMA contraction):
  // a fused multiply-add would shift y by an ulp of up to 511 and move
  // every weight with it; these are the plain version's and XLA's
  // roundings
  const float x = __fmul_rn(u, sm1);    // texel coordinates, v flipped
  const float y = __fsub_rn(sm1, __fmul_rn(vv, sm1));
  const float valid =
      (live && x >= 0.f && x <= sm1 && y >= 0.f && y <= sm1) ? 1.f : 0.f;
  // floor then clamp; the pre-clamp keeps the int conversion defined
  const int xf = (int)floorf(fminf(fmaxf(x, -1.f), (float)s));
  const int yf = (int)floorf(fminf(fmaxf(y, -1.f), (float)s));
  Taps t;
  t.x0 = min(max(xf, 0), s - 1);
  t.x1 = min(max(t.x0 + 1, 0), s - 1);
  t.y0 = min(max(yf, 0), s - 1);
  t.y1 = min(max(t.y0 + 1, 0), s - 1);
  const float x0w = (float)(t.x0 - (t.x0 == t.x1 ? 1 : 0));
  const float y0w = (float)(t.y0 - (t.y0 == t.y1 ? 1 : 0));
  const float ax = __fsub_rn((float)t.x1, x), bx = __fsub_rn(x, x0w);
  const float ay = __fsub_rn((float)t.y1, y), by = __fsub_rn(y, y0w);
  t.w[0] = __fmul_rn(__fmul_rn(ax, ay), valid);
  t.w[1] = __fmul_rn(__fmul_rn(ax, by), valid);
  t.w[2] = __fmul_rn(__fmul_rn(bx, ay), valid);
  t.w[3] = __fmul_rn(__fmul_rn(bx, by), valid);
  return t;
}
