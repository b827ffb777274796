"""Time K4 (csrc/stratified_knn.cu), K2 (csrc/mipmap_gather.cu), K2b
(csrc/mipmap_scatter.cu), K1 and
K1b (csrc/sh_fan.cu), K5 and K5b (csrc/sh_shade.cu), K6a and K6b
(csrc/conv4x4.cu), K7 (csrc/rasterize_tiles.cu), K8c and K8d
(csrc/conv4x4_slab.cu), K8a and K8b (csrc/conv3x3_slab.cu,
conv3x3_slab_wgrad.cu) and P1 (csrc/gemm_chain.cu) on one NVIDIA GPU with
parts of each kernel switched off, to see which part bounds it.

    python3 chip_variants.py
    python3 chip_variants.py --kernels K1b --variants real,staging
    python3 chip_variants.py --kernels K6,K8 --csrc OLD/rnr_tpu_torch/csrc
    python3 chip_variants.py --kernels K8s --csrc OLD/rnr_tpu_torch/csrc
    python3 chip_variants.py --kernels K5b,K7 --csrc OLD/rnr_tpu_torch/csrc
    python3 chip_variants.py --kernels K2 --csrc OLD/rnr_tpu_torch/csrc

Each variant is the real source with one textual switch applied, written
to build/rnr_tpu_torch/variants/ and built with the flags of
rnr_tpu_torch/ops/_build.py; its C entry is called 20 times back to back
between two CUDA events (device time per call, the host's hidden), at
the kernels phase's shapes of chip_smoke.py: K4 at V 7500 and C 64 and
512 on random features, K2b on the synthetic G-buffer's uv at 512^2 (b1),
on its object alone (the uncovered pixels moved off the texture) and with
every pixel on the corner texel, 4 levels x 24 channels.  Switched-off
variants compute wrong results: they are timed, never checked.

K4:  real; no_argmax (the products, then nothing: the epilogue's scores,
     argmax, merge and stores gone); no_stores (all but the index
     stores); no_pdl (the kernel launched after the first pass ends, not
     while it runs); no_products (the epilogue on accumulators set
     without wgmma).
K2:  real (8 x 4 warp tiles, 2 x 4 warps a block, taps once a pixel
     handed out by shuffles, every tap read through L1, streaming
     stores); no_store (no output stores); taps_only (coordinates,
     weights and shuffles, no texel reads); cached_stores (plain
     stores); one_d (32 x 1 warp tiles: the first design's thread order
     with the taps shared);
     tile_16x2, tile_4x8; warps4, warps16, warps32 (2 x 2, 4 x 4, 4 x 8
     warps a block).  Also on the seam and a view of the sphere of
     chip_smoke.py, and at b2; the real build prints a digest of each
     case's output, and the first design (one thread per pixel and 4
     channels, its own arguments) has real only, so --csrc of the parent
     shows the outputs bit for bit unchanged.
K2b: real; no_atomics (every reduction into the gradient skipped);
     no_peel (where a tile's box overflows, every lane sends its own
     taps: no group summed first); no_sums (the per-tap work gone: no
     sort, no sums, no reductions);
     staging (the g rows and uv read, no level processed).
K1:  real; ladder_only (the radiance fold and the means gone: the
     ladder values summed into one register); no_lt_loads (a constant
     in place of every rays_lt value); literals (the ladder constants of
     lmax 10 written into the source instead of read from constant
     memory; the thread-per-pixel design) or coeff_literals (the
     coefficients written into the source: what their constant-memory
     loads cost; the design after it); one_pixel (one pixel per thread
     instead of two).  At 512^2, lmax 10, 13 + 13 rays, bf16 rays_lt, on
     the synthetic G-buffer of chip_smoke.py.
K1b: real; no_dcoeff (the d coeff contraction gone); no_dlt_stores;
     forward_only (both gone: the ray fan, the ladder and the radiance
     remain); in the design after the thread-per-pixel one also staging
     (the walks gone: the rays, the barriers, the radiance parts' sum and
     the copies remain), skeleton (staging without the rays built after
     the first chunk's, the radiance parts' sums and the rays_lt and
     d rays_lt copies), two_rays (two pixel-rays per lane in a walk
     instead of one), four_blocks (registers capped for four blocks an SM
     instead of three), six_warps (the orders split six ways, in chunks
     of 3 rays), dc_immediate (each d coeff FMA's rays_lt * gsel factor
     a literal: two register operands instead of three) and
     dc_one_channel (the d coeff FMAs of one channel of three),
     no_reduce (no block reduction of d coeff into the partials),
     no_partials_sum (no second kernel) and px128 (blocks of 128 pixels
     in chunks of 2 rays), at b1 and b2.  occupancy (K1 and K1b) times
     nothing: it prints the blocks an SM of the lmax-10 bf16 kernel.
K8c (down4s: forward at the frame's five down convs under reflect, bf16
out, and f32 out at the five transpose convs' data gradients, "same")
and K8d (convt4s at the frame's five transpose convs): real; no_mma
(the products gone: loads and epilogue only); no_loads (one resident
ring of stages reused: the loads of the first stages only, products on
them after); no_epilogue (no output stores).  The switches follow the
design of csrc/conv4x4_slab.cu that they find (WMMA on bands staged by
plain loads, or wgmma over TMA bands, with or without the epilogue of
csrc/conv4x4_common.cuh), so --csrc times a parent's pair too; each
build prints its registers and spills (ptxas).
K6a (down4) and K6b (convt4) at the same uses, and K6b also f32 out at
the five down convs' data gradients ("same"): real; no_mma; no_loads;
no_epilogue; for the wgmma design also no_split (no split-K sum).  The
switches follow the design of csrc/conv4x4.cu found (one-stage WMMA with
a gather per tap, or wgmma over TMA-staged parity-plane bands).  The
real builds of K6 and K8 print a digest of each case's output, so two
checkouts' kernels can be held to each other bit for bit.
K8a (the 3x3 slab conv: forward under reflect, bf16 out, and the f32
data gradient under reflect and "same") and K8b (its weight gradient,
reflect) at the frame's 14 3x3 convs: real; no_mma; no_loads; no_epilogue
(K8a: the staged rows' global stores gone; K8b: the partials' stores);
for K8b also no_reduce (no split reduction), for K8a's wgmma design also
no_ring (the reflect dgrad's ring-column tiles skipped) and no_fold (no
ring fold).  The switches follow the design found (WMMA on staged slab
tiles, or wgmma over TMA bands with three dx accumulators), so --csrc
times a parent's pair too; each build prints its registers and spills.
K5b (the unfused SH backward) at chip_smoke.py's kernels_shade case:
real; walk_only (no d rays_lt stores); no_staging (each direction read
from device memory, not the staged rows); one_warp_orders (every order
on warp 0: what splitting them buys); all_powers (every even power
stored per chunk: the block then takes two an SM, not three);
occupancy.  The first design (the unscaled ladder, one pixel a thread)
has real and walk_only, called with its own arguments.  Two runs in one
call (this tree, then --csrc) print the largest differences between the
two designs' outputs.
K7 at the G-buffer phase's sphere, the 48,768-face sphere and the
degenerate faces of chip_smoke.py (512^2): real; no_cull (every
candidate staged and walked: the walk of the design before);
no_warp_cull (the blocks' cull only); cull_only (the staging and both
culls, no per-pixel walk); and a build in every block shape of
K7_SHAPES (block_HxW_wR), with what the cull leaves in each
(cull_counts) and a digest of each output.  The first design
(every block walks its tile's whole list) has real only.
The SH variants are built for lmax 10 alone, and the switches follow the
design of csrc/sh_fan.cu that they find (one thread per pixel with the
backward's d coeff contracted through shared memory, or the orders split
between warps with d coeff in registers), so that

    python3 chip_variants.py --kernels K1,K1b --csrc OLD/rnr_tpu_torch/csrc

times a parent checkout's kernels beside this one's; each SH build also
prints its registers and spills (ptxas) and its static SASS instruction
count by opcode (cuobjdump).
Prints one line per (kernel, case, variant) and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from rnr_tpu_torch.ops import _build  # noqa: E402
from rnr_tpu_torch.ops.knn_cuda import knn_work_bytes  # noqa: E402
from rnr_tpu_torch.ops.sh import ladder_constants  # noqa: E402
from rnr_tpu_torch.ops.sh_cuda import fan_basis_scale  # noqa: E402

OUT = os.path.join(ROOT, "build", "rnr_tpu_torch", "variants")
SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")

K4_VARIANTS = {
    "real": [],
    "no_argmax": [(
        "    item_epilogue(acc, sqs, q, rt * BM + wg * 64 + warp * 16 + lane / 4, v,\n"
        "                  ns, ct, out);\n", "")],
    "no_stores": [
        ("  if (i >= v) return;\n  const int s0 = ct * STRATUM + 4 * q;",
         "  if (i >= v || res[0] != -7) return;\n"
         "  const int s0 = ct * STRATUM + 4 * q;")],
    "no_pdl": [("  cfg.numAttrs = 1;", "  cfg.numAttrs = 0;")],
    "no_products": [
        ("        chunk_products<true>(acc, a_ch, b_ch);",
         "        for (int i = 0; i < 128; ++i) acc[i] = __int_as_float(a_ch + i);"),
        ("        chunk_products<false>(acc, a_ch, b_ch);",
         "        for (int i = 0; i < 128; ++i) acc[i] += __int_as_float(b_ch + i);")],
}
K2B_VARIANTS = {
    "real": [],
    "no_atomics": [
        ("  atomicAdd(reinterpret_cast<unsigned long long*>(dst),",
         "  if (a == 0x12345678912345LL) atomicAdd(reinterpret_cast<unsigned long long*>(dst),")],
    "no_peel": [("      for (int r = 0; r < 2; ++r) {",
                 "      for (int r = 0; r < 0; ++r) {")],
    "no_sums": [
        ("    if (ww <= WIN && wh <= WIN && ww * wh <= WIN) {",
         "    if (ww > 0) continue;\n    if (ww <= WIN && wh <= WIN && ww * wh <= WIN) {")],
    "staging": [
        ("  for (int l = 0; l < lv.n; ++l) {",
         "  if (u == 1.2345e-30f) gs[0] = vv;\n  for (int l = 0; l < 0; ++l) {")],
}


# K2 (csrc/mipmap_gather.cu): the design of warp tiles, its variants by
# textual switch; the first design (one thread per pixel
# and 4 channels) has real only, with its own argument list
_K2_SHAPE = ("constexpr int TW = 8, TH = 4;", "constexpr int WX = 2, WY = 4;")


def _k2_shape(tw, th, wx, wy) -> list:
    return [(_K2_SHAPE[0], f"constexpr int TW = {tw}, TH = {th};"),
            (_K2_SHAPE[1], f"constexpr int WX = {wx}, WY = {wy};")]


K2_VARIANTS = {
    "real": [],
    "no_store": [("    if (ok) Vec<VEC>::store(o, total);",
                  "    if (ok && total[0] == 1.2345e-30f) "
                  "Vec<VEC>::store(o, total);")],
    "taps_only": [
        ("  static __device__ __forceinline__ float ld(const float* p) {",
         "  static __device__ __forceinline__ float fake(int c) "
         "{ return __int_as_float(c); }\n"
         "  static __device__ __forceinline__ float ld(const float* p) {"),
        ("  static __device__ __forceinline__ float4 ld(const float* p) {",
         "  static __device__ __forceinline__ float4 fake(int c) "
         "{ const float f = __int_as_float(c); "
         "return make_float4(f, f, f, f); }\n"
         "  static __device__ __forceinline__ float4 ld(const float* p) {"),
        ("Vec<VEC>::ld(tex + (size_t)texel[k] * ch)",
         "Vec<VEC>::fake(texel[k])")],
    "cached_stores": [
        ("    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));",
         "    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);")],
    "one_d": _k2_shape(32, 1, 8, 1),
    "tile_16x2": _k2_shape(16, 2, 2, 4),
    "tile_4x8": _k2_shape(4, 8, 4, 2),
    "warps4": _k2_shape(8, 4, 2, 2),
    "warps16": _k2_shape(8, 4, 4, 4),
    "warps32": _k2_shape(8, 4, 4, 8),
}
K2_DESIGNS = {  # a line of the source that tells the design: its variants
    "warp tiles, taps by shuffles": ("constexpr int TW = ", K2_VARIANTS),
    "one thread per pixel and 4 channels": ("int n_pix", {"real": []}),
}


def warp_tiles(a: torch.Tensor, tile=(8, 4)) -> torch.Tensor:
    """[N, H, W, ...] -> [T, TW * TH, ...]: the warps' pixel tiles of K2
    in the kernel's order (image, tile row, tile column), lane = row * TW
    + column; the frame padded with zeros to whole tiles."""
    tw, th = tile
    n, h, w = a.shape[:3]
    hp, wp = -(-h // th) * th, -(-w // tw) * tw
    rest = a.shape[3:]
    pad = torch.zeros((n, hp, wp, *rest), dtype=a.dtype, device=a.device)
    pad[:, :h, :w] = a
    return (pad.reshape(n, hp // th, th, wp // tw, tw, *rest).transpose(2, 3)
            .reshape(n * (hp // th) * (wp // tw), th * tw, *rest))


def gather_counts(uv_map: torch.Tensor, sizes, ch: int,
                  tiles=((8, 4), (32, 8), (16, 16))) -> dict:
    """What K2's taps touch on uv_map, counted on the host: the texels per
    level (texture_cuda.touched_texels), the bytes of the floor (uv, the
    touched texels and the output, each once), the every-texel figure
    beside it, the bytes the taps ask of L1 (16 x C x 4 a pixel over four
    levels), the boxes of the covered pixels' taps (uv not 0) per tile
    shape and level (median, p99, largest, share of tiles over 512
    texels, among tiles holding a covered pixel), and the share of tiles
    whose taps reach the corner texel of uv = 0 beside covered ones."""
    from rnr_tpu_torch.ops.interpolate import bilinear_taps
    from rnr_tpu_torch.ops.texture_cuda import level_coords, touched_texels
    n_pix = uv_map.numel() // 2
    touched = touched_texels(uv_map, sizes)
    res = dict(touched=touched,
               floor_bytes=n_pix * (2 + ch) * 4 + sum(touched) * ch * 4,
               all_texels_bytes=n_pix * (2 + ch) * 4
               + sum(s * s for s in sizes) * ch * 4,
               l1_bytes=n_pix * 4 * len(sizes) * ch * 4, boxes={},
               corner_share={})
    covered = (uv_map != 0).any(-1)
    big = torch.iinfo(torch.int64).max
    for tile in tiles:
        cov = warp_tiles(covered, tile)
        has = cov.any(1)
        res["corner_share"][tile] = float(
            (has & warp_tiles(~covered, tile).any(1)).sum()) / max(
            int(cov.shape[0]), 1)
        uvt = warp_tiles(uv_map, tile)
        for s in sizes:
            x, y = level_coords(uvt, s)
            idx = torch.stack([i for i, _ in bilinear_taps(x, y, s, s)], -1)
            tx, ty = idx % s, idx // s
            bw = (torch.where(cov, tx[..., 2], -1).max(1).values
                  - torch.where(cov, tx[..., 0], big).min(1).values + 1)
            bh = (torch.where(cov, ty[..., 1], -1).max(1).values
                  - torch.where(cov, ty[..., 0], big).min(1).values + 1)
            area = (bw * bh)[has].double()
            res["boxes"][(tile, s)] = dict(
                median=float(area.median()) if area.numel() else 0.0,
                p99=float(torch.quantile(area, 0.99)) if area.numel() else 0.0,
                largest=float(area.max()) if area.numel() else 0.0,
                over_512=float((area > 512).double().mean())
                if area.numel() else 0.0)
    return res



# The SH sources, built for lmax 10 alone (the shared header inlined).
SH_COMMON = [("CASE(1) CASE(2) CASE(3) CASE(4) CASE(5)", ""),
             ("CASE(6) CASE(7) CASE(8) CASE(9) CASE(10)", "CASE(10)")]


def _literal_ladder() -> str:
    """The lmax-10 ladder table as an initialised device array: read at
    the compile-time offsets of the unrolled ladder, its loads fold into
    literals."""
    vals = ", ".join(f"{float(np.float32(v))!r}f"
                     for v in ladder_constants(10))
    return f"__device__ const float c_ladder_lit[] = {{{vals}}};\n"


# appended to a build of the design after the thread-per-pixel one: the
# blocks of each lmax-10 bf16 kernel that fit on an SM, as the runtime
# computes them for the launch's block and shared-memory sizes
OCCUPANCY = """
extern "C" int rnr_sh_fan_blocks_per_sm(int bwd, int r_total) {
  int n = -1;
  const int lt = (int)sizeof(__nv_bfloat16);
  if (bwd) {
    const int smem = BwdSmem(10, r_total, lt).total_bytes;
    set_smem((const void*)sh_fan_bwd_kernel<10, __nv_bfloat16>, smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, sh_fan_bwd_kernel<10, __nv_bfloat16>, FAN_BWD_THREADS, smem);
  } else {
    const int smem = FWD_PIXELS * r_total * 3 * lt;
    set_smem((const void*)sh_fan_kernel<10, __nv_bfloat16>, smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, sh_fan_kernel<10, __nv_bfloat16>, FWD_THREADS, smem);
  }
  return n;
}
"""


# per design of csrc/sh_fan.cu (told apart by a line only it has):
# {variant: switches} for K1 and K1b
SH_DESIGNS = {
    "thread per pixel, d coeff through shared memory": (
        "dot_basis_rows<NB>(bs, lg, tid, acc0, acc1);",
        {"real": [],
         "ladder_only": [
             ("""      fold_radiance(l, m, q, cm, sm, rad);
    });""", """      rad[0] += q;
    });"""),
             ("""      const float contrib = load_lt(lt + r * 3 + c) * (rad[c] * al);
      if (r < r_spec) acc_s[c] += contrib * inv_spec;
      else acc_d[c] += contrib * inv_diff;""",
              "      if (c == 0) acc_s[0] += rad[0];")],
         "no_lt_loads": [
             ("const float contrib = load_lt(lt + r * 3 + c) * (rad[c] * al);",
              "const float contrib = 1.5f * (rad[c] * al);")],
         "literals": "LITERALS"},
        {"real": [],
         "no_dcoeff": [
             ("fold_radiance(l, m, q, cm, sm, rad, bs, tid);",
              "fold_radiance(l, m, q, cm, sm, rad);"),
             ("""    lg[tid] = make_float4(ltg[0], ltg[1], ltg[2], 0.f);
    __syncthreads();
    dot_basis_rows<NB>(bs, lg, tid, acc0, acc1);
    __syncthreads();""", "    acc0[0] += ltg[0] + ltg[1] + ltg[2];")],
         "no_dlt_stores": [
             ("store_lt(dl + r * 3 + c, rad[c] * gsel);",
              "if (rad[c] == 1.2345e-30f) store_lt(dl + r * 3 + c, rad[c] * gsel);")],
         "forward_only": [
             ("fold_radiance(l, m, q, cm, sm, rad, bs, tid);",
              "fold_radiance(l, m, q, cm, sm, rad);"),
             ("""    lg[tid] = make_float4(ltg[0], ltg[1], ltg[2], 0.f);
    __syncthreads();
    dot_basis_rows<NB>(bs, lg, tid, acc0, acc1);
    __syncthreads();""", "    acc0[0] += ltg[0] + ltg[1] + ltg[2];"),
             ("store_lt(dl + r * 3 + c, rad[c] * gsel);",
              "if (rad[c] == 1.2345e-30f) store_lt(dl + r * 3 + c, rad[c] * gsel);")]},
        [("c_ladder[k++]", "c_ladder_lit[k++]"),
         ("template <int LMAX, typename Put>\n__device__ __forceinline__ void sh_ladder(",
          "LADDER_LIT\ntemplate <int LMAX, typename Put>\n"
          "__device__ __forceinline__ void sh_ladder(")],
        {}),
    "orders split between warps, d coeff in registers": (
        "owned_orders<LMAX, decltype(wc)::value>(ct, t1c, t1s, ltg, tpow, j,",
        {"real": [],
         "ladder_only": [
             ("""          a[i][c] = fmaf(cf<l, m>(c), r[i], a[i][c]);
          if constexpr (m > 0) b[i][c] = fmaf(cf<l, -m>(c), r[i], b[i][c]);""",
              "          if (c == 0) a[i][0] += r[i];"),
             ("""        a[i][c] = cf<m, m>(c);
        if constexpr (m > 0) b[i][c] = cf<m, -m>(c);""",
              "        a[i][c] = 0.f;"),
             ("        else rad[i][c] = fmaf(tc[i], a[i][c], fmaf(ts[i], b[i][c], "
              "rad[i][c]));",
              "        else if (c == 0) rad[i][0] += a[i][0] + tc[i] + ts[i];"),
             ("""        const float v = load_lt(lt[i] + r * 3 + c) * rad[i][c];
        if (is_spec) acc_s[i][c] += v;
        else acc_d[i][c] += v;""", "        acc_s[i][c] += rad[i][c];")],
         "no_lt_loads": [
             ("""  copy_rows(lts, rays_lt + (size_t)p0 * row, np * row * (int)sizeof(LT),
            threadIdx.x, FWD_THREADS);""", ""),
             ("const float v = load_lt(lt[i] + r * 3 + c) * rad[i][c];",
              "const float v = 1.5f * rad[i][c];")],
         "coeff_literals": [
             ("  return c_coeff[(L * L + L + M) * 3 + c];",
              "  return 0.01f * (float)(((L * L + L + M) * 3 + c) % 7 + 1);")],
         "occupancy": "OCCUPANCY",
         "one_pixel": [
             ("constexpr int FWD_NP = 2; ", "constexpr int FWD_NP = 1; "),
             ("constexpr int FWD_THREADS = 64;",
              "constexpr int FWD_THREADS = 128;")]},
        {"real": [],
         "no_dcoeff": "NO_DCOEFF",
         "no_dlt_stores": "NO_DLT",
         "forward_only": "NO_DCOEFF+NO_DLT",
         "staging": "STAGING",
         "two_rays": [("constexpr int FAN_BWD_NP = 1; ",
                       "constexpr int FAN_BWD_NP = 2; ")],
         "four_blocks": [
             ("__launch_bounds__(FAN_BWD_THREADS, 3)",
              "__launch_bounds__(FAN_BWD_THREADS, 4)")],
         "dc_immediate": [
             ("            dc[s][c] = fmaf(r[i], cl[i][c], dc[s][c]);",
              "            dc[s][c] = fmaf(r[i], 1.5f, dc[s][c]);"),
             ("              dc[s + 1][c] = fmaf(r[i], sl[i][c], dc[s + 1][c]);",
              "              dc[s + 1][c] = fmaf(r[i], 2.5f, dc[s + 1][c]);")],
         "dc_one_channel": [
             ("            dc[s][c] = fmaf(r[i], cl[i][c], dc[s][c]);",
              "            if (c == 0) dc[s][c] = fmaf(r[i], cl[i][c], dc[s][c]);"),
             ("              dc[s + 1][c] = fmaf(r[i], sl[i][c], dc[s + 1][c]);",
              "              if (c == 0) dc[s + 1][c] = fmaf(r[i], sl[i][c], "
              "dc[s + 1][c]);")],
         "skeleton": "STAGING+NO_BUILD+NO_SUM+NO_IO",
         "occupancy": "OCCUPANCY",
         "no_reduce": [("  for_warp(warp, [&](auto wc) {\n    owned_rows_out<",
                        "  if (np == -7) for_warp(warp, [&](auto wc) {\n    owned_rows_out<")],
         "no_partials_sum": [("  sum_fan_partials<<<", "  if (n_pix == -7) sum_fan_partials<<<")],
         "px128": [("constexpr int FAN_BWD_PIXELS = 64; ",
                    "constexpr int FAN_BWD_PIXELS = 128; "),
                   ("constexpr int FAN_CHUNK_RAYS = 4; ",
                    "constexpr int FAN_CHUNK_RAYS = 2; ")],
         "six_warps": [("constexpr int FAN_WARPS = 4; ",
                        "constexpr int FAN_WARPS = 6; "),
                       ("constexpr int FAN_CHUNK_RAYS = 4; ",
                        "constexpr int FAN_CHUNK_RAYS = 3; ")]},
        [],
        {"OCCUPANCY": [('extern "C" int rnr_sh_shade_fan_bwd_partials(',
                        OCCUPANCY
                        + 'extern "C" int rnr_sh_shade_fan_bwd_partials(')],
         "STAGING": [
            ("""owned_orders<LMAX, decltype(wc)::value>(ct, t1c, t1s, ltg, tpow, j,
                                                dc, rad);""",
             "rad[0][0] = ct[0] + t1c[0] + t1s[0] + ltg[0][1] + tpow[j].x;")],
         "NO_BUILD": [("    if (k + 1 < n_chunks)\n      build_rays<LMAX>(",
                       "    if (k + 1 < -7)\n      build_rays<LMAX>(")],
         "NO_SUM": [("    if (k > 0)\n      sum_radiance(",
                     "    if (k < -7)\n      sum_radiance(")],
         "NO_IO": [
             ("  copy_rows(rows, rays_lt + (size_t)p0 * row, row_bytes, tid, "
              "FAN_BWD_THREADS);", ""),
             ("  copy_rows(dlt + (size_t)p0 * row, rows, row_bytes, tid,",
              "  if (row_bytes == -7) copy_rows(dlt + (size_t)p0 * row, rows, "
              "row_bytes, tid,")],
         "NO_DCOEFF": [
            ("          dc[s0][c] += cl[i][c];\n", ""),
            ("            dc[s0 + 1][c] += sl[i][c];\n", ""),
            ("            dc[s][c] = fmaf(r[i], cl[i][c], dc[s][c]);\n", ""),
            ("              dc[s + 1][c] = fmaf(r[i], sl[i][c], dc[s + 1][c]);\n",
             "")],
         "NO_DLT": [
             ("  copy_rows(dlt + (size_t)p0 * row, rows, row_bytes, tid,",
              "  if (row_bytes == -7) copy_rows(dlt + (size_t)p0 * row, rows, "
              "row_bytes, tid,")]}),
}


# The order-split backward moved to csrc/sh_bwd.cuh, shared with K5b: K1 and
# K1b take the same switches as in the design before, but for the walk's
# call (staging), the partials' sum and the occupancy query.
_SPLIT = SH_DESIGNS["orders split between warps, d coeff in registers"]
SH_DESIGNS = {
    "orders split between warps, shared with K5b (sh_bwd.cuh)": (
        "order_split_bwd<LMAX>(sm, FanRays{", _SPLIT[1], dict(
            _SPLIT[2], no_partials_sum=[
                ("  sum_fan_partials<<<",
                 "  if (blocks == -7) sum_fan_partials<<<")]),
        _SPLIT[3], dict(
            _SPLIT[4],
            OCCUPANCY=[('extern "C" int rnr_sh_shade_fan_bwd_partials(',
                        OCCUPANCY.replace(
                            "BwdSmem(10, r_total, lt).total_bytes",
                            "bwd_smem<FanRays>(10, r_total, lt).total_bytes")
                        + 'extern "C" int rnr_sh_shade_fan_bwd_partials(')],
            STAGING=[("""owned_orders<LMAX, decltype(wc)::value, NP, NPOW>(ct, t1c, t1s, ltg,
                                                          tpow, j, dc, rad);""",
                      "rad[0][0] = ct[0] + t1c[0] + t1s[0] + ltg[0][1] + "
                      "tpow[j].x;")])),
    **SH_DESIGNS}


# per design of csrc/conv4x4_slab.cu (told apart by a line only it has,
# the first match counting): {variant: switches}
K8_DESIGNS = {
    "wgmma over TMA bands, epilogue of conv4x4_common.cuh": (
        '#include "conv4x4_common.cuh"',
        {"real": [],
         "no_mma": [("          sm90::wgmma<0, 1>(acc[UP ? i : 0], da, db);",
                     "          (void)da;\n          (void)db;")],
         "no_loads": [
             ("        const bool fix = lo == 0 ? left : right;",
              "        const bool fix = it < g.stages && (lo == 0 ? left : right);"),
             ("""        if (warp == 0) {
          if (lane == 0) {
            const uint32_t bar = fix ? tma_bar + 8 * s : full_bar + 8 * s;""",
              """        if (warp == 0 && it >= g.stages) {
          if (lane == 0) sm90::mbar_arrive(full_bar + 8 * s);
        } else if (warp == 0) {
          if (lane == 0) {
            const uint32_t bar = fix ? tma_bar + 8 * s : full_bar + 8 * s;""")],
         "no_epilogue": [("    if (d < 0 || oc >= o) continue;",
                          "    if (d < 0 || oc >= o || d != -7) continue;")]}),
    "WMMA on bands staged by plain loads": (
        "wmma::mma_sync(acc[i], fa, fb, acc[i]);",
        {"real": [],
         "no_mma": [("wmma::mma_sync(acc[i], fa, fb, acc[i]);", "")],
         "no_loads": [
             ("""      // ---- stage A: the packed band's [YR, BK] slice ----
      if (VA) {""", """      // ---- stage A: the packed band's [YR, BK] slice ----
      if (k0 > 0 || p > 0) {
      } else if (VA) {"""),
             ("""      // ---- stage B: the packed weights' [BK, YC] slice ----
      if (VB) {""", """      // ---- stage B: the packed weights' [BK, YC] slice ----
      if (k0 > 0 || p > 0) {
      } else if (VB) {""")],
         "no_epilogue": [("    store_out(y + dst * o + oc, v);",
                          "    if (v == 1.2345e-30f) store_out(y + dst * o + oc, v);")]}),
    "wgmma over TMA bands": (
        "sm90::wgmma<0, 1>(acc[UP ? i : 0], da, db);",
        {"real": [],
         "no_mma": [("          sm90::wgmma<0, 1>(acc[UP ? i : 0], da, db);",
                     "          (void)da;\n          (void)db;")],
         "no_loads": [
             ("        const bool fix = lo == 0 ? left : right;",
              "        const bool fix = it < g.stages && (lo == 0 ? left : right);"),
             ("""        if (warp == 0) {
          if (lane == 0) {
            const uint32_t bar = fix ? tma_bar + 8 * s : full_bar + 8 * s;""",
              """        if (warp == 0 && it >= g.stages) {
          if (lane == 0) sm90::mbar_arrive(full_bar + 8 * s);
        } else if (warp == 0) {
          if (lane == 0) {
            const uint32_t bar = fix ? tma_bar + 8 * s : full_bar + 8 * s;""")],
         "no_epilogue": [("        if (d < 0 || oc >= g.o) continue;",
                          "        if (d < 0 || oc >= g.o || d != -7) continue;")]}),
}


_SKIP_MMA_K6 = ("namespace {\n\nusing namespace conv4;\n",
                "namespace {\n\nusing namespace conv4;\ntemplate <typename A>\n"
                "__device__ __forceinline__ void skip_mma(A&, uint64_t, "
                "uint64_t) {}\n")
# per design of csrc/conv4x4.cu: (marker, {variant: switches})
K6_DESIGNS = {
    "one-stage WMMA, a gather per tap": (
        "wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);",
        {"real": [],
         "no_mma": [("wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);",
                     "(void)fb[j];")],
         "no_loads": [
             ("      if (VA && src >= 0 && cb + 16 <= c) {",
              "      if (tap > 0 || c0 > 0) {\n"
              "      } else if (VA && src >= 0 && cb + 16 <= c) {"),
             ("        if (VB && ci < c && oc + 8 <= o) {",
              "        if (tap > 0 || c0 > 0) {\n"
              "        } else if (VB && ci < c && oc + 8 <= o) {")],
         "no_epilogue": [
             ("    store_out(y + dst * o + oc, Cs[r * LDC + col]);",
              "    if (Cs[r * LDC + col] == 1.2345e-30f)\n"
              "      store_out(y + dst * o + oc, Cs[r * LDC + col]);")]}),
    "wgmma over TMA-staged parity-plane bands": (
        "convt_products(acc[2 * a], acc[2 * a + 1], sa, band, k, pos, g);",
        {"real": [],
         "no_mma": [_SKIP_MMA_K6, ("sm90::wgmma<0, 1>(", "skip_mma(")],
         "no_loads": [
             ("        const bool fix = pc == 0 ? left : right;",
              "        const bool fix = it < g.stages && (pc == 0 ? left : right);"),
             ("""        if (warp == 0) {
          if (lane == 0) {
            const uint32_t bar = fix ? tma_bar + 8 * s : full_bar + 8 * s;""",
              """        if (warp == 0 && it >= g.stages) {
          if (lane == 0) sm90::mbar_arrive(full_bar + 8 * s);
        } else if (warp == 0) {
          if (lane == 0) {
            const uint32_t bar = fix ? tma_bar + 8 * s : full_bar + 8 * s;""")],
         "no_epilogue": [("    if (d < 0 || oc >= o) continue;",
                          "    if (d < 0 || oc >= o || d != -7) continue;")],
         "no_split": [
             ("  return launch_sum_splits(pp, static_cast<OutT*>(y), "
              "g.out_elems, splits,\n                           stream);",
              "  return 0;")]}),
}
# the frame's 4x4 convs (C, O, x's side): five down, five transpose
CONV4_DOWN = [(64, 128, 512), (128, 256, 256), (256, 512, 128),
              (512, 512, 64), (512, 512, 32)]
CONV4_UP = [(512, 512, 16), (1024, 512, 32), (1024, 256, 64),
            (512, 128, 128), (256, 64, 256)]


def conv4_variants(src: str, designs: dict, csrc: str):
    """(design, variants) of csrc/<src>.cu found in csrc."""
    text = open(os.path.join(csrc, f"{src}.cu")).read()
    for design, (marker, table) in designs.items():
        if marker in text:
            return design, table
    raise RuntimeError(f"{csrc}/{src}.cu: no known design")


def time_conv4(dev, stream, csrc: str, pair: str, only=None) -> None:
    """K6 (pair "K6") or K8c / K8d ("K8") at the kernels phase's shapes of
    chip_smoke.py (one random stream of inputs per shape), queued device
    time per call of each variant, per shape and summed per kernel and
    use; the real build's output digest per case."""
    from rnr_tpu_torch.ops.conv4_cuda import conv4_plan, conv4s_plan
    src, designs, plan_of = (("conv4x4", K6_DESIGNS, conv4_plan)
                             if pair == "K6" else
                             ("conv4x4_slab", K8_DESIGNS, conv4s_plan))
    design, table = conv4_variants(src, designs, csrc)
    if only:
        table = {k: v for k, v in table.items() if k in only}
    tag = "" if csrc == str(_build.CSRC) else "_other"
    new = design.startswith("wgmma")
    print(f"{pair} kernels of {csrc}: {design}", flush=True)
    libs = build_all(src, table, csrc, tag)
    down_k, up_k = ("K6a", "K6b") if pair == "K6" else ("K8c", "K8d")
    # (kernel, use, x's C, O, x's side, up, reflect, f32 out)
    cases = ([(down_k, "fwd", c, o, h, False, 1, False)
              for c, o, h in CONV4_DOWN]
             + [(down_k, "dgrad", o, c, 2 * h, False, 0, True)
                for c, o, h in CONV4_UP]
             + [(up_k, "fwd", c, o, h, True, 0, False) for c, o, h in CONV4_UP])
    if pair == "K6":   # convt4 f32 as the down convs' "same" dgrad
        cases += [(up_k, "dgrad", o, c, h // 2, True, 0, True)
                  for c, o, h in CONV4_DOWN]
    total: dict = {}
    for kname, use, c, o, h, is_up, refl, f32 in cases:
        rng = np.random.default_rng(c + o + h)
        x = torch.from_numpy(rng.standard_normal((1, h, h, c)).astype(
            np.float32)).to(dev, torch.bfloat16)
        w = torch.from_numpy((rng.standard_normal((4, 4, c, o))
                              / np.sqrt(16 * c)).astype(np.float32)).to(
            dev, torch.bfloat16)
        side = 2 * h if is_up else h // 2
        y = torch.empty((1, side, side, o), device=dev,
                        dtype=torch.float32 if f32 else torch.bfloat16)
        sym = ("rnr_convt4" if is_up else "rnr_down4") + (
            "s" if pair == "K8" else "") + ("_f32out" if f32 else "")
        pad = () if is_up else (refl,)
        if new:
            plan = plan_of(1, h, h, c, o, is_up)
            part = torch.empty(max(plan[3], 1) * y.numel(), device=dev)
            ptrs = (x.data_ptr(), w.data_ptr(), y.data_ptr(),
                    part.data_ptr())
            ints = (1, h, h, c, o, *pad, *plan)
        else:
            plan = None
            ptrs = (x.data_ptr(), w.data_ptr(), y.data_ptr())
            ints = (1, h, h, c, o, *pad)
        flops = 2 * 16 * c * o * (h * h if is_up else (h // 2) ** 2)
        for name, lib in libs.items():
            f = entry(lib, sym, len(ptrs), len(ints))
            us = device_us(lambda: f(*ptrs, *ints, stream))
            total[(kname, use, name)] = total.get((kname, use, name), 0) + us
            torch.cuda.synchronize()
            dig = (f"; digest {digest(y)}" if name == "real" else "")
            print(f"{kname} {use} {c}->{o} @{h} {name}: {us:.2f} us per "
                  f"call ({flops / us / 1e6:.1f} TFLOP/s; plan {plan}{dig})",
                  flush=True)
        del x, w, y
    for (kname, use, name), us in total.items():
        print(f"{kname} {use} five shapes {name}: {us:.2f} us", flush=True)


def digest(t: torch.Tensor) -> str:
    """The first 16 hex digits of sha256 of the tensor's bytes."""
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()[:16]


# per design of csrc/conv3x3_slab.cu (K8a) and conv3x3_slab_wgrad.cu (K8b),
# told apart by a line only the K8a source of that design has:
# {variant: switches} of each source
_SKIP_MMA = ("#include \"sm90.cuh\"\n", "#include \"sm90.cuh\"\n"
             "template <typename A>\n__device__ __forceinline__ void "
             "skip_mma(A&, uint64_t, uint64_t) {}\n")
K8S_DESIGNS = {
    "WMMA on staged slab tiles": (
        "wmma::mma_sync(acc[i], fa, fb, acc[i]);",
        {"real": [],
         "no_mma": [("wmma::mma_sync(acc[i], fa, fb, acc[i]);", "")],
         "no_loads": [
             ("      // ---- stage A: band dy's [YR, BK] slice ----\n"
              "      if (tid < GROUPS) {",
              "      // ---- stage A: band dy's [YR, BK] slice ----\n"
              "      if (tid < GROUPS && dy + c0 == 0) {"),
             ("      for (int e = tid; e < BK * (YC / 8); e += THREADS) {",
              "      for (int e = dy + c0 == 0 ? tid : BK * (YC / 8); "
              "e < BK * (YC / 8); e += THREADS) {")],
         "no_epilogue": [
             ("      store_out(y + (grow * wd + cu) * o + oc, v + bias[oc]);",
              "      if (v == 1.2345e-30f) store_out(y + (grow * wd + cu) * o"
              " + oc, v + bias[oc]);")]},
        {"real": [],
         "no_mma": [("        for (int i = 0; i < 2; ++i) wmma::mma_sync("
                     "acc[i][j], fa[i], fb, acc[i][j]);", "        (void)fb;")],
         "no_loads": [
             ("    // ---- stage A: xp's band-dy row at 32 slab pixels, 64 "
              "channels ----\n    {",
              "    // ---- stage A: xp's band-dy row at 32 slab pixels, 64 "
              "channels ----\n    if (p0 == p_begin) {"),
             ("    for (int e = tid; e < GR * (NB / 8); e += THREADS) {",
              "    for (int e = p0 == p_begin ? tid : GR * (NB / 8); "
              "e < GR * (NB / 8); e += THREADS) {")],
         "no_epilogue": [
             ("      if (ci < c && oc < o) tap[(size_t)ci * o + oc] = "
              "Cs[r * LDC + col];",
              "      if (ci < c && oc < o && ci < 0) tap[(size_t)ci * o + oc]"
              " = Cs[r * LDC + col];")],
         "no_reduce": [
             ("  if (e != cudaSuccess || splits == 1) return (int)e;",
              "  if (e != cudaSuccess || splits >= 1) return (int)e;")]}),
    "wgmma over TMA bands, three dx accumulators": (
        "  const int tiles = g.row_tiles + (RING ? 2 * g.strips * g.n * "
        "g.o_tiles : 0);",
        {"real": [],
         "no_mma": [_SKIP_MMA, ("sm90::wgmma<0, 1>(", "skip_mma(")],
         "no_loads": [
             ("        const bool patch = fix;",
              "        const bool patch = fix && it < K::STAGES;"),
             ("            const uint32_t bar = patch ? tma_bar + 8 * s : "
              "full_bar + 8 * s;",
              "            if (it >= K::STAGES) {\n"
              "              sm90::mbar_arrive(full_bar + 8 * s);\n"
              "              continue;\n            }\n"
              "            const uint32_t bar = patch ? tma_bar + 8 * s : "
              "full_bar + 8 * s;")],
         "no_epilogue": [("      if (d < 0 || oc >= g.o) continue;",
                          "      if (d < 0 || oc >= g.o || d != -7) continue;")],
         "no_ring": [
             ("  const int tiles = g.row_tiles + (RING ? 2 * g.strips * g.n * "
              "g.o_tiles : 0);", "  const int tiles = g.row_tiles;")],
         "no_fold": [
             ("  return conv3::fold_ring(static_cast<float*>(y), n, h, wd, o, "
              "stream);", "  return 0;")]},
        {"real": [],
         "no_mma": [("        sm90::wgmma<1, 1>(acc[dx], da, db);",
                     "        (void)da;\n        (void)db;")],
         "no_loads": [
             ("    if (tid == 0 && u + STAGES < units) load(u + STAGES);",
              "    if (tid == 0 && u + STAGES < units)\n"
              "      sm90::mbar_arrive(full_bar + 8 * s);")],
         "no_epilogue": [("        if (ci < c && oc < o)\n",
                          "        if (ci < c && oc < o && ci < 0)\n")],
         "no_reduce": [("  if (e != 0 || splits == 1) return e;",
                        "  if (e != 0 || splits >= 1) return e;")]}),
}
# the variants that only one side of a design has (the rest time both)
K8S_ONLY = {"no_ring": "K8a", "no_fold": "K8a", "no_reduce": "K8b"}


def k8s_variants(csrc: str):
    """(design, K8a variants, K8b variants) of the slab sources in csrc."""
    text = open(os.path.join(csrc, "conv3x3_slab.cu")).read()
    for design, (marker, k8a, k8b) in K8S_DESIGNS.items():
        if marker in text:
            return design, k8a, k8b
    raise RuntimeError(f"{csrc}/conv3x3_slab.cu: no known design")


def _wmma_wgrad_plan(n_pix: int, tiles: int) -> tuple[int, int]:
    """The WMMA design's split-K (its ops/conv_cuda.py::wgrad_splits):
    about 1024 blocks, each summing a multiple of 32 slab pixels."""
    steps = -(-n_pix // 32)
    want = max(1, min(steps, -(-1024 // tiles)))
    chunk = -(-steps // want) * 32
    return -(-n_pix // chunk), chunk


def time_k8s(dev, stream, csrc: str, only=None) -> None:
    """K8a (forward under reflect, bf16 out; its f32 data gradient under
    reflect and under "same") and K8b (reflect) at the kernels phase's 14
    3x3 convs of chip_smoke.py, queued device time per call of each
    variant, per shape and summed per kernel and use.  The WMMA design's
    reflect dgrad is timed as its C call on g zero-padded by one ring
    (the padding and the fold were torch ops around it)."""
    from rnr_tpu_torch.ops import conv_cuda as cc
    design, ta, tb = k8s_variants(csrc)
    if only:
        ta = {k: v for k, v in ta.items() if k in only}
        tb = {k: v for k, v in tb.items() if k in only}
    tag = "" if csrc == str(_build.CSRC) else "_other"
    new = design.startswith("wgmma")
    print(f"K8s kernels of {csrc}: {design}", flush=True)
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=2) as pool:
        fa = pool.submit(build_all, "conv3x3_slab", ta, csrc, tag)
        fb = pool.submit(build_all, "conv3x3_slab_wgrad", tb, csrc, tag)
        libs = {"K8a": fa.result(), "K8b": fb.result()}
    shapes = [(108, 64, 512), (64, 64, 512), (128, 640, 256),
              (640, 128, 256), (128, 128, 256), (256, 256, 128),
              (512, 512, 64), (512, 512, 32), (512, 512, 32),
              (512, 512, 64), (256, 256, 128), (128, 128, 256),
              (64, 64, 512), (128, 78, 512)]
    total: dict = {}
    for c, o, h in shapes:
        rng = np.random.default_rng(c + o + h)
        x = torch.from_numpy(rng.standard_normal((1, h, h, c)).astype(
            np.float32)).to(dev, torch.bfloat16)
        g = torch.from_numpy(rng.standard_normal((1, h, h, o)).astype(
            np.float32)).to(dev, torch.bfloat16)
        w = torch.from_numpy((rng.standard_normal((3, 3, c, o))
                              / np.sqrt(9 * c)).astype(np.float32)).to(dev)
        w_rot = w.flip(0, 1).transpose(2, 3)
        bias = torch.zeros(o, device=dev)
        flops = 2 * 9 * c * o * h * h
        calls = {}      # use -> (kernel, symbol, ptrs, ints, keep-alive)
        if new:
            c8, o8 = cc.round8(c), cc.round8(o)
            xb, gb = cc.pad_channels(x, c8), cc.pad_channels(g, o8)
            wb, wr = cc.k3_weights(w, c8), cc.k3_weights(w_rot, o8)
            y = torch.empty((1, h, h, o), device=dev, dtype=torch.bfloat16)
            dx = torch.empty((h * h + cc.ring_len(h, h)) * c, device=dev)
            calls["fwd"] = ("K8a", "rnr_conv3x3s", (xb, wb, bias, y),
                            (1, h, h, c8, o, 1, *cc.k8a_plan(1, h, h, o,
                                                             False)))
            calls["dgrad"] = ("K8a", "rnr_conv3x3s_f32out", (gb, wr, None, dx),
                              (1, h, h, o8, c, 2, *cc.k8a_plan(1, h, h, c,
                                                               True)))
            calls["dgrad_same"] = ("K8a", "rnr_conv3x3s_f32out",
                                   (gb, wr, None, dx),
                                   (1, h, h, o8, c, 0,
                                    *cc.k8a_plan(1, h, h, c, False)))
            splits, per = cc.k8b_plan(1, h, h, c8, o8)
            dw = torch.empty((3, 3, c8, o8), device=dev)
            part = torch.empty(max(splits, 1) * dw.numel(), device=dev)
            calls["wgrad"] = ("K8b", "rnr_conv3x3s_wgrad", (xb, gb, part, dw),
                              (1, h, h, c8, o8, 1, splits, per))
        else:
            wb = w.to(torch.bfloat16).contiguous()
            wr = w_rot.to(torch.bfloat16).contiguous()
            gp = F.pad(g, (0, 0, 1, 1, 1, 1))
            y = torch.empty((1, h, h, o), device=dev, dtype=torch.bfloat16)
            dxp = torch.empty((1, h + 2, h + 2, c), device=dev)
            zc = torch.zeros(c, device=dev)
            calls["fwd"] = ("K8a", "rnr_conv3x3s", (x, wb, bias, y),
                            (1, h, h, c, o, 1))
            calls["dgrad"] = ("K8a", "rnr_conv3x3s_f32out", (gp, wr, zc, dxp),
                              (1, h + 2, h + 2, o, c, 0))
            calls["dgrad_same"] = ("K8a", "rnr_conv3x3s_f32out",
                                   (g, wr, zc, dxp), (1, h, h, o, c, 0))
            splits, chunk = _wmma_wgrad_plan(h * (h + 2), 3 * -(-c // 64)
                                             * -(-o // 64))
            dw = torch.empty((3, 3, c, o), device=dev)
            part = torch.empty(max(splits, 1) * dw.numel(), device=dev)
            calls["wgrad"] = ("K8b", "rnr_conv3x3s_wgrad", (x, g, part, dw),
                              (1, h, h, c, o, 1, splits, chunk))
        for use, (kern, sym, ts, ints) in calls.items():
            ptrs = [None if t is None else t.data_ptr() for t in ts]
            for name, lib in libs[kern].items():
                if K8S_ONLY.get(name, kern) != kern:
                    continue
                f = entry(lib, sym, len(ptrs), len(ints))
                us = device_us(lambda: f(*ptrs, *ints, stream))
                key = (kern, use, name)
                total[key] = total.get(key, 0) + us
                print(f"{kern} {use} {c}->{o} @{h} {name}: {us:.2f} us per "
                      f"call ({flops / us / 1e6:.1f} TFLOP/s; plan "
                      f"{ints[5 if kern == 'K8a' else 6:]})", flush=True)
        del x, g, calls
    for (kern, use, name), us in total.items():
        print(f"{kern} {use} 14 shapes {name}: {us:.2f} us", flush=True)


# per design of csrc/gemm_chain.cu (P1), told apart by a line only it
# has: {variant: switches}
P1_DESIGNS = {
    "persistent wgmma over TMA, x shared by the T products": (
        "template <int BN, int MW, bool RES>\n__global__ void",
        {"real": [],
         "no_mma": [_SKIP_MMA, ("sm90::wgmma<0, 1>(", "skip_mma(")],
         "no_loads": [
             ("""        sm90::mbar_arrive_tx(xfull + 8 * xs, K::X_STAGE);
        sm90::tma_load_2d(xring + xs * K::X_STAGE, &xmap, c * KC, m0,
                          xfull + 8 * xs);""",
              """        if (xi >= g.xst) {
          sm90::mbar_arrive(xfull + 8 * xs);
        } else {
          sm90::mbar_arrive_tx(xfull + 8 * xs, K::X_STAGE);
          sm90::tma_load_2d(xring + xs * K::X_STAGE, &xmap, c * KC, m0,
                            xfull + 8 * xs);
        }"""),
             ("            sm90::mbar_arrive_tx(wfull + 8 * ws, K::W_UNIT);",
              "            if (wi >= g.wst) {\n"
              "              sm90::mbar_arrive(wfull + 8 * ws);\n"
              "              continue;\n            }\n"
              "            sm90::mbar_arrive_tx(wfull + 8 * ws, K::W_UNIT);")],
         "no_epilogue": [("        if (row >= g.m || oc >= g.n) continue;",
                          "        if (row >= g.m || oc >= g.n || row != -7) "
                          "continue;")]}),
    "WMMA, single-buffered thread loads": (
        "wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);",
        {"real": [],
         "no_mma": [("wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);",
                     "(void)fb[j];")],
         "no_loads": [
             ("    for (int e = tid; e < BM * (BK / 8); e += THREADS) {",
              "    for (int e = k0 > 0 ? BM * (BK / 8) : tid; e < BM * (BK / 8);"
              " e += THREADS) {"),
             ("      {\n        const int r = tid / (BN / 8), col = (tid % "
              "(BN / 8)) * 8;",
              "      if (k0 == 0 && t == 0) {\n        const int r = tid / "
              "(BN / 8), col = (tid % (BN / 8)) * 8;")],
         "no_epilogue": [
             ("    if (row < m && oc < n) y[row * n + oc] =",
              "    if (row < 0 && oc < n) y[row * n + oc] =")]}),
}
# section A's (K, N, T) as chip_smoke.py runs them (M from its gemm_rows)
P1_SHAPES = [(64, 64, 9), (128, 64, 9), (192, 64, 9), (64, 128, 9),
             (128, 128, 9), (192, 128, 9), (256, 256, 9), (512, 512, 4)]


def _gemm_rows(k: int, n: int, taps: int) -> int:
    rows = 8320
    while (2 * rows * k * 2 + taps * k * n * 2 + rows * n * 4
           + 2 * rows * n * 2) > 13 * 1024 * 1024:
        rows //= 2
    return 16 * rows


def time_p1(dev, stream, csrc: str, only=None) -> None:
    """P1 at section A's eight shapes, queued device time per call of each
    variant, per shape and summed; the current design also with w
    streamed where its plan keeps w resident (w_streamed: the real build,
    residency turned off in the plan)."""
    from rnr_tpu_torch.ops.gemm_chain_cuda import gemm_chain_plan
    text = open(os.path.join(csrc, "gemm_chain.cu")).read()
    design, table = next((d, t) for d, (mk, t) in P1_DESIGNS.items()
                         if mk in text)
    if only:
        table = {k: v for k, v in table.items() if k in only}
    tag = "" if csrc == str(_build.CSRC) else "_other"
    new = design.startswith("persistent")
    print(f"P1 kernels of {csrc}: {design}", flush=True)
    libs = build_all("gemm_chain", table, csrc, tag)
    total: dict = {}
    for k, n, t in P1_SHAPES:
        m = _gemm_rows(k, n, t)
        rng = np.random.default_rng(k + n + t)
        x = torch.from_numpy(rng.standard_normal((m, k)).astype(
            np.float32)).to(dev, torch.bfloat16)
        w = torch.from_numpy((rng.standard_normal((t, k, n)) / np.sqrt(
            k * t)).astype(np.float32)).to(dev, torch.bfloat16)
        y = torch.empty((m, n), device=dev, dtype=torch.bfloat16)
        flops = 2.0 * m * k * n * t
        runs = []      # (variant name, lib, ints)
        for name, lib in libs.items():
            if new:
                plan = gemm_chain_plan(m, k, n, t)
                runs.append((name, lib, (m, k, n, t, *plan)))
                if name == "real" and plan[2] == 1 and (
                        not only or "w_streamed" in only):
                    runs.append(("w_streamed", lib,
                                 (m, k, n, t,
                                  *gemm_chain_plan(m, k, n, t, False))))
            else:
                runs.append((name, lib, (m, k, n, t)))
        for name, lib, ints in runs:
            f = entry(lib, "rnr_gemm_chain", 3, len(ints))
            us = device_us(lambda: f(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                     *ints, stream))
            total[name] = total.get(name, 0) + us
            print(f"P1 M {m} K {k} N {n} T {t} {name}: {us:.2f} us per call "
                  f"({flops / us / 1e6:.1f} TFLOP/s; plan {ints[4:]})",
                  flush=True)
        del x, w, y
    for name, us in total.items():
        print(f"P1 eight shapes {name}: {us:.2f} us", flush=True)


# per design of csrc/sh_shade.cu's forward (K5), told apart by a line only
# it has: {variant: switches}.  The scaled design's ladder_only takes K1's
# switches of the same radiance and accumulation code.
K5_DESIGNS = {
    "scaled ladder, two pixels a thread, staged rows": (
        "    radiance<LMAX>(x, y, z, rad);\n",
        {"real": [],
         "ladder_only": "K1_LADDER_ONLY",
         "no_lt_loads": [
             ("  copy_rows(lts, rays_lt + (size_t)p0 * row, bytes, threadIdx.x,\n"
              "            SHADE_THREADS);\n", ""),
             ("const float v = load_lt(lt[i] + r * 3 + c) * rad[i][c];",
              "const float v = 1.5f * rad[i][c];")],
         "no_staging": [
             ("  copy_rows(rds, rays_dir + (size_t)p0 * row, bytes, threadIdx.x,\n"
              "            SHADE_THREADS);\n"
              "  copy_rows(lts, rays_lt + (size_t)p0 * row, bytes, threadIdx.x,\n"
              "            SHADE_THREADS);\n", ""),
             ("    rd[i] = rds + q * row;\n    lt[i] = lts + q * row;",
              "    rd[i] = rays_dir + (size_t)(p0 + q) * row;\n"
              "    lt[i] = rays_lt + (size_t)(p0 + q) * row;")],
         "one_pixel": [
             ("constexpr int SHADE_NP = 2; ", "constexpr int SHADE_NP = 1; "),
             ("constexpr int SHADE_THREADS = 64;",
              "constexpr int SHADE_THREADS = 128;")]}),
    "unscaled ladder, one pixel a thread": (
        "      fold_radiance(l, m, q, cm, sm, rad);\n    });",
        {"real": [],
         "ladder_only": [
             ("      fold_radiance(l, m, q, cm, sm, rad);\n    });",
              "      rad[0] += q;\n    });"),
             ("""      const float contrib = load_lt(lt + r * 3 + c) * (rad[c] * al);
      if (r < r_spec) acc_s[c] += contrib * inv_spec;
      else acc_d[c] += contrib * inv_diff;""",
              "      if (c == 0) acc_s[0] += rad[0];")],
         "no_lt_loads": [
             ("const float contrib = load_lt(lt + r * 3 + c) * (rad[c] * al);",
              "const float contrib = 1.5f * (rad[c] * al);")]}),
}


def time_k5(dev, stream, csrc: str, only=None) -> None:
    """K5 at chip_smoke.py's kernels_shade case (512^2, lmax 10, 13 + 13
    rays from the fan of the synthetic G-buffer, bf16 rays_dir and
    rays_lt), queued device time per call of each variant, and the SASS
    instruction count of each lmax-10 forward; the real build's output
    digest."""
    from rnr_tpu_torch.ops.sh_cuda import fan_coeff
    text = open(os.path.join(csrc, "sh_shade.cu")).read()
    design, table = next((d, t) for d, (mk, t) in K5_DESIGNS.items()
                         if mk in text)
    if only:
        table = {k: v for k, v in table.items() if k in only}
    k1_ladder = SH_DESIGNS["orders split between warps, d coeff in "
                           "registers"][1]["ladder_only"]
    table = {k: (k1_ladder if v == "K1_LADDER_ONLY" else v)
             for k, v in table.items()}
    tag = "" if csrc == str(_build.CSRC) else "_other"
    new = design.startswith("scaled")
    print(f"K5 kernels of {csrc}: {design}", flush=True)
    libs = build_all("sh_shade", table, csrc, tag)
    for name in table:
        print_sass(os.path.join(OUT, f"sh_shade{tag}_{name}.so"),
                   f"K5 {name}", skip="bwd")
    rd, lt, al, cf, _, _ = k5_inputs(dev)
    lad = torch.tensor(ladder_constants(10), device=dev)
    n_pix = 512 * 512
    spec = torch.empty((n_pix, 3), device=dev)
    diff = torch.empty_like(spec)
    cfs = fan_coeff(cf, 10)
    for name, lib in libs.items():
        if new:
            f = entry(lib, "rnr_sh_shade", 6, 5)
            ptrs = [t.data_ptr() for t in (rd, al, lt, cfs, spec, diff)]
            ints = (10, n_pix, 26, 13, 1)
        else:
            f = entry(lib, "rnr_sh_shade", 7, 6)
            ptrs = [t.data_ptr() for t in (rd, al, lt, cf, lad, spec, diff)]
            ints = (10, lad.numel(), n_pix, 26, 13, 1)
        us = device_us(lambda: f(*ptrs, *ints, stream))
        torch.cuda.synchronize()
        dig = f"; digest {digest(torch.cat([spec, diff]))}" if name == "real" \
            else ""
        print(f"K5 512^2 lmax10 R26 bf16 {name}: {us:.2f} us per call{dig}",
              flush=True)
def k5_inputs(dev):
    """chip_smoke.py's kernels_shade operands: the fan of the synthetic
    G-buffer at 512^2 as bf16 rays_dir (13 + 13 rays), bf16 rays_lt,
    alpha, coeff of lmax 10, and the two output gradients, drawn in that
    script's order."""
    from rnr_tpu_torch.models.rays import RaySampler, build_fan_channels
    from rnr_tpu_torch.synthetic import build_batch
    b = build_batch(512, 7500, 1)
    piv = np.concatenate([RaySampler(6, 2, 5.0, "reflect").pivots_dir.T,
                          RaySampler(6, 2, 10.0, "diffuse").pivots_dir.T])
    g = {k: torch.from_numpy(np.ascontiguousarray(b[k], np.float32)).to(dev)
         for k in ("TBN_map", "view_dir_map_tangent", "alpha_map")}
    rd = build_fan_channels(g["TBN_map"], g["view_dir_map_tangent"],
                            g["alpha_map"], torch.from_numpy(
                                piv.astype(np.float32)).to(dev),
                            13)[1].to(torch.bfloat16).contiguous()
    rng = np.random.default_rng(5)
    lt = torch.from_numpy(rng.uniform(0, 2, (1, 512, 512, 26, 3)).astype(
        np.float32)).to(dev, torch.bfloat16)
    cf = torch.from_numpy((0.3 * rng.standard_normal((121, 3))).astype(
        np.float32)).to(dev)
    gs, gd = (torch.from_numpy(rng.standard_normal((1, 512, 512, 3)).astype(
        np.float32)).to(dev) for _ in range(2))
    return rd, lt, g["alpha_map"], cf, gs, gd


# appended to a build of the order-split K5b: the blocks of its lmax-10
# bf16 kernel that fit on an SM at R 26
K5B_OCCUPANCY = """
extern "C" int rnr_sh_shade_bwd_blocks_per_sm() {
  int n = -1;
  const int smem = bwd_smem<StoredRays<__nv_bfloat16>>(10, 26, 2).total_bytes;
  set_smem((const void*)sh_shade_bwd_kernel<10, __nv_bfloat16>, smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, sh_shade_bwd_kernel<10, __nv_bfloat16>, FAN_BWD_THREADS, smem);
  return n;
}
"""
# per design of K5b in csrc/sh_shade.cu (told apart by a line only it
# has): {variant: switches}, written into the source with its headers
K5B_DESIGNS = {
    "order split of sh_bwd.cuh, rays staged": (
        "order_split_bwd<LMAX>(sm, StoredRays<RT>{",
        {"real": [],
         "walk_only": [
             ("  copy_rows(dlt + (size_t)p0 * row, rows, row_bytes, tid,",
              "  if (row_bytes == -7) copy_rows(dlt + (size_t)p0 * row, "
              "rows, row_bytes, tid,")],
         "no_staging": [
             ("""    copy_rows(dirs, rays_dir + (size_t)p0 * row, np * row * (int)sizeof(RT),
              threadIdx.x, FAN_BWD_THREADS);""", ""),
             ("    return {static_cast<const RT*>(dirs) + p * 3 * r_total, "
              "p < np};",
              "    return {rays_dir + ((size_t)blockIdx.x * FAN_BWD_PIXELS + "
              "p) * 3 * r_total, p < np};")],
         "one_warp_orders": [("    if (best == m) return w;",
                              "    if (best == m) return 0;")],
         "all_powers": [("    return lmax / 2 < 4 ? lmax / 2 : 4;",
                         "    return lmax / 2;")],
         "occupancy": [("// The backward: gs, gd [n_pix, 3] f32",
                        K5B_OCCUPANCY
                        + "// The backward: gs, gd [n_pix, 3] f32")]}),
    "unscaled ladder, one pixel a thread": (
        "sh_ladder<LMAX>(x, y, z, [&](int l, int m, float q, float cm, "
        "float sm) {",
        {"real": [],
         "walk_only": [
             ("        store_lt(dl + r * 3 + c, rad[c] * gsel);",
              "        if (rad[c] == 1.2345e-30f) "
              "store_lt(dl + r * 3 + c, rad[c] * gsel);")]}),
}


def time_k5b(dev, stream, csrc: str, only=None) -> None:
    """K5b at chip_smoke.py's kernels_shade case: queued device time per
    call of each variant of the design found in csrc, each entry called
    with its own design's arguments; the real build's sha256 of (d
    rays_lt, d coeff) as K5B_DIGEST takes it.  Its outputs are kept under
    build/, and when the other checkout's run left its own there (one
    call: this tree, then --csrc), the largest differences between the
    two designs' outputs are printed."""
    from rnr_tpu_torch.ops.sh_cuda import fan_coeff, fan_bwd_partials
    text = sh_source(csrc, "sh_shade")
    design, table = next((d, t) for d, (mk, t) in K5B_DESIGNS.items()
                         if mk in text)
    if only:
        table = {k: v for k, v in table.items() if k in only}
    tag = "" if csrc == str(_build.CSRC) else "_other"
    new = design.startswith("order split")
    print(f"K5b kernels of {csrc}: {design}", flush=True)
    libs = build_all("sh_shade", table, csrc, tag + "_k5b")
    for name in table:
        print_sass(os.path.join(OUT, f"sh_shade{tag}_k5b_{name}.so"),
                   f"K5b {name}", skip="sh_shade_kernel")
    rd, lt, al, cf, gs, gd = k5_inputs(dev)
    n_pix = 512 * 512
    dlt = torch.empty_like(lt)
    dcf = torch.empty_like(cf)
    part = torch.empty(fan_bwd_partials(n_pix, 10), device=dev)
    scale = torch.tensor(fan_basis_scale(10), device=dev)
    lad = torch.tensor(ladder_constants(10), device=dev)
    for name, lib in libs.items():
        if hasattr(lib, "rnr_sh_shade_bwd_blocks_per_sm"):
            q = lib.rnr_sh_shade_bwd_blocks_per_sm
            q.restype = ctypes.c_int
            print(f"K5b {name}: {q()} blocks an SM (cudaOccupancyMaxActive"
                  "BlocksPerMultiprocessor, R 26)", flush=True)
            continue
        f = entry(lib, "rnr_sh_shade_bwd", 10, 6)
        if new:
            ptrs = [t.data_ptr() for t in (rd, al, lt, fan_coeff(cf, 10),
                                           scale, gs, gd, dlt, part, dcf)]
            ints = (10, n_pix, 26, 13, 1, part.numel())
        else:
            ptrs = [t.data_ptr() for t in (rd, al, lt, cf, lad, gs, gd, dlt,
                                           part, dcf)]
            ints = (10, lad.numel(), n_pix, 26, 13, 1)
        us = device_us(lambda: f(*ptrs, *ints, stream))
        f(*ptrs, *ints, stream)
        torch.cuda.synchronize()
        dig = ""
        if name == "real":
            h = hashlib.sha256()
            for t in (dlt, dcf):
                h.update(t.contiguous().view(torch.uint8).cpu().numpy()
                         .tobytes())
            dig = f"; sha256 of (d rays_lt, d coeff) {h.hexdigest()}"
            torch.save((dlt.cpu(), dcf.cpu()),
                       os.path.join(OUT, f"k5b_out{tag}.pt"))
        print(f"K5b 512^2 lmax10 R26 bf16 {name}: {us:.2f} us per call{dig}",
              flush=True)
    other = os.path.join(OUT, f"k5b_out{'' if tag else '_other'}.pt")
    if "real" in libs and os.path.exists(other):
        ol, oc = torch.load(other)
        dc_err = float((dcf.cpu() - oc).abs().max())
        dl_err = float((dlt.cpu().float() - ol.float()).abs().max())
        print("K5b this design against the other checkout's, same inputs: "
              f"d coeff max abs diff {dc_err:.4g} (max |d coeff| "
              f"{float(oc.abs().max()):.4g}), d rays_lt max abs diff "
              f"{dl_err:.4g} (max |d rays_lt| "
              f"{float(ol.float().abs().max()):.4g})", flush=True)


# the block shapes (rows, columns, rows a warp) K7's design is timed in,
# each a build with csrc/rasterize_tiles.cu's BH, BW and WH set to it
K7_SHAPES = ((8, 32, 4), (16, 32, 4), (32, 32, 4), (16, 64, 4),
             (32, 64, 4), (8, 32, 2), (16, 32, 2), (32, 32, 2), (4, 32, 1),
             (8, 32, 1), (16, 32, 1))
_K7_SHAPE = ("constexpr int BH = 8;", "constexpr int BW = 32;",
             "constexpr int WH = 1;")


def _k7_shape(shape) -> list:
    return [(o, o.rsplit(" ", 1)[0] + f" {v};")
            for o, v in zip(_K7_SHAPE, shape)]


# per design of csrc/rasterize_tiles.cu (told apart by a line only it
# has): {variant: switches}
K7_DESIGNS = {
    "exact per-block and per-warp cull, survivors staged": (
        "!culled(block_rect,",
        dict({"real": [],
              "no_cull": [
                  ("""    const bool keep =
        id >= 0 && !culled(block_rect, fd[0], fd[1], fd[3], fd[4], fd[6],
                           fd[7]);""", "    const bool keep = id >= 0;"),
                  ("        hit = !culled(warp_rect, d[0], d[1], d[3], d[4], "
                   "d[6], d[7]);", "        hit = true;")],
              "no_warp_cull": [
                  ("        hit = !culled(warp_rect, d[0], d[1], d[3], d[4], "
                   "d[6], d[7]);", "        hit = true;")],
              "cull_only": [("      while (todo) {",
                             "      while (todo && n_keep < 0) {")]},
             **{"block_{}x{}_w{}".format(*b): _k7_shape(b)
                for b in K7_SHAPES})),
    "every block walks its tile's whole list": (
        "    for (int c = 0; c < m; ++c) {", {"real": []}),
}


def time_k7(dev, stream, csrc: str, only=None) -> None:
    """K7 at three of chip_smoke.py's kernels_raster cases at 512^2 (the
    G-buffer phase's sphere, the 48,768-face sphere at 0 degrees, the
    degenerate faces): queued device time per call of each variant of the
    design found in csrc, among them a build in each block shape of
    K7_SHAPES (block_HxW_wR: H x W pixels a block, R rows a warp), with
    what the cull leaves in each shape (chip_smoke.cull_counts) and a
    digest of each real or reshaped build's output."""
    import chip_smoke as cs
    from rnr_tpu_torch.ops.rasterize_cuda import bin_faces
    text = open(os.path.join(csrc, "rasterize_tiles.cu")).read()
    design, table = next(
        (d, t) for d, (mk, t) in K7_DESIGNS.items() if mk in text)
    if only:
        table = {k: v for k, v in table.items() if k in only}
    tag = "" if csrc == str(_build.CSRC) else "_other"
    print(f"K7 kernels of {csrc}: {design}", flush=True)
    libs = build_all("rasterize_tiles", table, csrc, tag)
    lat, lon = cs.MESH_LAT_LON
    cases = {"gbuffer": cs.ring_faces(lat, lon, 30.0, [0], 512),
             "dense0": cs.ring_faces(128, 192, 0.0, [0], 512),
             "degenerate": cs.degenerate_faces_512()}
    for cname, faces in cases.items():
        table_, ids, counts, _ = bin_faces(faces, 512, 32, 128, 2048)
        n, f = table_.shape[0], table_.shape[1]
        depth = torch.empty((n, 512, 512), device=dev)
        idx = torch.empty((n, 512, 512), dtype=torch.int32, device=dev)
        ptrs = [t.data_ptr() for t in (table_, ids, counts, depth, idx)]
        if "cull" in design:   # what the cull leaves in each shape
            for blk in K7_SHAPES:
                cull = cs.cull_counts(table_, ids, counts, 512, 32, 128, blk)
                print(f"K7 {cname} cull, block {blk}: {cull}", flush=True)
        for name, lib in libs.items():
            fn = entry(lib, "rnr_rasterize_tiles", 5, 7)
            fn.argtypes = fn.argtypes[:-1] + [ctypes.c_float] * 2 + [
                ctypes.c_void_p]
            ints = (n, f, ids.shape[1], ids.shape[2], 512, 32, 128)
            us = device_us(lambda: fn(*ptrs, *ints, 0.0, 1e5, stream))
            torch.cuda.synchronize()
            dig = (f"; digest {digest(idx)} {digest(depth)}"
                   if name == "real" or name.startswith("block_") else "")
            print(f"K7 512^2 {cname} {name}: {us:.2f} us per call{dig}",
                  flush=True)


def sh_variants(csrc: str):
    """(K1 variants, K1b variants) of the design found in csrc."""
    text = sh_source(csrc, "sh_fan")
    for design, (marker, k1, k1b, literals, parts) in SH_DESIGNS.items():
        if marker in text:
            parts = dict(parts, LITERALS=[
                (o, n.replace("LADDER_LIT", _literal_ladder()))
                for o, n in literals])

            def expand(v):   # a list of switches, or names of parts
                if isinstance(v, list):
                    return v
                return [sw for name in v.split("+") for sw in parts[name]]
            return (design, {k: expand(v) for k, v in k1.items()},
                    {k: expand(v) for k, v in k1b.items()})
    raise RuntimeError(f"{csrc}/sh_fan.cu: no known design")


def sh_source(csrc: str, src: str) -> str:
    """csrc/<src>.cu with the SH headers it includes (sh_bwd.cuh, then
    sh_common.cuh, once) written in, so that switches reach them."""
    text = open(os.path.join(csrc, f"{src}.cu")).read()
    for hdr in ("sh_bwd.cuh", "sh_common.cuh"):
        inc = f'#include "{hdr}"'
        if inc in text:
            body = open(os.path.join(csrc, hdr)).read()
            text = text.replace(inc, body, 1).replace(inc, "")
    return text


def build(src: str, name: str, switches, csrc: str = str(_build.CSRC),
          tag: str = "") -> ctypes.CDLL:
    text = sh_source(csrc, src)
    if src in ("sh_fan", "sh_shade"):
        switches = SH_COMMON + list(switches)
    common = os.path.join(csrc, "conv4x4_common.cuh")
    if '#include "conv4x4_common.cuh"' in text:   # its switches apply too
        text = text.replace('#include "conv4x4_common.cuh"',
                            open(common).read())
    for old, new in switches:
        if old not in text:
            raise RuntimeError(f"{src} {name}: switch not found: {old!r}")
        text = text.replace(old, new)
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, f"{src}{tag}_{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    so = path[:-3] + ".so"
    res = subprocess.run([_build._nvcc(), *_build._flags(src), "-I",
                          csrc, "-o", so, path],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {src} {name}:\n{res.stderr}")
    fn_name = ""
    for ln in res.stderr.splitlines():
        if "Compiling entry function" in ln:
            fn_name = ln.split("'")[1] if "'" in ln else ""
        elif "registers" in ln or "spill" in ln or "C7514" in ln \
                or "C7515" in ln or "C7520" in ln:
            print(f"[build] {src}{tag} {name} {fn_name}: {ln.strip()}",
                  flush=True)
    return ctypes.CDLL(so)


def sass_counts(so: str, match: str) -> dict:
    """Static SASS instructions of each kernel in `so` whose name holds
    `match`, by opcode (cuobjdump -sass), for the loop bodies' sizes."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", so], capture_output=True,
                         text=True).stdout
    counts: dict = {}
    cur = None
    for ln in out.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            cur = counts.setdefault(name, {}) if match in name else None
            continue
        mt = SASS_OP.search(ln)
        if cur is not None and mt:
            op = mt.group(2).split(".")[0]
            cur[op] = cur.get(op, 0) + 1
    return counts


def print_sass(so: str, tag: str, skip: str = "") -> None:
    for fn_name, ops in sass_counts(so, "nv_bfloat16").items():
        kern = "bwd" if "bwd" in fn_name else "fwd"
        if skip and skip in fn_name:
            continue
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:12]
        print(f"[sass] {tag} {kern}: {sum(ops.values())} instructions: "
              + ", ".join(f"{k} {v}" for k, v in top), flush=True)


def entry(lib, symbol: str, n_ptr: int, n_int: int):
    f = getattr(lib, symbol)
    f.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
        ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def device_us(call, n: int = 20) -> float:
    """Device time per call in us over n calls queued back to back."""
    for _ in range(3):
        if call() != 0:
            raise RuntimeError("launch failed")
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        call()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n * 1e3


def time_k4(dev, stream) -> None:
    v = 7500
    libs = build_all("stratified_knn", K4_VARIANTS)
    for c in (64, 512):
        x = torch.from_numpy(np.random.default_rng(c).standard_normal(
            (v, c)).astype(np.float32)).to(dev)
        out = torch.empty((v, -(-v // 16)), dtype=torch.int32, device=dev)
        work = torch.empty(knn_work_bytes(v, c), dtype=torch.uint8,
                           device=dev)
        for name, lib in libs.items():
            f = entry(lib, "rnr_stratified_knn", 3, 2)
            us = device_us(lambda: f(x.data_ptr(), out.data_ptr(),
                                     work.data_ptr(), v, c, stream))
            print(f"K4 V{v} C{c} {name}: {us:.2f} us per call "
                  f"({2 * v * v * c / us / 1e6:.1f} TFLOP/s)", flush=True)


def time_k2b(dev, stream) -> None:
    from rnr_tpu_torch.synthetic import build_batch
    libs = build_all("mipmap_scatter", K2B_VARIANTS)
    uv = torch.from_numpy(build_batch(512, 16, 1)["uv_map"]).to(dev)
    covered = (uv != 0).any(-1, keepdim=True)
    cases = {"G-buffer uv": uv,
             "object alone": torch.where(covered, uv, torch.full_like(
                 uv, -1.0)).contiguous(),
             "every pixel on the corner": torch.zeros_like(uv)}
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 512, 512, 24)).astype(np.float32)).to(dev)
    sizes = (512, 256, 128, 64)
    grads = [torch.zeros((s, s, 24), device=dev) for s in sizes]
    acc = torch.empty(sum(s * s for s in sizes) * 24, dtype=torch.int64,
                      device=dev)
    mbits = torch.empty(1, dtype=torch.int32, device=dev)
    for name, lib in libs.items():
        f = entry(lib, "rnr_mipmap_scatter", 8, 9)
        for tag, u in cases.items():
            us = device_us(lambda: f(*[t.data_ptr() for t in grads],
                                     acc.data_ptr(), mbits.data_ptr(),
                                     u.data_ptr(), g.data_ptr(), *sizes, 4,
                                     1, 512, 512, 24, stream))
            print(f"K2b 512^2 x 4 levels x 24, {tag}, {name}: {us:.2f} us "
                  "per call", flush=True)


def time_k2(dev, stream, csrc: str, only=None) -> None:
    """K2 on the synthetic G-buffer's uv at 512^2 (b1 and b2), the object
    alone (the uncovered pixels moved off the texture), every pixel on
    the corner texel, chip_smoke.py's seam and one view of its G-buffer
    phase's sphere, 4 levels x 24 channels: queued device time per call
    of each variant of the design found in csrc, each design's C entry
    called with its own arguments.  The variants that compute the
    function (all but no_store and taps_only) are held to the plain
    version; the real build prints a sha256 of each case's output and
    keeps the outputs under build/, and when the other checkout's run
    left its own there (one call: this tree, then --csrc), the largest
    difference between the two designs' outputs is printed."""
    from chip_smoke import seam_uv, sphere_view_uv
    from rnr_tpu_torch.ops.texture_cuda import mipmap_sample_torch
    from rnr_tpu_torch.synthetic import build_batch
    text = open(os.path.join(csrc, "mipmap_gather.cu")).read()
    design, table = next((d, t) for d, (mk, t) in K2_DESIGNS.items()
                         if mk in text)
    if only:
        table = {k: v for k, v in table.items() if k in only}
    tag = "" if csrc == str(_build.CSRC) else "_other"
    new = design.startswith("warp tiles")
    print(f"K2 kernels of {csrc}: {design}", flush=True)
    libs = build_all("mipmap_gather", table, csrc, tag + "_k2")
    for name in table:
        so = os.path.join(OUT, f"mipmap_gather{tag}_k2_{name}.so")
        for fn_name, ops in sass_counts(so, "mipmap_gather_kernel").items():
            top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
            print(f"[sass] K2 {name} {'vec4' if 'ILi4E' in fn_name else 'scalar'}"
                  f": {sum(ops.values())} instructions: "
                  + ", ".join(f"{k} {v}" for k, v in top), flush=True)
    sizes = (512, 256, 128, 64)
    rng = np.random.default_rng(15)
    texs = [torch.from_numpy((0.5 + 0.5 * rng.standard_normal(
        (s, s, 24))).astype(np.float32)).to(dev) for s in sizes]
    uv = torch.from_numpy(build_batch(512, 16, 1)["uv_map"]).to(dev)
    covered = (uv != 0).any(-1, keepdim=True)
    cases = {"G-buffer uv": uv,
             "G-buffer uv, b2": torch.from_numpy(
                 build_batch(512, 16, 2)["uv_map"]).to(dev),
             "object alone": torch.where(covered, uv, torch.full_like(
                 uv, -1.0)).contiguous(),
             "every pixel on the corner": torch.zeros_like(uv),
             "seam": seam_uv(uv),
             "a view of the sphere": sphere_view_uv()}
    outs = {}
    for name, lib in libs.items():
        if new:
            f = entry(lib, "rnr_mipmap_gather", 6, 10)
        else:
            f = entry(lib, "rnr_mipmap_gather", 6, 8)
        for case, u in cases.items():
            n = u.shape[0]
            out = torch.empty((n, 512, 512, 24), device=dev)
            ptrs = [t.data_ptr() for t in texs] + [u.data_ptr(),
                                                    out.data_ptr()]
            ints = ((*sizes, 4, n, 512, 512, 24, 0) if new
                    else (*sizes, 4, n * 512 * 512, 24, 0))
            us = device_us(lambda: f(*ptrs, *ints, stream))
            f(*ptrs, *ints, stream)
            torch.cuda.synchronize()
            extra = ""
            if name not in ("no_store", "taps_only"):
                ref = mipmap_sample_torch(texs, u)
                err = float((out - ref).abs().max())
                extra = f", max abs err {err:.3g} against the plain version"
                if not err <= 1e-5 * float(ref.abs().max()) + 1e-6:
                    raise AssertionError(f"K2 {name} {case}: err {err}")
            if name == "real":
                extra += f"; sha256 {digest(out)}"
                outs[case] = out.cpu()
            print(f"K2 512^2 x 4 levels x 24, {case}, {name}: {us:.2f} us "
                  f"per call{extra}", flush=True)
    if outs:
        torch.save(outs, os.path.join(OUT, f"k2_out{tag}.pt"))
    other = os.path.join(OUT, f"k2_out{'' if tag else '_other'}.pt")
    if outs and os.path.exists(other):
        for case, o in torch.load(other).items():
            d = (outs[case] - o).abs().max()
            print(f"K2 {case}: this design against the other checkout's, "
                  f"max abs diff {float(d):.4g}, bit-equal "
                  f"{torch.equal(outs[case], o)}", flush=True)


def sh_inputs(dev, batch: int) -> tuple:
    """The kernels phase's K1 / K1b operands at 512^2 and `batch`: the
    synthetic G-buffer, 13 + 13 pivots, bf16 rays_lt, coeff of lmax 10,
    the ladder table, two output gradients."""
    from rnr_tpu_torch.models.rays import RaySampler
    from rnr_tpu_torch.synthetic import build_batch
    b = build_batch(512, 16, batch)
    rng = np.random.default_rng(batch)
    piv = np.concatenate([RaySampler(6, 2, 5.0, "reflect").pivots_dir.T,
                          RaySampler(6, 2, 10.0, "diffuse").pivots_dir.T])
    t = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
         for a in (b["TBN_map"], b["view_dir_map_tangent"], b["alpha_map"],
                   rng.uniform(0, 2, (batch, 512, 512, 26, 3)),
                   0.3 * rng.standard_normal((121, 3)), piv,
                   ladder_constants(10),
                   rng.standard_normal((batch, 512, 512, 3)),
                   rng.standard_normal((batch, 512, 512, 3)))]
    t[3] = t[3].to(torch.bfloat16)
    return tuple(t)


def time_sh(dev, stream, csrc: str, which, only=None) -> None:
    design, k1, k1b = sh_variants(csrc)
    if only:
        k1 = {k: v for k, v in k1.items() if k in only}
        k1b = {k: v for k, v in k1b.items() if k in only}
    tag = "" if csrc == str(_build.CSRC) else "_other"
    print(f"SH kernels of {csrc}: {design}", flush=True)
    for kname, table in (("K1", k1), ("K1b", k1b)):
        if kname not in which:
            continue
        libs = build_all("sh_fan", table, csrc, tag)
        for name in table:
            print_sass(os.path.join(OUT, f"sh_fan{tag}_{name}.so"),
                       f"{kname} {name}")
        for batch in ((1,) if kname == "K1" else (1, 2)):
            tb, vd, al, lt, cf, pv, lad, gs, gd = sh_inputs(dev, batch)
            n_pix = batch * 512 * 512
            spec = torch.empty((n_pix, 3), device=dev)
            diff = torch.empty_like(spec)
            dlt = torch.empty_like(lt)
            dcf = torch.empty_like(cf)
            # scratch for any backward block of 32 pixels or more
            part = torch.empty((-(-n_pix // 32), cf.numel()), device=dev)
            old = design.startswith("thread per pixel")
            scale = torch.tensor(fan_basis_scale(10), device=dev)
            cfs = cf * scale[:, None]
            for name, lib in libs.items():
                if hasattr(lib, "rnr_sh_fan_blocks_per_sm"):
                    q = lib.rnr_sh_fan_blocks_per_sm
                    q.argtypes, q.restype = [ctypes.c_int] * 2, ctypes.c_int
                    print(f"{kname} {name}: {q(int(kname == 'K1b'), 26)} "
                          "blocks an SM (cudaOccupancyMaxActiveBlocks"
                          "PerMultiprocessor, R 26)", flush=True)
                    continue
                if kname == "K1" and old:
                    f = entry(lib, "rnr_sh_shade_fan", 9, 6)
                    args = (tb, vd, al, lt, cf, pv, lad, spec, diff)
                    ints = (10, lad.numel(), n_pix, 26, 13, 1)
                elif kname == "K1":
                    f = entry(lib, "rnr_sh_shade_fan", 8, 5)
                    args = (tb, vd, al, lt, cfs, pv, spec, diff)
                    ints = (10, n_pix, 26, 13, 1)
                elif old:
                    f = entry(lib, "rnr_sh_shade_fan_bwd", 12, 6)
                    args = (tb, vd, al, lt, cf, pv, lad, gs, gd, dlt, part,
                            dcf)
                    ints = (10, lad.numel(), n_pix, 26, 13, 1)
                else:
                    f = entry(lib, "rnr_sh_shade_fan_bwd", 12, 6)
                    args = (tb, vd, al, lt, cfs, pv, scale, gs, gd, dlt,
                            part, dcf)
                    ints = (10, n_pix, 26, 13, 1, part.numel())
                ptrs = [a.data_ptr() for a in args]
                us = device_us(lambda: f(*ptrs, *ints, stream))
                print(f"{kname} b{batch} 512^2 lmax10 R26 bf16 {name}: "
                      f"{us:.2f} us per call", flush=True)
            del tb, vd, al, lt, gs, gd, dlt, part


def build_all(src: str, table: dict, csrc: str = str(_build.CSRC),
              tag: str = "") -> dict:
    """Every variant of one source, one nvcc each, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=len(table)) as pool:
        futs = {name: pool.submit(build, src, name, sw, csrc, tag)
                for name, sw in table.items()}
        return {name: f.result() for name, f in futs.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels",
                    default="K4,K2,K2b,K1,K1b,K5,K5b,K6,K7,K8,K8s,P1",
                    help="comma-separated subset of K4,K2,K2b,K1,K1b,K5,K5b,"
                    "K6,K7,K8,K8s,P1 (K6: K6a and K6b; K8: K8c and K8d; K8s: "
                    "K8a and K8b)")
    ap.add_argument("--csrc", default=str(_build.CSRC),
                    help="the csrc directory whose K2, SH, K6, K7, K8, K8s "
                    "and P1 kernels are timed")
    ap.add_argument("--variants", default="",
                    help="comma-separated K2, SH, K6, K7, K8, K8s or P1 "
                    "variants to time (default all)")
    args = ap.parse_args()
    which = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("chip_variants: needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    if "K4" in which:
        time_k4(dev, stream)
    if "K2b" in which:
        time_k2b(dev, stream)
    if "K2" in which:
        time_k2(dev, stream, os.path.abspath(args.csrc),
                set(filter(None, args.variants.split(","))))
    if which & {"K1", "K1b"}:
        time_sh(dev, stream, os.path.abspath(args.csrc), which,
                set(filter(None, args.variants.split(","))))
    for pair in ("K6", "K8"):
        if pair in which:
            time_conv4(dev, stream, os.path.abspath(args.csrc), pair,
                       set(filter(None, args.variants.split(","))))
    if "K8s" in which:
        time_k8s(dev, stream, os.path.abspath(args.csrc),
                 set(filter(None, args.variants.split(","))))
    if "K5" in which:
        time_k5(dev, stream, os.path.abspath(args.csrc),
                set(filter(None, args.variants.split(","))))
    if "K5b" in which:
        time_k5b(dev, stream, os.path.abspath(args.csrc),
                 set(filter(None, args.variants.split(","))))
    if "K7" in which:
        time_k7(dev, stream, os.path.abspath(args.csrc),
                set(filter(None, args.variants.split(","))))
    if "P1" in which:
        time_p1(dev, stream, os.path.abspath(args.csrc),
                set(filter(None, args.variants.split(","))))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)


if __name__ == "__main__":
    main()
