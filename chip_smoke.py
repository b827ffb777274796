"""Drive the PyTorch + CUDA port on one NVIDIA GPU: the serving path, the
training step, inference from a mesh (G-buffer, then the frame),
relighting under novel light probes, and the U-Net's conv routes
"pallas" (K6), "p3s4" (K8's 4x4 pair), "slab3" (K8's 3x3 slab conv, K8a
and K8b) and "slab" (the 3x3 slab conv and K8's 4x4 pair).

    python3 chip_smoke.py            # every phase (one H100, a few minutes)
    python3 chip_smoke.py --phases device,build,kernels
    python3 chip_smoke.py --phases device,build,train
    python3 chip_smoke.py --phases device,build,kernels,slice,gbuffer
    python3 chip_smoke.py --phases device,build,kernels,slice,relight
    python3 chip_smoke.py --phases device,build,kernels,slice,train

Phases (each failure raises, so the script exits non-zero):
  device   CUDA present, capability (9, 0), the card's name and power limit.
  build    nvcc builds the thirteen sources of rnr_tpu_torch/csrc/ (the
           seventeen kernels), one nvcc per source, all started together.
  kernels  each kernel against its plain PyTorch version on the card, at
           the shapes of the canonical 512^2 step, with the stated
           tolerance; the median time of the kernel, of its plain version
           and, where one PyTorch call computes the same function, of that
           call; and the bound: the least time the card could take for the
           work.  K1 and K1b must also give, bit for bit, the outputs
           pinned in K1_DIGESTS, so that a change to their order of sums
           shows, and K5b the output pinned in K5B_DIGEST; K1b also runs
           at batch 2, and K1, K1b, K5 and K5b report queued and host
           times and f32 T-ops/s beside the median.  K1, K1b, K5, K5b,
           K3b and P1 run twice and must agree bit for bit; K2 must give
           the output pinned in K2_DIGEST (the first design's, bit for
           bit) and also runs at batch 2, with every pixel on the corner
           texel, with a uv seam inside its pixel tiles and on a view of
           the G-buffer phase's sphere, each twice bit-equal, with
           queued, host and C-entry times and a bound from the texels its
           taps touch (the every-texel figure beside it), the wrapper's
           host time with and without the autograd Function, four
           F.grid_sample calls timed beside it as a yardstick; K2b (f32
           atomics) reports its run-to-run difference and also runs at
           batch 2, with every pixel on the corner texel and
           with a uv seam inside its pixel tiles.  K4 runs at V 7500 and C
           64, 3, 130 and 512: its picks equal the plain version's except
           at near-ties, where the two picks' scores in double lie within
           the sum of their f32 rounding bounds (knn_cuda.compare_picks,
           the counts of exact and near ties printed), two runs bit-equal,
           and with duplicated vertices every pick is the lower of its
           pair.  K7 (the
           rasterizer) must equal its plain version bit for bit on UV
           spheres seen from the camera ring at 512^2 (the G-buffer
           phase's mesh; 48,768 faces at 0 and, overflowing the default
           cap, 45 degrees; 12,096 faces at N = 2), on a 32^2 overflow
           case and on faces at the edge of its cull's exactness
           (synthetic.degenerate_faces at 512^2), its binning on the card
           equal to the CPU's; each case with single, queued and host
           times and what its cull leaves (cull_counts).
           The 4x4 pair (K6 down4 / convt4, K8 down4s / convt4s) runs at the ten
           4x4 convs of a frame and as each other's f32 data gradient,
           then at odd C and O and an odd H; beside them the pallas3
           route's own cuDNN 4x4 convs are timed.  K8's pair is also
           timed queued (beside cuDNN queued), with its wrapper's host
           time and TFLOP/s per shape, and must be bit-equal over two
           runs at one large and one split-K shape of each.  The 3x3 slab pair (K8a
           forward and f32 data gradient, K8b weight gradient) runs on K3's
           inputs at the 14 3x3 convs of a frame, K8a's forward within a
           rounding step of K3's, K8b twice and bit-equal, also timed
           queued (beside cuDNN queued) with the wrappers' host time and
           TFLOP/s per shape, then at odd C and O and an odd H under both
           pad modes; K8a's forward (bf16, f32) and dgrad (both pads) must
           be bit-equal over two runs at one 512^2 and one 32^2 shape.
           P1 (the GEMM chain of
           tools/tpu_probe_r5.py) runs at the probe's section A shapes,
           each launch counted, with cuBLAS's one product of the same
           function beside it, single and queued, with its wrapper's host
           time and TFLOP/s per shape.
  slice    the canonical model (512^2, texture 512^2 x 24, lmax 10, 13+13
           rays, U-Net nf0 64 / 5 downs / dense fusion, GCN 20 blocks k=16
           on 7500 vertices; bf16 rays, fan-fused K1, K3 for every 3x3)
           with seeded weights: v_feature once, then eval frames.  Checks
           the image and the launch count of every kernel, then times the
           GCN and the eval frames/s; a torch.profiler pass prints device
           time by kernel.  Then the same model and v_feature under the
           conv routes "pallas", "p3s4", "slab3" and "slab": launches per
           frame (K3 14, or K8a 14 and K3 0 under the slab routes; the
           route's down and transpose kernel 5 each), a finite image near
           the shipped route's, frames/s, frame ms and a profile.
  gbuffer  inference from a mesh with the slice's model and v_feature:
           the 27,360-face UV sphere seen from 20 views of a ring (30
           degrees up, 2.5 away) -> render_gbuffer (K7) -> _to_batch ->
           eval frame, per view.  Checks overflow 0, coverage, finite maps
           and image, and the launches per view (K7 1, K3 14, K1 and K2 at
           least 1); reports views/s, G-buffer and raster ms, the largest
           tile candidate count, a profile; then the 12,096-face sphere's
           G-buffer at 128^2 on the card against the CPU's.
  relight  relighting from a mesh with the slice's model and v_feature:
           two procedural 256 x 512 probes, the 20 views of the gbuffer
           phase, and per view and probe one frame through each route of
           rnr_tpu's test_rnr: the SH route (LightingLP.fit_sh
           coefficients, fan-fused K1), the probe route (ray fans with
           probe UVs, the probe gather) and the unfused SH route (K5 on the
           materialised rays_dir) with both fan constructions, each with
           the probe composited behind the object.  Checks finite images
           and the launches per frame (SH: K1 once; probe: neither K1 nor
           K5; unfused: K5 once, K1 never); reports per route the frame ms
           (CUDA events) and frames/s (host clock), and the fit_sh ms;
           then one 128^2 frame per route on the card against the CPU.
  parity   the same model at 128^2 on the card (kernels) and on the CPU
           (plain versions) from the same v_feature, under the shipped
           route and the conv routes "pallas", "p3s4", "slab3" and "slab";
           images compared.
  train    the canonical training step (the slice's model, dropout 0.1,
           stochastic GCN with epsilon 0.2, Adam lr 1e-3) at batch 1, then
           batch 2: two warm-up steps, one step whose launch counts,
           losses, gradients, parameter moves and SNDense vectors are
           checked, then timed steps (frames/s on the host clock, step ms
           by CUDA events, peak memory) and a torch.profiler pass.  Then
           the same at batch 1 in the two relighting configurations:
           unfused SH shading (K5 and K5b once per step) and the probe
           path (direct_sh_shading=False: the learned lighting as a 64 x
           128 probe, gathered per ray), whose probe gather and scatter
           are also timed and profiled on their own; and under the conv
           routes "pallas" (down4 10, convt4 5 per step), "p3s4" (down4s
           10, convt4s 5), "slab3" (K8a 28, K8b 14, K3 and K3b 0) and
           "slab" (as slab3, and down4s 10, convt4s 5).  Last, one counted
           step of each conv route under zero padding at 256^2, where the
           down convs' data gradient is K6's convt4 under every route with
           a 4x4 kernel.
  train_parity  one training step (loss and every gradient) of the
           canonical model at 128^2 and 1024 vertices on the card and on
           the CPU, same weights, dropout and the stochastic GCN off.
The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and the one before that the per-kernel JSON
record.  Nothing is printed as a result without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from rnr_tpu_torch.ops import _build  # noqa: E402
from rnr_tpu_torch.ops.backend import check_launch  # noqa: E402
from rnr_tpu_torch.ops.conv4_cuda import (convt4, convt4_fwd,  # noqa: E402
                                          convt4_torch, convt4s, convt4s_fwd,
                                          down4, down4_fwd, down4_torch,
                                          down4s, down4s_fwd)
from rnr_tpu_torch.ops.conv_cuda import (conv3x3, conv3x3_dgrad,  # noqa: E402
                                         conv3x3_dgrad_torch, conv3x3_fwd,
                                         conv3x3_torch,
                                         conv3x3_wgrad, conv3x3_wgrad_torch,
                                         conv3x3s, conv3x3s_dgrad,
                                         conv3x3s_dgrad_torch, conv3x3s_fwd,
                                         conv3x3s_torch, conv3x3s_wgrad,
                                         conv3x3s_wgrad_torch)
from rnr_tpu_torch.ops.gemm_chain_cuda import (gemm_chain,  # noqa: E402
                                               gemm_chain_torch)
from rnr_tpu_torch.ops.interpolate import bilinear_taps  # noqa: E402
from rnr_tpu_torch.ops.knn_cuda import (compare_picks,  # noqa: E402
                                        stratified_knn, stratified_knn_torch)
from rnr_tpu_torch.ops.rasterize_cuda import (BLOCK,  # noqa: E402
                                              FACE_FLOATS, WARP_W,
                                              bin_faces, cull_keep,
                                              rasterize_tiles,
                                              rasterize_tiles_torch,
                                              tile_pixels)
from rnr_tpu_torch.ops.sh_cuda import (sh_shade, sh_shade_bwd,  # noqa: E402
                                       sh_shade_bwd_torch, sh_shade_fan,
                                       sh_shade_fan_bwd,
                                       sh_shade_fan_bwd_torch,
                                       sh_shade_fan_torch, sh_shade_torch)
from rnr_tpu_torch.ops.texture_cuda import (MipmapSampleFn,  # noqa: E402
                                            level_coords,
                                            mipmap_sample,
                                            mipmap_sample_torch,
                                            mipmap_scatter,
                                            mipmap_scatter_torch,
                                            touched_texels)

KERNELS = {
    "sh_shade_fan": dict(
        wrapper=sh_shade_fan, source="rnr_tpu_torch/csrc/sh_fan.cu",
        replaces="rnr_tpu/ops/sh_pallas.py:587"),
    "sh_shade_fan_bwd": dict(
        wrapper=sh_shade_fan_bwd, source="rnr_tpu_torch/csrc/sh_fan.cu",
        replaces="rnr_tpu/ops/sh_pallas.py:632"),
    "mipmap_gather": dict(
        wrapper=mipmap_sample, source="rnr_tpu_torch/csrc/mipmap_gather.cu",
        replaces="rnr_tpu/ops/texture_pallas.py:372"),
    "mipmap_scatter": dict(
        wrapper=mipmap_scatter,
        source="rnr_tpu_torch/csrc/mipmap_scatter.cu",
        replaces="rnr_tpu/ops/texture_pallas.py:183"),
    # the forward and, with an f32 output, the data gradient
    "conv3x3": dict(
        wrapper=conv3x3, source="rnr_tpu_torch/csrc/conv3x3.cu",
        replaces="rnr_tpu/ops/conv_pallas.py:192"),
    "conv3x3_wgrad": dict(
        wrapper=conv3x3_wgrad, source="rnr_tpu_torch/csrc/conv3x3_wgrad.cu",
        replaces="rnr_tpu/ops/conv_pallas.py:308"),
    "stratified_knn": dict(
        wrapper=stratified_knn, source="rnr_tpu_torch/csrc/stratified_knn.cu",
        replaces="rnr_tpu/ops/knn_pallas.py:81"),
    "rasterize_tiles": dict(
        wrapper=rasterize_tiles,
        source="rnr_tpu_torch/csrc/rasterize_tiles.cu",
        replaces="rnr_tpu/ops/rasterize_pallas.py:174", path="gbuffer"),
    "sh_shade": dict(
        wrapper=sh_shade, source="rnr_tpu_torch/csrc/sh_shade.cu",
        replaces="rnr_tpu/ops/sh_pallas.py:234", path="relight"),
    "sh_shade_bwd": dict(
        wrapper=sh_shade_bwd, source="rnr_tpu_torch/csrc/sh_shade.cu",
        replaces="rnr_tpu/ops/sh_pallas.py:276", path="train_unfused"),
    # the 4x4 pair: K6 under conv_backend "pallas", K8's under "p3s4"; the
    # down convs also with an f32 output, as the transpose convs' dgrad
    "down4": dict(
        wrapper=down4, source="rnr_tpu_torch/csrc/conv4x4.cu",
        replaces="rnr_tpu/ops/conv_pallas.py:532", path="train_pallas"),
    "convt4": dict(
        wrapper=convt4, source="rnr_tpu_torch/csrc/conv4x4.cu",
        replaces="rnr_tpu/ops/conv_pallas.py:664", path="train_pallas"),
    "down4s": dict(
        wrapper=down4s, source="rnr_tpu_torch/csrc/conv4x4_slab.cu",
        replaces="rnr_tpu/ops/conv_pallas.py:1138", path="train_p3s4"),
    "convt4s": dict(
        wrapper=convt4s, source="rnr_tpu_torch/csrc/conv4x4_slab.cu",
        replaces="rnr_tpu/ops/conv_pallas.py:1276", path="train_p3s4"),
    # the 3x3 slab pair under "slab3" and "slab": the forward and, with an
    # f32 output, the data gradient; the weight gradient
    "conv3x3s": dict(
        wrapper=conv3x3s, source="rnr_tpu_torch/csrc/conv3x3_slab.cu",
        replaces="rnr_tpu/ops/conv_pallas.py:917", path="train_slab3"),
    "conv3x3s_wgrad": dict(
        wrapper=conv3x3s_wgrad,
        source="rnr_tpu_torch/csrc/conv3x3_slab_wgrad.cu",
        replaces="rnr_tpu/ops/conv_pallas.py:982", path="train_slab3"),
    # on no path of the package: launched by the kernels phase
    "gemm_chain": dict(
        wrapper=gemm_chain, source="rnr_tpu_torch/csrc/gemm_chain.cu",
        replaces="tools/tpu_probe_r5.py:81", path="kernels"),
}
SOURCES = ("sh_fan", "sh_shade", "mipmap_gather", "mipmap_scatter", "conv3x3",
           "conv3x3_wgrad", "stratified_knn", "rasterize_tiles", "conv4x4",
           "conv4x4_slab", "conv3x3_slab", "conv3x3_slab_wgrad", "gemm_chain")

# launches of each kernel in one canonical training step, and in one step
# of each variant: the relighting configurations (rays overrides of the
# config) and the U-Net's conv backends (render_net overrides).  Under
# reflect padding rnr_tpu's VJPs take the down convs' data gradient from
# XLA and the transpose convs' from the down kernel, f32 out.
TRAIN_LAUNCHES = {"stratified_knn": 17, "conv3x3": 28, "conv3x3_wgrad": 14,
                  "sh_shade_fan": 1, "sh_shade_fan_bwd": 1, "sh_shade": 0,
                  "sh_shade_bwd": 0, "down4": 0, "convt4": 0, "down4s": 0,
                  "convt4s": 0, "conv3x3s": 0, "conv3x3s_wgrad": 0}
# the slab routes' 3x3 convs: K8a forward and dgrad, K8b, and no K3
SLAB_STEP = dict(TRAIN_LAUNCHES, conv3x3=0, conv3x3_wgrad=0, conv3x3s=28,
                 conv3x3s_wgrad=14)
TRAIN_VARIANTS = {
    "unfused": (dict(rays=dict(sh_fan_fuse=False)),
                dict(TRAIN_LAUNCHES, sh_shade_fan=0, sh_shade_fan_bwd=0,
                     sh_shade=1, sh_shade_bwd=1)),
    "probe": (dict(rays=dict(direct_sh_shading=False)),
              dict(TRAIN_LAUNCHES, sh_shade_fan=0, sh_shade_fan_bwd=0)),
    "pallas": (dict(render_net=dict(conv_backend="pallas")),
               dict(TRAIN_LAUNCHES, down4=10, convt4=5)),
    "p3s4": (dict(render_net=dict(conv_backend="p3s4")),
             dict(TRAIN_LAUNCHES, down4s=10, convt4s=5)),
    "slab3": (dict(render_net=dict(conv_backend="slab3")), SLAB_STEP),
    "slab": (dict(render_net=dict(conv_backend="slab")),
             dict(SLAB_STEP, down4s=10, convt4s=5)),
}
# the probe step takes seconds on the card (its backward's scatter into
# the probe), so it is warmed by its counted step and timed over 1 step
TIMED_STEPS = {"unfused": 5, "probe": 1, "pallas": 5, "p3s4": 5, "slab3": 5,
               "slab": 5}
# the conv routes' steps under zero ("same") padding, at SAME_IMG^2: the
# down convs' data gradient is then K6's convt4 (f32 out) in every route
# with a 4x4 kernel
SAME_IMG = 256
SAME_LAUNCHES = {
    "pallas": dict(TRAIN_LAUNCHES, down4=10, convt4=10),
    "p3s4": dict(TRAIN_LAUNCHES, down4s=10, convt4s=5, convt4=5),
    "slab3": SLAB_STEP,
    "slab": dict(SLAB_STEP, down4s=10, convt4s=5, convt4=5),
}
# launches per eval frame of the conv routes (cached v_feature)
ROUTE_FRAME_LAUNCHES = {
    "pallas": {"conv3x3": 14, "conv3x3s": 0, "down4": 5, "convt4": 5,
               "down4s": 0, "convt4s": 0},
    "p3s4": {"conv3x3": 14, "conv3x3s": 0, "down4": 0, "convt4": 0,
             "down4s": 5, "convt4s": 5},
    "slab3": {"conv3x3": 0, "conv3x3s": 14, "down4": 0, "convt4": 0,
              "down4s": 0, "convt4s": 0},
    "slab": {"conv3x3": 0, "conv3x3s": 14, "down4": 0, "convt4": 0,
             "down4s": 5, "convt4s": 5},
}
AT_LEAST_ONE = ("mipmap_gather", "mipmap_scatter")

# K1 and K1b at the kernels phase's inputs, sha256 of their outputs' bytes
# (spec, diff; d rays_lt, d coeff) from csrc/sh_fan.cu's scaled ladder with
# the orders split between warps (nvcc 12.9, NVIDIA H100 80GB HBM3): a
# refactor that keeps the arithmetic keeps them
K1_DIGESTS = {
    "sh_shade_fan":
        "b7a5a1eea63605cbc8eab9a9e71b4cc624248d94e522443b4b12df4cd11864d7",
    "sh_shade_fan_bwd":
        "3cdb0e69cad0b27d8dbd2bb4e1509f0a411442c8b6a9ca0795a62648531f1e5d",
}

# K5b at kernels_shade's inputs, sha256 of its outputs' bytes (d rays_lt,
# d coeff) from the order-split backward of csrc/sh_bwd.cuh on the scaled
# ladder (nvcc 12.9, NVIDIA H100 80GB HBM3; the same as `chip_variants.py
# --kernels K5b` prints for a checkout's K5b), so that a change to the
# shared backward, constant bank or header that moves K5b shows
K5B_DIGEST = (
    "d1aeec12f303a4172529a5050f1090754f3d69eb2bcfcb7bfa0484e1d79d91a5")

# K2 at kernels_texture's G-buffer case, sha256 of its output's bytes
# (csrc/mipmap_gather.cu, NVIDIA H100 80GB HBM3; the first design's output
# bit for bit: each level's taps as FMAs in tap order, then the levels'
# sums in level order), so that a change to K2's order of sums shows
K2_DIGEST = (
    "e6c70f0caf333a71a140c559faa8a7c5732e280c1a47ee1deb64061e15f8b614")

# the relighting routes of rnr_tpu's test_rnr: (model variant, SH fit,
# launches per frame); the variant's rays overrides of the config
RELIGHT_ROUTES = {
    "sh": ({}, True, {"sh_shade_fan": 1, "sh_shade": 0}),
    "probe": ({}, False, {"sh_shade_fan": 0, "sh_shade": 0}),
    "unfused": (dict(sh_fan_fuse=False), True,
                {"sh_shade_fan": 0, "sh_shade": 1}),
    "unfused_einsum": (dict(sh_fan_fuse=False, fan_impl="einsum"), True,
                       {"sh_shade_fan": 0, "sh_shade": 1}),
}
N_PROBES = 2

# (C, O, H) of the 14 3x3 convs of one canonical 512^2 frame, in order
CONV_SHAPES = [(108, 64, 512), (64, 64, 512), (128, 640, 256),
               (640, 128, 256), (128, 128, 256), (256, 256, 128),
               (512, 512, 64), (512, 512, 32), (512, 512, 32),
               (512, 512, 64), (256, 256, 128), (128, 128, 256),
               (64, 64, 512), (128, 78, 512)]
TEX_SIZES = (512, 256, 128, 64)
# (C, O, H) of the 4x4 stride-2 down convs and of the 4x4 transpose convs
# of one canonical 512^2 frame (input channels, output channels, input
# side), in order; and the extra shapes of the kernels phase: odd C and O,
# odd H
DOWN4_SHAPES = [(64, 128, 512), (128, 256, 256), (256, 512, 128),
                (512, 512, 64), (512, 512, 32)]
CONVT4_SHAPES = [(512, 512, 16), (1024, 512, 32), (1024, 256, 64),
                 (512, 128, 128), (256, 64, 256)]
CONV4_ODD = [(45, 77, 64), (64, 64, 63)]

# launches of each kernel per view of the G-buffer path (G-buffer + frame)
VIEW_LAUNCHES = {"rasterize_tiles": 1, "conv3x3": 14}
VIEW_AT_LEAST_ONE = ("sh_shade_fan", "mipmap_gather")
N_VIEWS = 20
# the mesh of the G-buffer path: the UV sphere of tools/tpu_smoke.py at
# 96 x 144 (27,360 faces), the densest whose pole fans stay under the
# rasterizer's default cap of 2048 candidates per tile on the ring
MESH_LAT_LON = (96, 144)

# The least f32 work of the rasterizer's z-buffer (csrc/rasterize_tiles.cu)
# with rnr_tpu's rounding kept.  A (pixel, candidate) pair where the
# candidate passes the inside test can win the pixel, so no exact cull
# drops it: its edge tests, 1 comparison per edge once each side is
# known, are the least work per such pair.  The weights and the depth
# matter at least once per covered pixel: 3 clamped weights (2 products,
# 2 sums, 2 comparisons each), their sum and its guard (3), 1/zp (3
# quotients, 2 sums, 1 quotient, 1 guard, 1 quotient), 3 depth
# comparisons.  The bound of the design before the cull charged the
# comparisons to every (pixel, listed candidate) pair, and each listed
# candidate its sides per row and column (2 operations per row or column
# and edge) and its differences (2 per edge); with the cull that count is
# no floor, and it is kept beside the bound as listed_pairs_bound_ms.
RASTER_PIXEL_OPS = 3
RASTER_LINE_OPS = 6
RASTER_CAND_OPS = 6
RASTER_COVERED_OPS = 32

# Published peaks of one H100 SXM (dense, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12
# the same pipes issuing one operation per lane and clock: the rate of the
# adds, products and comparisons that are not fused multiply-adds
F32_OPS = F32_FLOPS / 2

# the GCN forward of the slice phase when K4 was a register-tiled SGEMM
# on the FMA pipes, measured by this script on an NVIDIA H100 80GB HBM3 at
# 700 W: the yardstick of K4's tensor-core design
GCN_MS_FMA_K4 = 26.826

DEV = torch.device("cuda", 0)
IMG = 512       # the canonical frame's side
GCN_V = 7500    # the canonical mesh's vertex count


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median device time of fn() in ms, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def queued_ms(fn, calls: int = 20) -> float:
    """Device time per call of fn() in ms over `calls` calls queued back to
    back between two CUDA events: where the host enqueues faster than the
    card runs, the kernels' own time, without the host's time per call."""
    for _ in range(2):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def host_us(fn, calls: int = 50) -> float:
    """Host time per call of fn() in microseconds (enqueue only), the card
    drained before and after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def check(name: str, err: float, tol: float) -> None:
    if not err <= tol:   # also catches NaN
        raise AssertionError(f"{name}: max abs err {err:.4g} > tol {tol:.4g}")


def bound(nbytes: float, flops: float, peak: float) -> dict:
    """The least time of the card for the work: the larger of the bytes
    over the memory rate and the operations over the unit's peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def reset_launches() -> None:
    for spec in KERNELS.values():
        spec["wrapper"].launches = 0


def read_launches() -> dict:
    return {n: s["wrapper"].launches for n, s in KERNELS.items()}


# ------------------------------------------------------- work of each kernel
#
# Bytes: each input read once and each output written once.  Operations of
# the SH ladder, per ray: about 50 for the fan ray (reflection, the TBN
# product, two normalisations; K1 and K1b only, K5 reads the rays), then
# per basis value at least 3 for the recurrence and 6 for the radiance (3
# FMAs); the backward recomputes both and adds 6 per value for d coeff (3
# FMAs).  They run on the f32 pipes.


def sh_work(n_pix: int, r: int, lmax: int, lt_item: int, bwd: bool,
            fan: bool = True):
    """K1 / K1b (fan: TBN, view dir, alpha and the pivots in) or K5 / K5b
    (rays_dir [3, R] per pixel in rays_lt's type, and alpha)."""
    nb = (lmax + 1) ** 2
    geo = (9 * 4 + 3 * 4 + 4 if fan else 3 * r * lt_item + 4)
    piv = r * 12 if fan else 0
    fan_ops = 50 if fan else 0
    lt = r * 3 * lt_item
    if bwd:   # + gs, gd in; d rays_lt, d coeff out
        nbytes = n_pix * (geo + lt + 6 * 4 + lt) + 2 * nb * 3 * 4 + piv
        flops = n_pix * r * (fan_ops + 15 * nb + 12)
    else:     # spec, diff out
        nbytes = n_pix * (geo + lt + 6 * 4) + nb * 3 * 4 + piv
        flops = n_pix * r * (fan_ops + 9 * nb + 6)
    return bound(nbytes, flops, F32_FLOPS)


def digest(*ts: torch.Tensor) -> str:
    """sha256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def check_digest(name: str, got: str) -> None:
    if got != K1_DIGESTS[name]:
        raise AssertionError(f"{name}: output digest {got} differs from "
                             f"{K1_DIGESTS[name]}, the pinned one")


def texture_work(n_pix: int, ch: int, sizes, taps: int):
    """Gather and scatter alike: uv and the per-pixel values [ch] on one
    side, every level once on the other; 2 ops per channel per tap."""
    nbytes = n_pix * (2 * 4 + ch * 4) + sum(s * s * ch * 4 for s in sizes)
    return bound(nbytes, taps * ch * 2, F32_FLOPS)


def gather_work(uv: torch.Tensor, ch: int, sizes) -> dict:
    """K2's floor on uv: uv read once, the output written once and each
    texel that the taps address, of weight 0 or not, read once
    (texture_cuda.touched_texels); 2 ops per channel per tap.  Beside it
    as all_texels_bound_ms texture_work's figure, which charges every
    texel of every level and so is no floor."""
    n_pix = uv.numel() // 2
    taps = n_pix * 4 * len(sizes)
    touched = touched_texels(uv, sizes)
    work = bound(n_pix * (2 + ch) * 4 + sum(touched) * ch * 4,
                 taps * ch * 2, F32_FLOPS)
    return dict(work, touched_texels=touched, all_texels_bound_ms=(
        texture_work(n_pix, ch, sizes, taps)["bound_ms"]))


def conv_work(kind: str, n_pix: int, c: int, o: int):
    flops = 2 * 9 * c * o * n_pix
    if kind == "fwd":      # x, w bf16, bias f32 -> y bf16
        nbytes = n_pix * c * 2 + 9 * c * o * 2 + o * 4 + n_pix * o * 2
    elif kind == "dgrad":  # g, w bf16 -> dx f32
        nbytes = n_pix * o * 2 + 9 * c * o * 2 + n_pix * c * 4
    else:                  # x, g bf16 -> dW f32
        nbytes = n_pix * (c + o) * 2 + 9 * c * o * 4
    return bound(nbytes, flops, BF16_TENSOR_FLOPS)


def conv4_flops(down: bool, c: int, o: int, h: int) -> int:
    """16 useful taps of depth c per output pixel of the down conv, as
    many per input pixel of the transpose conv (4 per output pixel), on
    a [1, h, h, c] input."""
    return 2 * 16 * c * o * ((h // 2) ** 2 if down else h * h)


def conv4_work(down: bool, c: int, o: int, h: int, out_item: int):
    """A 4x4 stride-2 conv (down) or transpose conv on a [1, h, h, c] bf16
    input: conv4_flops' operations; x and w read once in bf16, y written
    once in bf16 or f32."""
    pix_in = h * h
    pix_out = (h // 2) ** 2 if down else 4 * pix_in
    nbytes = pix_in * c * 2 + 16 * c * o * 2 + pix_out * o * out_item
    return bound(nbytes, conv4_flops(down, c, o, h), BF16_TENSOR_FLOPS)


def inside_pairs(table: torch.Tensor, ids: torch.Tensor,
                 counts: torch.Tensor, s: int, tile_h: int, tile_w: int,
                 chunk: int = 32) -> int:
    """The (pixel, candidate) pairs of these tile lists where the candidate
    passes the inside test, with the plain version's expressions."""
    n, dev = ids.shape[0], table.device
    _, _, xp, yp = (a[None, :, None, :]
                    for a in tile_pixels(s, tile_h, tile_w, table.dtype, dev))
    rows = torch.arange(n, device=dev).reshape(n, 1, 1)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for k0 in range(0, int(counts.max()) if counts.numel() else 0, chunk):
        cid = ids[:, :, k0:k0 + chunk]
        live = (torch.arange(k0, k0 + cid.shape[2], device=dev)
                < counts[..., None]) & (cid >= 0)
        d = table[rows, torch.clamp(cid, min=0).long()][..., None, :]
        x0, y0, x1, y1, x2, y2 = (d[..., i] for i in (0, 1, 3, 4, 6, 7))
        ins = (((yp - y0) * (x1 - x0) >= (xp - x0) * (y1 - y0))
               & ((yp - y1) * (x2 - x1) >= (xp - x1) * (y2 - y1))
               & ((yp - y2) * (x0 - x2) >= (xp - x2) * (y0 - y2)))
        total += (ins & live[..., None]).sum()
    return int(total)


def raster_work(table: torch.Tensor, ids: torch.Tensor, counts: torch.Tensor,
                idx: torch.Tensor, tile_h: int, tile_w: int, s: int) -> dict:
    """K7 on these tile lists: each candidate's id and 18 floats read once,
    8 B (depth, index) written per pixel; RASTER_PIXEL_OPS per inside
    (pixel, candidate) pair and RASTER_COVERED_OPS per covered pixel (idx
    >= 0), none of them a fused multiply-add.  Also the bound of the
    design before the cull, which counts every listed pair
    (listed_pairs_bound_ms), for comparison with the earlier rows."""
    cand = int(counts.sum())
    covered = int((idx >= 0).sum())
    inside = inside_pairs(table, ids, counts, s, tile_h, tile_w)
    n = counts.shape[0]
    nbytes = cand * (FACE_FLOATS * 4 + 4) + counts.numel() * 4 + n * s * s * 8
    listed = bound(nbytes, cand * (tile_h * tile_w * RASTER_PIXEL_OPS
                                   + (tile_h + tile_w) * RASTER_LINE_OPS
                                   + RASTER_CAND_OPS)
                   + covered * RASTER_COVERED_OPS, F32_OPS)
    return dict(bound(nbytes, inside * RASTER_PIXEL_OPS
                      + covered * RASTER_COVERED_OPS, F32_OPS),
                inside_pairs=inside,
                listed_pairs_bound_ms=listed["bound_ms"],
                listed_pairs_bound_by=listed["bound_by"])


def cull_counts(table: torch.Tensor, ids: torch.Tensor, counts: torch.Tensor,
                s: int, tile_h: int, tile_w: int, block=BLOCK) -> dict:
    """What K7's cull leaves of these tile lists in blocks of `block`
    (rows, columns, rows a warp): the candidates listed, the (block,
    candidate) pairs the blocks keep, the (warp, candidate) pairs the
    warps walk (kept by their block and by themselves), the (pixel,
    candidate) pairs those walks test, the longest list and the most
    survivors of one block."""
    bh, bw, wh = block
    kb = cull_keep(table, ids, counts, s, tile_h, tile_w, bh, bw)
    kw = cull_keep(table, ids, counts, s, tile_h, tile_w, wh, WARP_W)
    dev = table.device
    wy = torch.arange(-(-tile_h // wh), device=dev)
    wx = torch.arange(-(-tile_w // WARP_W), device=dev)
    # each warp's block, and its pixels in the tile
    blk = ((wy * wh // bh)[:, None] * -(-tile_w // bw)
           + (wx * WARP_W // bw)[None, :]).reshape(-1)
    pix = ((torch.clamp(tile_h - wy * wh, max=wh))[:, None]
           * torch.clamp(tile_w - wx * WARP_W, max=WARP_W)[None, :]
           ).reshape(-1)
    walked = (kw & kb[:, :, blk]).sum(3)                     # [N, T, Rw]
    return dict(candidates=int(counts.sum()), block_pairs=int(kb.sum()),
                warp_pairs=int(walked.sum()),
                pixel_pairs=int((walked * pix).sum()),
                largest_list=int(counts.max()) if counts.numel() else 0,
                largest_block=int(kb.sum(3).max()) if kb.numel() else 0)


def add_bounds(parts) -> dict:
    """The bound of several launches: the sum of theirs, bound by what
    bounds the larger share of it."""
    total = sum(p["bound_ms"] for p in parts)
    ops = sum(p["bound_ms"] for p in parts if p["bound_by"] == "operations")
    return dict(bound_ms=total,
                bound_by="operations" if ops >= total / 2 else "bytes")


# ---------------------------------------------------------------- phases


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    cap = torch.cuda.get_device_capability(0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name} capability {cap} count "
        f"{torch.cuda.device_count()} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")
    if cap != (9, 0):
        raise RuntimeError(f"capability {cap}: the kernels are built for "
                           "sm_90a (Hopper)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load_all(SOURCES)
    log(f"[build] {len(SOURCES)} sources in parallel: "
        f"{time.perf_counter() - t0:.2f} s")
    for lib in SOURCES:
        info = _build.build_info[lib]
        log(f"[build] {lib}: nvcc {info['seconds']:.2f} s")
        for ln in info["ptxas"].splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"[build]   {ln.strip()}")


def _gbuffer(img: int, batch: int = 1):
    from rnr_tpu_torch.synthetic import build_batch, to_torch
    return to_torch(build_batch(img, GCN_V, batch), DEV)


def k1_inputs(b: dict, rng):
    """K1's and K1b's operands at 512^2, lmax 10, 13 + 13 rays, bf16
    rays_lt, from the G-buffer b and four draws of rng: (K1's args,
    K1b's args)."""
    from rnr_tpu_torch.models.rays import RaySampler
    spec, diff = RaySampler(6, 2, 5.0, "reflect"), RaySampler(6, 2, 10.0,
                                                              "diffuse")
    piv = torch.from_numpy(np.concatenate([spec.pivots_dir.T,
                                           diff.pivots_dir.T]).astype(
        np.float32)).to(DEV)
    lt = torch.from_numpy(rng.uniform(0, 2, (1, IMG, IMG, 26, 3)).astype(
        np.float32)).to(DEV, torch.bfloat16)
    cf = torch.from_numpy((0.3 * rng.standard_normal((121, 3))).astype(
        np.float32)).to(DEV)
    gs, gd = (torch.from_numpy(rng.standard_normal((1, IMG, IMG, 3)).astype(
        np.float32)).to(DEV) for _ in range(2))
    args = (b["TBN_map"], b["view_dir_map_tangent"], b["alpha_map"], lt, cf,
            piv, 10, 13)
    return args, (*args[:6], gs, gd, 10, 13)


def kernels_sh(rec: dict, b: dict, rng) -> None:
    """K1 and K1b: 512^2, lmax 10, 13 + 13 rays, bf16 rays_lt; K1b also at
    batch 2 (its own seed).  Single-call medians, calls queued back to
    back, the wrappers' host time, and f32 T-ops/s: sh_work's operations
    over the queued time."""
    args, bargs = k1_inputs(b, rng)
    lt, cf, piv = args[3], args[4], args[5]
    n_pix = IMG * IMG
    ks, kd = sh_shade_fan(*args)
    ks2, kd2 = sh_shade_fan(*args)
    ts, td = sh_shade_fan_torch(*args)
    torch.cuda.synchronize()
    if not (torch.equal(ks, ks2) and torch.equal(kd, kd2)):
        raise AssertionError("sh_shade_fan: two runs differ")
    scale = max(float(ts.abs().max()), float(td.abs().max()))
    err = max(float((ks - ts).abs().max()), float((kd - td).abs().max()))
    tol = 1e-4 * scale + 1e-5   # f32 both sides; FMA and sum order differ
    log(f"[kernels] sh_shade_fan {IMG}^2 lmax10 R26 bf16: max abs err "
        f"{err:.3g}, rel {err / scale:.3g} (max |ref| {scale:.3g}, "
        f"tol {tol:.3g}); two runs bitwise equal")
    check("sh_shade_fan", err, tol)
    check_digest("sh_shade_fan", digest(ks, kd))
    log("[kernels] sh_shade_fan: output bit-equal to the pinned digest")
    rec["sh_shade_fan"] = sh_times(
        lambda: sh_shade_fan(*args), sh_work(n_pix, 26, 10, 2, False),
        max_abs_err=err, bitwise_reproducible=True,
        plain_ms=cuda_ms(lambda: sh_shade_fan_torch(*args), iters=3,
                         warmup=1), library_ms=None)
    log_sh_times("sh_shade_fan", rec["sh_shade_fan"])
    del ks, kd, ks2, kd2, ts, td

    # K1b: the output gradients of both means
    kl, kc, err_c, err_l = sh_bwd_case(bargs, "b1")
    check_digest("sh_shade_fan_bwd", digest(kl, kc))
    log("[kernels] sh_shade_fan_bwd: output bit-equal to the pinned digest")
    rec["sh_shade_fan_bwd"] = sh_times(
        lambda: sh_shade_fan_bwd(*bargs), sh_work(n_pix, 26, 10, 2, True),
        max_abs_err=max(err_c, err_l), dcoeff_max_abs_err=err_c,
        dlt_max_abs_err=err_l, bitwise_reproducible=True,
        plain_ms=cuda_ms(lambda: sh_shade_fan_bwd_torch(*bargs), iters=3,
                         warmup=1), library_ms=None)
    log_sh_times("sh_shade_fan_bwd", rec["sh_shade_fan_bwd"])
    del kl, kc, lt

    # K1b at batch 2: the b2 step's 524,288 pixels, its own seed
    r2 = np.random.default_rng(9)
    b2 = _gbuffer(IMG, 2)
    lt2 = torch.from_numpy(r2.uniform(0, 2, (2, IMG, IMG, 26, 3)).astype(
        np.float32)).to(DEV, torch.bfloat16)
    g2 = [torch.from_numpy(r2.standard_normal((2, IMG, IMG, 3)).astype(
        np.float32)).to(DEV) for _ in range(2)]
    bargs2 = (b2["TBN_map"], b2["view_dir_map_tangent"], b2["alpha_map"],
              lt2, cf, piv, *g2, 10, 13)
    _, _, err_c2, err_l2 = sh_bwd_case(bargs2, "b2")
    b2_rec = sh_times(lambda: sh_shade_fan_bwd(*bargs2),
                      sh_work(2 * n_pix, 26, 10, 2, True),
                      dcoeff_max_abs_err=err_c2, dlt_max_abs_err=err_l2)
    log_sh_times("sh_shade_fan_bwd b2", b2_rec)
    rec["sh_shade_fan_bwd"]["b2"] = b2_rec
    del lt2, g2, b2, bargs2
    torch.cuda.synchronize()


def sh_bwd_case(bargs, tag: str):
    """K1b twice (bit-equal) against its plain version: d coeff within
    1e-4 x its max, d rays_lt within 2^-7 x its max."""
    kl, kc = sh_shade_fan_bwd(*bargs)
    kl2, kc2 = sh_shade_fan_bwd(*bargs)
    tl, tc = sh_shade_fan_bwd_torch(*bargs)
    torch.cuda.synchronize()
    if not (torch.equal(kc, kc2) and torch.equal(kl, kl2)):
        raise AssertionError(f"sh_shade_fan_bwd {tag}: two runs differ")
    err_c = float((kc - tc).abs().max())
    scale_c = float(tc.abs().max())
    # d coeff: f32 sums over 6.8M pixel-rays (b1) in another order
    check(f"sh_shade_fan_bwd {tag} d coeff", err_c, 1e-4 * scale_c)
    err_l = float((kl.float() - tl.float()).abs().max())
    scale_l = float(tl.float().abs().max())
    # d rays_lt: f32 radiance (FMA contraction), then one bf16 rounding,
    # which may land one step (2^-8 relative) the other way
    check(f"sh_shade_fan_bwd {tag} d rays_lt", err_l, 2 ** -7 * scale_l)
    log(f"[kernels] sh_shade_fan_bwd {tag}: d coeff max abs err {err_c:.3g} "
        f"(rel {err_c / scale_c:.3g}, tol 1e-4 x max), d rays_lt max abs "
        f"err {err_l:.3g} (rel {err_l / scale_l:.3g}, tol 2^-7 x max); "
        f"two runs bitwise equal")
    return kl, kc, err_c, err_l


def sh_times(fn, work: dict, **extra) -> dict:
    """A K1 / K1b record: the single-call median, the queued time, the
    host time, the bound (sh_work) and the f32 rate it implies: sh_work's
    operations over the queued time."""
    ms, q_ms = cuda_ms(fn), queued_ms(fn)
    return dict(extra, ms=ms, queued_ms=q_ms, host_us=host_us(fn),
                f32_tops=work["bound_ms"] / q_ms * F32_FLOPS / 1e12, **work)


def log_sh_times(name: str, r: dict) -> None:
    log(f"[kernels] {name}: {r['ms']:.4f} ms single, {r['queued_ms']:.4f} "
        f"ms queued ({r['f32_tops']:.1f} f32 T-ops/s of sh_work's count), "
        f"host {r['host_us']:.1f} us, bound {r['bound_ms']:.4f} ms")


def kernels_shade(rec: dict, b: dict) -> None:
    """K5 and K5b: the unfused shading at 512^2, lmax 10, 13 + 13 rays,
    rays_dir from the fan builder of the G-buffer (zero directions at the
    masked pixels) and rays_lt in bf16, as the unfused path stores them."""
    from rnr_tpu_torch.models.rays import RaySampler, build_fan_channels
    rng = np.random.default_rng(5)
    spec, diff = RaySampler(6, 2, 5.0, "reflect"), RaySampler(6, 2, 10.0,
                                                              "diffuse")
    piv = torch.from_numpy(np.concatenate([spec.pivots_dir.T,
                                           diff.pivots_dir.T]).astype(
        np.float32)).to(DEV)
    rd = build_fan_channels(b["TBN_map"], b["view_dir_map_tangent"],
                            b["alpha_map"], piv, 13)[1].to(torch.bfloat16)
    lt = torch.from_numpy(rng.uniform(0, 2, (1, IMG, IMG, 26, 3)).astype(
        np.float32)).to(DEV, torch.bfloat16)
    cf = torch.from_numpy((0.3 * rng.standard_normal((121, 3))).astype(
        np.float32)).to(DEV)
    al = b["alpha_map"]
    args = (rd, lt, al, cf, 10, 13)
    n_pix = IMG * IMG
    ks, kd = sh_shade(*args)
    ks2, kd2 = sh_shade(*args)
    ts, td = sh_shade_torch(*args)
    torch.cuda.synchronize()
    if not (torch.equal(ks, ks2) and torch.equal(kd, kd2)):
        raise AssertionError("sh_shade: two runs differ")
    masked = al[..., 0] == 0
    if not (bool((ks[masked] == 0).all()) and bool((kd[masked] == 0).all())):
        raise AssertionError("sh_shade: masked pixels not exactly 0")
    scale = max(float(ts.abs().max()), float(td.abs().max()))
    err = max(float((ks - ts).abs().max()), float((kd - td).abs().max()))
    tol = 1e-4 * scale + 1e-5   # f32 both sides; FMA and sum order differ
    log(f"[kernels] sh_shade {IMG}^2 lmax10 R26 bf16 rays: max abs err "
        f"{err:.3g}, rel {err / scale:.3g} (max |ref| {scale:.3g}, tol "
        f"{tol:.3g}); {int(masked.sum())} masked pixels exactly 0; two runs "
        f"bitwise equal")
    check("sh_shade", err, tol)
    rec["sh_shade"] = sh_times(
        lambda: sh_shade(*args), sh_work(n_pix, 26, 10, 2, False, fan=False),
        max_abs_err=err, bitwise_reproducible=True,
        plain_ms=cuda_ms(lambda: sh_shade_torch(*args), iters=3, warmup=1),
        library_ms=None)
    log_sh_times("sh_shade", rec["sh_shade"])
    del ks, kd, ks2, kd2, ts, td

    gs = torch.from_numpy(rng.standard_normal((1, IMG, IMG, 3)).astype(
        np.float32)).to(DEV)
    gd = torch.from_numpy(rng.standard_normal((1, IMG, IMG, 3)).astype(
        np.float32)).to(DEV)
    bargs = (rd, lt, al, cf, gs, gd, 10, 13)
    kl, kc = sh_shade_bwd(*bargs)
    kl2, kc2 = sh_shade_bwd(*bargs)
    tl, tc = sh_shade_bwd_torch(*bargs)
    torch.cuda.synchronize()
    if not (torch.equal(kc, kc2) and torch.equal(kl, kl2)):
        raise AssertionError("sh_shade_bwd: two runs differ")
    err_c = float((kc - tc).abs().max())
    scale_c = float(tc.abs().max())
    check("sh_shade_bwd d coeff", err_c, 1e-4 * scale_c)
    err_l = float((kl.float() - tl.float()).abs().max())
    scale_l = float(tl.float().abs().max())
    check("sh_shade_bwd d rays_lt", err_l, 2 ** -7 * scale_l)
    log(f"[kernels] sh_shade_bwd: d coeff max abs err {err_c:.3g} (rel "
        f"{err_c / scale_c:.3g}, tol 1e-4 x max), d rays_lt max abs err "
        f"{err_l:.3g} (rel {err_l / scale_l:.3g}, tol 2^-7 x max); two runs "
        f"bitwise equal")
    got = digest(kl, kc)
    if got != K5B_DIGEST:
        raise AssertionError(f"sh_shade_bwd: output digest {got} differs "
                             f"from {K5B_DIGEST}, the pinned one")
    log("[kernels] sh_shade_bwd: output bit-equal to the pinned digest")
    masked_l = kl[masked]
    if not bool((masked_l == 0).all()):
        raise AssertionError("sh_shade_bwd: masked pixels' d rays_lt not "
                             "exactly 0")
    rec["sh_shade_bwd"] = sh_times(
        lambda: sh_shade_bwd(*bargs),
        sh_work(n_pix, 26, 10, 2, True, fan=False),
        max_abs_err=max(err_c, err_l), dcoeff_max_abs_err=err_c,
        dlt_max_abs_err=err_l, bitwise_reproducible=True,
        plain_ms=cuda_ms(lambda: sh_shade_bwd_torch(*bargs), iters=3,
                         warmup=1), library_ms=None)
    log_sh_times("sh_shade_bwd", rec["sh_shade_bwd"])
    del kl, kc, kl2, kc2, tl, tc, lt, rd
    torch.cuda.synchronize()


def kernels_texture(rec: dict, b: dict, rng) -> None:
    """K2 and K2b: the G-buffer's uv (about half the frame uncovered, at
    uv = 0) over 4 levels 512..64 x 24 channels.  K2 also at batch 2, with
    every pixel on the corner texel, with a uv seam inside the pixel tiles
    and on one view of the G-buffer phase's sphere; on each case single,
    queued and host times, twice bit-equal, its bound from the texels its
    taps touch; on the G-buffer case also the digest pinned in K2_DIGEST,
    the host time a call through the autograd Function (a training step's
    way) beside the wrapper's without it (an eval frame's) and, as a
    yardstick, four F.grid_sample calls summed.  K2b also at
    batch 2, on the corner and the seam; its GB/s, queued and host times
    beside its median."""
    texs = [torch.from_numpy((0.5 + 0.5 * rng.standard_normal(
        (s, s, 24))).astype(np.float32)).to(DEV) for s in TEX_SIZES]
    uv = b["uv_map"]
    n_pix = uv.shape[0] * uv.shape[1] * uv.shape[2]
    r, k = gather_case(texs, uv, "G-buffer uv, b1")
    got = digest(k)
    log(f"[kernels] mipmap_gather G-buffer uv, b1: output sha256 {got}")
    if got != K2_DIGEST:
        raise AssertionError(f"mipmap_gather: output digest {got} differs "
                             f"from K2_DIGEST {K2_DIGEST}")
    # the yardstick: torch's bilinear sampler, one call a level (NCHW,
    # zero padding, align_corners: texel centres at -1 and 1), summed
    nchw = [t.permute(2, 0, 1)[None].contiguous() for t in texs]
    grid = torch.stack([2 * uv[..., 0] - 1, 1 - 2 * uv[..., 1]], -1)

    def grid_sample_sum():
        out = None
        for t in nchw:
            s = F.grid_sample(t, grid, mode="bilinear", padding_mode="zeros",
                              align_corners=True)
            out = s if out is None else out + s
        return out

    # the autograd Function's own host time: the wrapper called through it
    # and without it, alternated, the median of three runs of each
    with_fn, without_fn = [], []
    for _ in range(3):
        without_fn.append(host_us(lambda: mipmap_sample(texs, uv)))
        with_fn.append(host_us(lambda: MipmapSampleFn.apply(uv, *texs)))
    fn_us, no_fn_us = float(np.median(with_fn)), float(np.median(without_fn))
    log(f"[kernels] mipmap_gather G-buffer uv, b1: host {fn_us:.1f} us a "
        f"call through the autograd Function, {no_fn_us:.1f} us without it")
    rec["mipmap_gather"] = dict(
        r, plain_ms=cuda_ms(lambda: mipmap_sample_torch(texs, uv)),
        library_ms=None, grid_sample_ms=cuda_ms(grid_sample_sum),
        function_host_us=fn_us, no_function_host_us=no_fn_us,
        digest=got, cases={})
    for tag, u in (("G-buffer uv, b2", _gbuffer(IMG, 2)["uv_map"]),
                   ("every pixel on the corner texel", torch.zeros_like(uv)),
                   ("uv seam 0.02 | 0.98 at column 259", seam_uv(uv)),
                   ("a view of the G-buffer phase's sphere", sphere_view_uv())):
        rec["mipmap_gather"]["cases"][tag] = gather_case(texs, u, tag)[0]
    log(f"[kernels] mipmap_gather G-buffer uv, b1: grid_sample x 4 summed "
        f"{rec['mipmap_gather']['grid_sample_ms']:.4f} ms (yardstick)")
    del k

    g = torch.from_numpy(rng.standard_normal((1, IMG, IMG, 24)).astype(
        np.float32)).to(DEV)
    err, rerun, taps = scatter_case(uv, g, "G-buffer uv, b1")
    ms = cuda_ms(lambda: mipmap_scatter(uv, g, TEX_SIZES))
    work = texture_work(n_pix, 24, TEX_SIZES, taps)
    rec["mipmap_scatter"] = dict(
        max_abs_err=err, rerun_max_diff=rerun, ms=ms,
        queued_ms=queued_ms(lambda: mipmap_scatter(uv, g, TEX_SIZES)),
        host_us=host_us(lambda: mipmap_scatter(uv, g, TEX_SIZES)),
        plain_ms=cuda_ms(lambda: mipmap_scatter_torch(uv, g, TEX_SIZES),
                         iters=3, warmup=1),
        library_ms=None, **work)
    log(f"[kernels] mipmap_scatter b1: {ms:.4f} ms, "
        f"{scatter_bytes(n_pix, 24) / ms / 1e6:.1f} GB/s, queued "
        f"{rec['mipmap_scatter']['queued_ms']:.4f} ms")
    # batch 2 (the b2 step's 524,288 pixels), every pixel on the corner
    # texel, and a uv seam inside the pixel tiles
    b2 = _gbuffer(IMG, 2)["uv_map"]
    g2 = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, IMG, IMG, 24)).astype(np.float32)).to(DEV)
    for tag, u, gg in (("G-buffer uv, b2", b2, g2),
                       ("every pixel on the corner texel",
                        torch.zeros_like(uv), g),
                       ("uv seam 0.02 | 0.98 at column 259", seam_uv(uv), g)):
        scatter_case(u, gg, tag)
        ms = cuda_ms(lambda: mipmap_scatter(u, gg, TEX_SIZES))
        n = u.shape[0] * IMG * IMG
        log(f"[kernels] mipmap_scatter {tag}: {ms:.4f} ms, "
            f"{scatter_bytes(n, 24) / ms / 1e6:.1f} GB/s")
    torch.cuda.synchronize()


def gather_case(texs, uv: torch.Tensor, tag: str):
    """K2 against its plain version on uv over TEX_SIZES (NaN where it is
    NaN; else f32 both sides, FMA contraction only), twice bit-equal;
    single, queued and host times, the C entry's own queued time
    (kernel_queued_ms: where the wrapper's host time exceeds the kernel's,
    queued wrapper calls time the host) and the bound (gather_work).
    Returns the record and K2's output."""
    k = mipmap_sample(texs, uv)
    k2 = mipmap_sample(texs, uv)
    t = mipmap_sample_torch(texs, uv)
    torch.cuda.synchronize()
    if not torch.equal(k.isnan(), t.isnan()):
        raise AssertionError(f"mipmap_gather {tag}: NaN elsewhere than in "
                             "the plain version")
    if not torch.equal(k.nan_to_num(), k2.nan_to_num()):
        raise AssertionError(f"mipmap_gather {tag}: two runs differ")
    scale = float(t.nan_to_num().abs().max())
    err = float((k.nan_to_num() - t.nan_to_num()).abs().max())
    tol = 1e-5 * scale + 1e-6   # f32 both sides; FMA contraction only
    check(f"mipmap_gather {tag}", err, tol)
    r = dict(max_abs_err=err, bitwise_reproducible=True,
             ms=cuda_ms(lambda: mipmap_sample(texs, uv)),
             queued_ms=queued_ms(lambda: mipmap_sample(texs, uv)),
             host_us=host_us(lambda: mipmap_sample(texs, uv)),
             kernel_queued_ms=gather_entry_queued_ms(texs, uv),
             **gather_work(uv, 24, TEX_SIZES))
    log(f"[kernels] mipmap_gather {tag} -> 4 levels x 24: max abs err "
        f"{err:.3g}, rel {err / scale:.3g} (tol {tol:.3g}); single "
        f"{r['ms']:.4f} ms, queued {r['queued_ms']:.4f} ms, host "
        f"{r['host_us']:.1f} us, C entry queued "
        f"{r['kernel_queued_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}; texels touched {r['touched_texels']}), every "
        f"texel {r['all_texels_bound_ms']:.4f} ms; twice bit-equal")
    return r, k


def gather_entry_queued_ms(texs, uv: torch.Tensor) -> float:
    """K2's C entry alone, called 20 times back to back between two CUDA
    events over TEX_SIZES (one launch, nothing counted): the kernel's
    device time per call, without the wrapper's host time."""
    n, h, w, _ = uv.shape
    out = torch.empty((n, h, w, 24), device=DEV)
    f = _build.fn("mipmap_gather", "rnr_mipmap_gather", 6, 10)
    args = (*[t.data_ptr() for t in texs], uv.data_ptr(), out.data_ptr(),
            *TEX_SIZES, len(TEX_SIZES), n, h, w, 24, 0,
            torch.cuda.current_stream().cuda_stream)
    return queued_ms(lambda: check_launch(f(*args), "mipmap_gather"))


def sphere_view_uv() -> torch.Tensor:
    """The uv map of the first view of the G-buffer phase's sphere (K7
    and the G-buffer's plain torch on the card)."""
    from rnr_tpu_torch.drivers import test_rnr
    from rnr_tpu_torch.ops.gbuffer import make_mesh_buffers, render_gbuffer
    from rnr_tpu_torch.synthetic import camera_ring, sphere_mesh
    mb = make_mesh_buffers(sphere_mesh(*MESH_LAT_LON))
    gb = test_rnr._gbuffer(render_gbuffer, mb, camera_ring(IMG, N_VIEWS)[0],
                           IMG)
    return gb["uv_map"].contiguous()


def scatter_bytes(n_pix: int, ch: int) -> int:
    """The bytes K2b must move at 512^2 over TEX_SIZES: uv and g read
    once, every level's gradient written once (texture_work's count)."""
    return n_pix * (2 * 4 + ch * 4) + sum(s * s * ch * 4 for s in TEX_SIZES)


def seam_uv(uv: torch.Tensor) -> torch.Tensor:
    """The G-buffer's uv with a seam: over the object, u from 0.02 rising
    left of column 259 and from 0.98 falling right of it, so the pixel
    tiles across that column (259 is inside an 8-pixel tile) see texels
    at both ends of every level."""
    col = torch.arange(uv.shape[2], device=uv.device, dtype=torch.float32)
    ramp = (col - 259.0).abs() / uv.shape[2] * 0.1
    u = torch.where(col < 259, 0.02 + ramp, 0.98 - ramp)
    covered = (uv != 0).any(-1, keepdim=True)
    return torch.where(covered, torch.stack(
        [u.expand_as(uv[..., 0]), uv[..., 1]], -1), uv).contiguous()


def scatter_case(uv: torch.Tensor, g: torch.Tensor, tag: str):
    """K2b against its plain version on (uv, g), every level per texel
    within 1e-5 x the sum of its terms' magnitudes (f32 atomics on both
    sides: the same products added in another order, so each texel may
    differ by a rounding of its partial sums; the corner texel of the
    uncovered pixels sums 131,072 terms), and the run-to-run difference.
    Returns the max abs error, the run-to-run max difference and the
    count of taps of nonzero weight (the kernel skips the others)."""
    kg = mipmap_scatter(uv, g, TEX_SIZES)
    kg2 = mipmap_scatter(uv, g, TEX_SIZES)
    tg = mipmap_scatter_torch(uv, g, TEX_SIZES)
    mag = mipmap_scatter_torch(uv, g.abs(), TEX_SIZES)
    torch.cuda.synchronize()
    err = rerun = 0.0
    for a, a2, r, m, s in zip(kg, kg2, tg, mag, TEX_SIZES):
        excess = float(((a - r).abs() - 1e-5 * m).max())
        check(f"mipmap_scatter {tag} level {s}", excess, 0.0)
        err = max(err, float((a - r).abs().max()))
        rerun = max(rerun, float((a - a2).abs().max()))
    taps = 0
    for s in TEX_SIZES:
        x, y = level_coords(uv, s)
        taps += sum(int((w != 0).sum()) for _, w in bilinear_taps(x, y, s, s))
    log(f"[kernels] mipmap_scatter {tag} -> 4 levels x 24: max abs err "
        f"{err:.3g} (tol 1e-5 x the sum of each texel's |terms|); "
        f"run-to-run max difference {rerun:.3g} (f32 atomics); {taps} "
        f"nonzero taps of {uv.shape[0] * IMG * IMG * 4 * len(TEX_SIZES)}")
    return err, rerun, taps


# the two formulations of the 3x3 conv at reflect padding: forward (bf16),
# data gradient (f32), weight gradient (f32), each with its plain version
CONV3_FORMS = {
    "conv3x3": dict(
        fwd=lambda x, w, b: conv3x3(x, w, b, "reflect"),
        fwd_plain=lambda x, w, b: conv3x3_torch(x, w, b, "reflect"),
        dgrad=conv3x3_dgrad, dgrad_plain=conv3x3_dgrad_torch,
        wgrad=conv3x3_wgrad, wgrad_plain=conv3x3_wgrad_torch),
    "conv3x3s": dict(
        fwd=lambda x, w, b: conv3x3s_fwd(x, w, b, "reflect"),
        fwd_plain=lambda x, w, b: conv3x3s_torch(x, w, b, "reflect"),
        dgrad=conv3x3s_dgrad, dgrad_plain=conv3x3s_dgrad_torch,
        wgrad=conv3x3s_wgrad, wgrad_plain=conv3x3s_wgrad_torch),
}
# odd C and O, odd H: both 3x3 pairs under both pad modes
CONV3_ODD = [(45, 77, 64), (64, 64, 63)]
# K3 and K3b at batch 2 (their tiles never straddle two images): one
# 512^2 shape of the frame, (C, O, H)
CONV3_B2 = (64, 64, 512)


def kernels_conv(rec: dict, rng) -> None:
    """K3 (forward, and its f32-output data gradient) and K3b, then the
    slab pair K8a (the same two) and K8b on the same inputs, over the 14
    convs of a frame, reflect padding, bf16 activations and gradients;
    K3's forward and K3b twice bit-equal, K8a's forward within one
    rounding step of K3's.  cuDNN computes the same function for both
    formulations: it is timed once per shape.  K8a / K8b also with 20
    calls queued back to back beside cuDNN's queued likewise, the
    wrappers' host time and the TFLOP/s per shape and in total.  Then the
    slab pair at odd C and O and an odd H, both pad modes (K3's:
    kernels_conv3_odd), and K8a twice bit-equal (k8a_bitwise)."""
    errs = {(f, k): [] for f in CONV3_FORMS for k in ("fwd", "dgrad",
                                                      "wgrad")}
    tot = {key: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
           for key in errs}
    # K3 / K3b and cuDNN with calls queued back to back (queued_ms)
    queued = {k: [0.0, 0.0] for k in ("fwd", "dgrad", "wgrad")}
    works = {k: [] for k in ("fwd", "dgrad", "wgrad")}
    # K8a / K8b queued, host time and TFLOP/s, per shape and in total
    k8s = {k: dict(queued_ms=0.0, flops=0, host=[], shapes=[])
           for k in ("fwd", "dgrad", "wgrad")}
    aten_bwd = torch.ops.aten.convolution_backward
    vs_k3 = []
    for c, o, h in CONV_SHAPES:
        x = torch.from_numpy(rng.standard_normal((1, h, h, c)).astype(
            np.float32)).to(DEV, torch.bfloat16)
        g = torch.from_numpy(rng.standard_normal((1, h, h, o)).astype(
            np.float32)).to(DEV, torch.bfloat16)
        w = torch.from_numpy((rng.standard_normal((3, 3, c, o))
                              / np.sqrt(9 * c)).astype(np.float32)).to(DEV)
        bias = torch.from_numpy(rng.standard_normal(o).astype(
            np.float32)).to(DEV)
        tag = f"{c}->{o} @{h}"
        outs = {}
        for form, fs in CONV3_FORMS.items():
            ky = fs["fwd"](x, w, bias)
            ty = fs["fwd_plain"](x, w, bias)
            kd = fs["dgrad"](g, w, "reflect")
            td = fs["dgrad_plain"](g, w, "reflect")
            kw = fs["wgrad"](x, g, "reflect")
            kw2 = fs["wgrad"](x, g, "reflect")
            tw = fs["wgrad_plain"](x, g, "reflect")
            torch.cuda.synchronize()
            if not torch.equal(kw, kw2):
                raise AssertionError(f"{form}_wgrad {tag}: two runs differ")
            if form == "conv3x3" and not torch.equal(ky,
                                                     fs["fwd"](x, w, bias)):
                raise AssertionError(f"conv3x3 fwd {tag}: two runs differ")
            # fwd: bf16 output, one rounding step of the largest values
            # (2^-8 relative) from f32 sums in another order; dgrad and
            # wgrad: bf16 operands multiply exactly, f32 sums in another
            # order
            for kind, k, t, rel in (("fwd", ky.float(), ty.float(), 2 ** -7),
                                    ("dgrad", kd, td, 1e-4),
                                    ("wgrad", kw, tw, 1e-4)):
                scale = float(t.abs().max())
                e = float((k - t).abs().max())
                check(f"{form} {kind} {tag}", e, rel * scale)
                errs[(form, kind)].append(e)
            outs[form] = ky.float()
            del ky, ty, kd, td, kw, kw2, tw
        e = float((outs["conv3x3s"] - outs["conv3x3"]).abs().max())
        check(f"conv3x3s fwd vs conv3x3 fwd {tag}", e,
              2 ** -7 * float(outs["conv3x3"].abs().max()))
        vs_k3.append(e)
        # the library yardsticks: cuDNN on the NCHW channels-last views,
        # zero padding (the same FLOPs; reflect needs a second call)
        xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        wn = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bn = bias.to(torch.bfloat16)
        lib = {
            "fwd": lambda: F.conv2d(xn, wn, bn, padding=1),
            "dgrad": lambda: aten_bwd(gn, xn, wn, None, [1, 1], [1, 1],
                                      [1, 1], False, [0, 0], 1,
                                      [True, False, False]),
            "wgrad": lambda: aten_bwd(gn, xn, wn, None, [1, 1], [1, 1],
                                      [1, 1], False, [0, 0], 1,
                                      [False, True, False]),
        }
        args = {"fwd": (x, w, bias), "dgrad": (g, w, "reflect"),
                "wgrad": (x, g, "reflect")}
        line = {f: [] for f in CONV3_FORMS}
        for kind, lf in lib.items():
            lms = cuda_ms(lf)
            queued[kind][0] += queued_ms(
                lambda: CONV3_FORMS["conv3x3"][kind](*args[kind]))
            lq = queued_ms(lf)
            queued[kind][1] += lq
            wk = conv_work(kind, h * h, c, o)
            works[kind].append(wk)
            tflop = 2 * 9 * c * o * h * h / 1e9
            k8_fn = (lambda: CONV3_FORMS["conv3x3s"][kind](*args[kind]))
            q, hu = queued_ms(k8_fn), host_us(k8_fn)
            r = k8s[kind]
            r["queued_ms"] += q
            r["flops"] += 2 * 9 * c * o * h * h
            r["host"].append(hu)
            r["shapes"].append(dict(c=c, o=o, h=h, queued_ms=q,
                                    library_queued_ms=lq, host_us=hu,
                                    tflops=tflop / q))
            line["conv3x3s"].append(
                f"{kind} queued {q:.4f} ms ({tflop / q:.1f} TFLOP/s; cuDNN "
                f"{lq:.4f}), host {hu:.1f} us")
            for form, fs in CONV3_FORMS.items():
                a = args[kind]
                ms = cuda_ms(lambda: fs[kind](*a))
                pms = cuda_ms(lambda: fs[kind + "_plain"](*a), iters=3,
                              warmup=1)
                t = tot[(form, kind)]
                t["ms"] += ms
                t["plain_ms"] += pms
                t["library_ms"] += lms
                line[form].append(
                    f"{kind} {ms:.3f} ms ({tflop / ms:.1f} TFLOP/s, bound "
                    f"{wk['bound_ms']:.3f}, cuDNN {lms:.3f}, plain "
                    f"{pms:.3f})")
        for form in CONV3_FORMS:
            log(f"[kernels] {form} {tag}: errs fwd "
                f"{errs[(form, 'fwd')][-1]:.3g} dgrad "
                f"{errs[(form, 'dgrad')][-1]:.3g} wgrad "
                f"{errs[(form, 'wgrad')][-1]:.3g}; " + "; ".join(line[form]))
        log(f"[kernels] conv3x3s fwd vs conv3x3 fwd {tag}: max abs diff "
            f"{e:.3g}")
        del x, g, outs
    for form in CONV3_FORMS:
        for kind in ("fwd", "dgrad", "wgrad"):
            b = add_bounds(works[kind])
            t = tot[(form, kind)]
            log(f"[kernels] {form} {kind}, 14 convs of a frame: kernel "
                f"{t['ms']:.3f} ms, bound {b['bound_ms']:.3f} ms, cuDNN "
                f"{t['library_ms']:.3f} ms ({t['ms'] / t['library_ms']:.2f}x),"
                f" plain {t['plain_ms']:.3f} ms")
        fd = add_bounds(works["fwd"] + works["dgrad"])
        f_, d_, w_ = (tot[(form, k)] for k in ("fwd", "dgrad", "wgrad"))
        rec[form] = dict(
            max_abs_err=max(errs[(form, "fwd")] + errs[(form, "dgrad")]),
            ms=f_["ms"] + d_["ms"], plain_ms=f_["plain_ms"] + d_["plain_ms"],
            library_ms=f_["library_ms"] + d_["library_ms"],
            fwd_ms=f_["ms"], dgrad_ms=d_["ms"],
            fwd_bound_ms=add_bounds(works["fwd"])["bound_ms"],
            dgrad_bound_ms=add_bounds(works["dgrad"])["bound_ms"], **fd)
        rec[form + "_wgrad"] = dict(
            max_abs_err=max(errs[(form, "wgrad")]), bitwise_reproducible=True,
            **w_, **add_bounds(works["wgrad"]))
    rec["conv3x3s"]["vs_conv3x3_max_abs_diff"] = max(vs_k3)
    log("[kernels] conv3x3, 14 convs, 20 calls queued back to back per "
        "shape: " + "; ".join(
            f"{k} {q[0]:.3f} ms (cuDNN {q[1]:.3f}, {q[0] / q[1]:.2f}x)"
            for k, q in queued.items()))
    x = _bf16_input(np.random.default_rng(1), (1, IMG, IMG, 64))
    w = torch.zeros((3, 3, 64, 64), device=DEV)
    zb = torch.zeros(64, device=DEV)
    log("[kernels] conv3x3 wrappers' host time per call at 64 -> 64 @512: "
        f"fwd {host_us(lambda: conv3x3_fwd(x, w, zb, 'reflect')):.1f} us, "
        f"dgrad {host_us(lambda: conv3x3_dgrad(x, w, 'reflect')):.1f} us, "
        f"wgrad {host_us(lambda: conv3x3_wgrad(x, x, 'reflect')):.1f} us")
    rec["conv3x3"]["queued_ms"] = queued["fwd"][0] + queued["dgrad"][0]
    rec["conv3x3"]["queued_library_ms"] = (queued["fwd"][1]
                                           + queued["dgrad"][1])
    rec["conv3x3_wgrad"]["queued_ms"] = queued["wgrad"][0]
    rec["conv3x3_wgrad"]["queued_library_ms"] = queued["wgrad"][1]
    for kind, r in k8s.items():
        log(f"[kernels] conv3x3s {kind}, 14 convs, 20 calls queued back to "
            f"back per shape: {r['queued_ms']:.4f} ms "
            f"({r['flops'] / r['queued_ms'] / 1e9:.1f} TFLOP/s), cuDNN "
            f"queued {queued[kind][1]:.4f} ms "
            f"({r['queued_ms'] / queued[kind][1]:.2f}x), host "
            f"{np.mean(r['host']):.1f} us a call")
    f_, d_, w_ = k8s["fwd"], k8s["dgrad"], k8s["wgrad"]
    rec["conv3x3s"].update(
        queued_ms=f_["queued_ms"] + d_["queued_ms"],
        queued_library_ms=queued["fwd"][1] + queued["dgrad"][1],
        fwd_queued_ms=f_["queued_ms"], dgrad_queued_ms=d_["queued_ms"],
        host_us=float(np.mean(f_["host"] + d_["host"])),
        tflops=(f_["flops"] + d_["flops"])
        / (f_["queued_ms"] + d_["queued_ms"]) / 1e9,
        shapes=dict(fwd=f_["shapes"], dgrad=d_["shapes"]))
    rec["conv3x3s_wgrad"].update(
        queued_ms=w_["queued_ms"], queued_library_ms=queued["wgrad"][1],
        host_us=float(np.mean(w_["host"])),
        tflops=w_["flops"] / w_["queued_ms"] / 1e9, shapes=w_["shapes"])
    for form in CONV3_FORMS:
        f_, d_ = tot[(form, "fwd")], tot[(form, "dgrad")]
        ms, lms = f_["ms"] + d_["ms"], f_["library_ms"] + d_["library_ms"]
        log(f"[kernels] {form} fwd + dgrad, 14 convs: {ms:.3f} ms, cuDNN "
            f"{lms:.3f} ms ({ms / lms:.2f}x)")

    # the slab pair at odd C and O and an odd H, both pad modes
    for c, o, h in CONV3_ODD:
        x = _bf16_input(rng, (1, h, h, c))
        g = _bf16_input(rng, (1, h, h, o))
        w = torch.from_numpy((rng.standard_normal((3, 3, c, o))
                              / np.sqrt(9 * c)).astype(np.float32)).to(DEV)
        bias = torch.from_numpy(rng.standard_normal(o).astype(
            np.float32)).to(DEV)
        for pm in ("reflect", "same"):
            tag = f"{c}->{o} @{h} {pm}"
            _conv4_check(f"conv3x3s {tag}", conv3x3s_fwd(x, w, bias, pm),
                         conv3x3s_torch(x, w, bias, pm), 2 ** -7)
            _conv4_check(f"conv3x3s f32 {tag}",
                         conv3x3s_fwd(x, w, bias, pm, torch.float32),
                         conv3x3s_torch(x, w, bias, pm, torch.float32), 1e-4)
            _conv4_check(f"conv3x3s dgrad {tag}", conv3x3s_dgrad(g, w, pm),
                         conv3x3s_dgrad_torch(g, w, pm), 1e-4)
            kw = conv3x3s_wgrad(x, g, pm)
            _conv4_check(f"conv3x3s_wgrad {tag}", kw,
                         conv3x3s_wgrad_torch(x, g, pm), 1e-4)
            if not torch.equal(kw, conv3x3s_wgrad(x, g, pm)):
                raise AssertionError(f"conv3x3s_wgrad {tag}: two runs differ")
    torch.cuda.synchronize()
    log(f"[kernels] 3x3 slab odd shapes {CONV3_ODD}: K8a (bf16 within 2^-7 "
        "of max, f32 and dgrad within 1e-4) and K8b (within 1e-4, twice "
        "bit-equal) agree, both pad modes")
    k8a_bitwise()


def k8a_bitwise() -> None:
    """K8a twice on the same inputs (its own seed) at one 512^2 and one
    32^2 shape of the frame: the forward (bf16 and f32 out) and the f32
    data gradient under both pads, bitwise equal."""
    from rnr_tpu_torch.ops.conv_cuda import k8a_plan
    rng = np.random.default_rng(11)
    for c, o, h in (CONV_SHAPES[1], CONV_SHAPES[7]):
        x, g = _bf16_input(rng, (1, h, h, c)), _bf16_input(rng, (1, h, h, o))
        w = _bf16_input(rng, (3, 3, c, o), 1 / math.sqrt(9 * c)).float()
        bias = torch.from_numpy(rng.standard_normal(o).astype(
            np.float32)).to(DEV)
        runs = {"fwd bf16": lambda: conv3x3s_fwd(x, w, bias, "reflect"),
                "fwd f32": lambda: conv3x3s_fwd(x, w, bias, "reflect",
                                                torch.float32),
                "dgrad reflect": lambda: conv3x3s_dgrad(g, w, "reflect"),
                "dgrad same": lambda: conv3x3s_dgrad(g, w, "same")}
        for what, fn in runs.items():
            if not torch.equal(fn(), fn()):
                raise AssertionError(f"conv3x3s {what} {c}->{o} @{h}: two "
                                     "runs differ")
        log(f"[kernels] conv3x3s {c}->{o} @{h}: forward (bf16, f32) and "
            "dgrad (reflect, same) bitwise equal over two runs (plans "
            f"fwd {k8a_plan(1, h, h, o, False)}, reflect dgrad "
            f"{k8a_plan(1, h, h, c, True)})")
        del x, g, w


# (K, N, T) of tools/tpu_probe_r5.py's section A (:108-146); M is 16 tiles
# of the rows that fit the probe's 13 MB VMEM model, as there
GEMM_SHAPES = [(64, 64, 9), (128, 64, 9), (192, 64, 9), (64, 128, 9),
               (128, 128, 9), (192, 128, 9), (256, 256, 9), (512, 512, 4)]


def kernels_conv3_odd(rng) -> None:
    """K3 (the forward in bf16 and f32, the dgrad) and K3b at odd C and O
    and an odd H under both pad modes, then at batch 2 on a 512^2 shape:
    each within its tolerance of its plain version, K3's forward and K3b
    twice bit-equal.  Run last in the phase, so the inputs of the checks
    before it are drawn as before it existed."""
    for c, o, h in CONV3_ODD:
        x = _bf16_input(rng, (1, h, h, c))
        g = _bf16_input(rng, (1, h, h, o))
        w = torch.from_numpy((rng.standard_normal((3, 3, c, o))
                              / np.sqrt(9 * c)).astype(np.float32)).to(DEV)
        bias = torch.from_numpy(rng.standard_normal(o).astype(
            np.float32)).to(DEV)
        for pm in ("reflect", "same"):
            conv3_check(f"{c}->{o} @{h} {pm}", x, g, w, bias, pm)
    c, o, h = CONV3_B2
    x = _bf16_input(rng, (2, h, h, c))
    g = _bf16_input(rng, (2, h, h, o))
    w = torch.from_numpy((rng.standard_normal((3, 3, c, o))
                          / np.sqrt(9 * c)).astype(np.float32)).to(DEV)
    bias = torch.from_numpy(rng.standard_normal(o).astype(np.float32)).to(DEV)
    conv3_check(f"batch 2 {c}->{o} @{h} reflect", x, g, w, bias, "reflect")
    torch.cuda.synchronize()
    log(f"[kernels] K3 / K3b at {CONV3_ODD} under both pads and at batch 2 "
        f"{CONV3_B2}: K3 (bf16 within 2^-7 of max, f32 and dgrad within "
        "1e-4; twice bit-equal) and K3b (within 1e-4, twice bit-equal) agree")


def conv3_check(tag: str, x, g, w, bias, pm: str) -> None:
    """K3 (bf16 and f32-out forward, the dgrad) and K3b against their
    plain versions at one shape and pad mode; K3's forward and K3b each
    bit-equal across two runs."""
    ky = conv3x3_fwd(x, w, bias, pm)
    _conv4_check(f"conv3x3 {tag}", ky, conv3x3_torch(x, w, bias, pm), 2 ** -7)
    if not torch.equal(ky, conv3x3_fwd(x, w, bias, pm)):
        raise AssertionError(f"conv3x3 {tag}: two runs differ")
    _conv4_check(f"conv3x3 f32 {tag}",
                 conv3x3_fwd(x, w, bias, pm, torch.float32),
                 conv3x3_torch(x.float(), w.to(torch.bfloat16).float(), bias,
                               pm), 1e-4)
    _conv4_check(f"conv3x3 dgrad {tag}", conv3x3_dgrad(g, w, pm),
                 conv3x3_dgrad_torch(g, w, pm), 1e-4)
    kw = conv3x3_wgrad(x, g, pm)
    _conv4_check(f"conv3x3_wgrad {tag}", kw, conv3x3_wgrad_torch(x, g, pm),
                 1e-4)
    if not torch.equal(kw, conv3x3_wgrad(x, g, pm)):
        raise AssertionError(f"conv3x3_wgrad {tag}: two runs differ")


def gemm_rows(k: int, n: int, taps: int) -> int:
    rows = 8320
    while (2 * rows * k * 2 + taps * k * n * 2 + rows * n * 4
           + 2 * rows * n * 2) > 13 * 1024 * 1024:
        rows //= 2
    return 16 * rows


def kernels_gemm_chain(rec: dict, launches: dict, rng) -> None:
    """P1 at section A's eight shapes: one launch per shape, counted (the
    kernel lies on no path of the package), against its plain version
    (bf16 within 2^-7 of max) and twice bit-equal (no split K); the median
    ms of the kernel, its plain version and cuBLAS's one product of x
    repeated T times along K [M, T K] with w as [T K, N] (the same
    function, summed in another order; its inputs built before the
    timing), and the bound; per shape also 20 calls queued back to back
    beside cuBLAS queued, the wrapper's host time and the TFLOP/s of the
    queued time."""
    from rnr_tpu_torch.ops.gemm_chain_cuda import gemm_chain_plan
    parts, errs, shapes, host = [], [], [], []
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "queued_ms": 0.0,
           "library_queued_ms": 0.0, "flops": 0.0}
    inputs = []
    for k, n, taps in GEMM_SHAPES:
        m = gemm_rows(k, n, taps)
        inputs.append((_bf16_input(rng, (m, k)),
                       _bf16_input(rng, (taps, k, n), 1 / math.sqrt(k * taps))))
    gemm_chain.launches = 0
    outs = [gemm_chain(x, w) for x, w in inputs]
    torch.cuda.synchronize()
    launches["gemm_chain"] = gemm_chain.launches
    if launches["gemm_chain"] != len(GEMM_SHAPES):
        raise AssertionError(f"gemm_chain launched {gemm_chain.launches} "
                             f"times for {len(GEMM_SHAPES)} shapes")
    for (k, n, taps), (x, w), y in zip(GEMM_SHAPES, inputs, outs):
        m = x.shape[0]
        tag = f"M {m} K {k} N {n} T {taps}"
        e = _conv4_check(f"gemm_chain {tag}", y, gemm_chain_torch(x, w),
                         2 ** -7)
        if not torch.equal(y, gemm_chain(x, w)):
            raise AssertionError(f"gemm_chain {tag}: two runs differ")
        errs.append(e)
        xr = x.repeat(1, taps)                 # [M, T K]
        wr = w.reshape(taps * k, n)            # [T K, N]
        ms = cuda_ms(lambda: gemm_chain(x, w))
        pms = cuda_ms(lambda: gemm_chain_torch(x, w), iters=3, warmup=1)
        lms = cuda_ms(lambda: torch.matmul(xr, wr))
        q, lq = queued_ms(lambda: gemm_chain(x, w)), queued_ms(
            lambda: torch.matmul(xr, wr))
        hu = host_us(lambda: gemm_chain(x, w))
        flops = 2.0 * m * k * n * taps
        work = bound(2 * (m * k + taps * k * n + m * n), flops,
                     BF16_TENSOR_FLOPS)
        parts.append(work)
        host.append(hu)
        plan = gemm_chain_plan(m, k, n, taps)
        shapes.append(dict(m=m, k=k, n=n, t=taps, ms=ms, library_ms=lms,
                           queued_ms=q, library_queued_ms=lq, host_us=hu,
                           tflops=flops / q / 1e9, plan=list(plan), **work))
        for key, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                       ("queued_ms", q), ("library_queued_ms", lq),
                       ("flops", flops)):
            tot[key] += v
        log(f"[kernels] gemm_chain {tag}: err {e:.3g}, two runs bitwise "
            f"equal; kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
            f"queued {q:.4f} ms ({flops / q / 1e9:.1f} TFLOP/s), host "
            f"{hu:.1f} us; bound {work['bound_ms']:.4f} "
            f"({work['bound_by']}); cuBLAS {lms:.4f}, queued {lq:.4f}; "
            f"plain {pms:.3f}; plan (bn, mw, res, xst, wst, grid) {plan}")
        del xr, wr
    flops = tot.pop("flops")
    rec["gemm_chain"] = dict(max_abs_err=max(errs), bitwise_reproducible=True,
                             **tot, host_us=float(np.mean(host)),
                             tflops=flops / tot["queued_ms"] / 1e9,
                             shapes=shapes, **add_bounds(parts))
    log(f"[kernels] gemm_chain, {len(GEMM_SHAPES)} shapes: {tot['ms']:.4f} "
        f"ms single ({tot['ms'] / tot['library_ms']:.2f}x cuBLAS "
        f"{tot['library_ms']:.4f}), {tot['queued_ms']:.4f} ms queued "
        f"({rec['gemm_chain']['tflops']:.1f} TFLOP/s; cuBLAS queued "
        f"{tot['library_queued_ms']:.4f}), host "
        f"{rec['gemm_chain']['host_us']:.1f} us a call")
    torch.cuda.synchronize()


def _bf16_input(rng, shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
        np.float32)).to(DEV, torch.bfloat16)


def _conv4_weight(rng, c, o):
    return torch.from_numpy((rng.standard_normal((4, 4, c, o))
                             / np.sqrt(16 * c)).astype(np.float32)).to(DEV)


def _conv4_check(name: str, k: torch.Tensor, t: torch.Tensor,
                 rel: float) -> float:
    """Max abs error of kernel output k against the plain t, held to rel
    x max |t|; returns the error."""
    if k.shape != t.shape or k.dtype != t.dtype:
        raise AssertionError(f"{name}: {tuple(k.shape)} {k.dtype} against "
                             f"{tuple(t.shape)} {t.dtype}")
    kf, tf = k.float(), t.float()
    e = float((kf - tf).abs().max())
    check(name, e, rel * float(tf.abs().max()))
    return e


def kernels_conv4(rec: dict, rng) -> None:
    """K6 (down4, convt4) and K8's 4x4 pair (down4s, convt4s) at the ten
    4x4 convs of a 512^2 frame, reflect padding, bf16 (forward: within
    2^-7 of max, one rounding step), and each kernel's f32 output as a
    data gradient at the shapes its use gives it (within 1e-4 of max):
    down4 / down4s on the transpose convs' output gradients (the main
    path's use), convt4 / convt4s on the down convs' (the "same" use); then
    odd C and O and an odd H.  Per kernel, as the launches of a b1 train
    step of its route (reflect): the median ms of the kernel, its plain
    version and one cuDNN call of the same function (F.conv2d at stride 2
    on the reflect-padded channels-last input; F.conv_transpose2d at
    stride 2, padding 1; for the dgrad use F.conv2d with padding 1), and
    the bound; for each of the four also 20 calls queued back to back,
    beside cuDNN's queued likewise, the wrapper's host time and the
    TFLOP/s of conv4_flops' count per shape and in total, and each
    bitwise equal over two runs at one large and one split-K shape.
    Then the pallas3 route's own 4x4 convs (the U-Net's Conv and
    ConvTranspose modules as the shipped step runs them)."""
    from rnr_tpu_torch.models.unet import Conv, ConvTranspose
    fwds = {"down4": down4_fwd, "down4s": down4s_fwd, "convt4": convt4_fwd,
            "convt4s": convt4s_fwd}
    keys = ("ms", "plain_ms", "library_ms", "dgrad_ms", "dgrad_plain_ms",
            "dgrad_library_ms")
    acc = {n: dict({k: 0.0 for k in keys}, errs=[], dgrad_errs=[], works=[],
                   dgrad_works=[]) for n in fwds}
    shipped = {"down": 0.0, "up": 0.0}
    queued = {n: dict(queued_ms=0.0, library_queued_ms=0.0, flops=0,
                      host=[], shapes=[]) for n in fwds}

    def queued_times(name, use, c, o, h, fn, lib_fn, flops):
        """A kernel's queued, host and TFLOP/s at one shape, cuDNN queued
        beside it; returns the log's words."""
        q, lq, hu = queued_ms(fn), queued_ms(lib_fn), host_us(fn)
        r = queued[name]
        r["queued_ms"] += q
        r["library_queued_ms"] += lq
        r["flops"] += flops
        r["host"].append(hu)
        r["shapes"].append(dict(use=use, c=c, o=o, h=h, queued_ms=q,
                                library_queued_ms=lq, host_us=hu,
                                tflops=flops / q / 1e9))
        return (f"queued {q:.4f} ms ({flops / q / 1e9:.1f} TFLOP/s; cuDNN "
                f"{lq:.4f}), host {hu:.1f} us")

    def add(name, part, err, ms, pms, lms, work):
        a = acc[name]
        pre = "dgrad_" if part == "dgrad" else ""
        a[pre + "errs"].append(err)
        a[pre + "ms"] += ms
        a[pre + "plain_ms"] += pms
        a[pre + "library_ms"] += lms
        a[pre + "works"].append(work)

    for c, o, h in DOWN4_SHAPES:
        x, w = _bf16_input(rng, (1, h, h, c)), _conv4_weight(rng, c, o)
        t = down4_torch(x, w, "reflect")
        xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
        wn = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        lms = cuda_ms(lambda: F.conv2d(xp, wn, stride=2))
        pms = cuda_ms(lambda: down4_torch(x, w, "reflect"), iters=3, warmup=1)
        line = []
        for name in ("down4", "down4s"):
            e = _conv4_check(f"{name} {c}->{o} @{h}", fwds[name](
                x, w, "reflect"), t, 2 ** -7)
            ms = cuda_ms(lambda: fwds[name](x, w, "reflect"))
            add(name, "fwd", e, ms, pms, lms, conv4_work(True, c, o, h, 2))
            line.append(f"{name} {ms:.4f} ms (err {e:.3g})")
            line.append(queued_times(
                name, "fwd", c, o, h,
                lambda: fwds[name](x, w, "reflect"),
                lambda: F.conv2d(xp, wn, stride=2),
                conv4_flops(True, c, o, h)))
        mod = Conv(c, o, 4, 2, use_bias=False, dtype=torch.bfloat16,
                   pad_mode="reflect", backend="pallas3").to(DEV)
        with torch.no_grad():
            mod.kernel.copy_(w)
            sms = cuda_ms(lambda: mod(x))
        shipped["down"] += sms
        # "same" use: the transpose convs' f32 output as this conv's dgrad
        g = _bf16_input(rng, (1, h // 2, h // 2, o))
        wd = w.flip(0, 1).transpose(2, 3)
        td = convt4_torch(g, wd, torch.float32)
        for name in ("convt4", "convt4s"):
            e = _conv4_check(f"{name} f32 (down dgrad) {o}->{c} @{h // 2}",
                             fwds[name](g, wd, torch.float32), td, 1e-4)
            acc[name].setdefault("same_dgrad_errs", []).append(e)
        wk = conv4_work(True, c, o, h, 2)
        log(f"[kernels] 4x4 down {c}->{o} @{h}: " + ", ".join(line)
            + f"; bound {wk['bound_ms']:.4f} ({wk['bound_by']}), cuDNN "
            f"{lms:.4f}, plain {pms:.3f}; pallas3 route's Conv {sms:.4f} ms")
        del x, t, xp, g, td

    for c, o, h in CONVT4_SHAPES:
        x, w = _bf16_input(rng, (1, h, h, c)), _conv4_weight(rng, c, o)
        t = convt4_torch(x, w)
        xn = x.permute(0, 3, 1, 2)
        kn = w.to(torch.bfloat16).flip(0, 1).permute(2, 3, 0, 1).contiguous(
            memory_format=torch.channels_last)
        lms = cuda_ms(lambda: F.conv_transpose2d(xn, kn, stride=2, padding=1))
        pms = cuda_ms(lambda: convt4_torch(x, w), iters=3, warmup=1)
        line = []
        for name in ("convt4", "convt4s"):
            e = _conv4_check(f"{name} {c}->{o} @{h}", fwds[name](x, w), t,
                             2 ** -7)
            ms = cuda_ms(lambda: fwds[name](x, w))
            add(name, "fwd", e, ms, pms, lms, conv4_work(False, c, o, h, 2))
            line.append(f"{name} {ms:.4f} ms (err {e:.3g})")
            line.append(queued_times(
                name, "fwd", c, o, h, lambda: fwds[name](x, w),
                lambda: F.conv_transpose2d(xn, kn, stride=2, padding=1),
                conv4_flops(False, c, o, h)))
        mod = ConvTranspose(c, o, use_bias=False, dtype=torch.bfloat16,
                            backend="pallas3").to(DEV)
        with torch.no_grad():
            mod.kernel.copy_(w)
            sms = cuda_ms(lambda: mod(x))
        shipped["up"] += sms
        # the main path's use: the down convs' f32 output as this conv's
        # dgrad, on the output gradient [1, 2h, 2h, o], "same" padding
        g = _bf16_input(rng, (1, 2 * h, 2 * h, o))
        wd = w.flip(0, 1).transpose(2, 3)
        td = down4_torch(g, wd, "same", torch.float32)
        gn = g.permute(0, 3, 1, 2)
        wdn = wd.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        dlms = cuda_ms(lambda: F.conv2d(gn, wdn, stride=2, padding=1))
        dpms = cuda_ms(lambda: down4_torch(g, wd, "same", torch.float32),
                       iters=3, warmup=1)
        for name in ("down4", "down4s"):
            e = _conv4_check(f"{name} f32 (convt dgrad) {o}->{c} @{2 * h}",
                             fwds[name](g, wd, "same", torch.float32), td,
                             1e-4)
            ms = cuda_ms(lambda: fwds[name](g, wd, "same", torch.float32))
            add(name, "dgrad", e, ms, dpms, dlms,
                conv4_work(True, o, c, 2 * h, 4))
            line.append(f"{name} f32 dgrad {ms:.4f} ms (err {e:.3g})")
            line.append(queued_times(
                name, "dgrad", o, c, 2 * h,
                lambda: fwds[name](g, wd, "same", torch.float32),
                lambda: F.conv2d(gn, wdn, stride=2, padding=1),
                conv4_flops(True, o, c, 2 * h)))
        wk = conv4_work(False, c, o, h, 2)
        log(f"[kernels] 4x4 transpose {c}->{o} @{h}: " + ", ".join(line)
            + f"; bound {wk['bound_ms']:.4f} ({wk['bound_by']}), cuDNN "
            f"{lms:.4f}, plain {pms:.3f}; pallas3 route's ConvTranspose "
            f"{sms:.4f} ms")
        del x, t, g, td

    # odd C and O, odd H: forward (bf16) and f32 output of all four
    for c, o, h in CONV4_ODD:
        x, w = _bf16_input(rng, (1, h, h, c)), _conv4_weight(rng, c, o)
        for pm in ("reflect", "same"):
            t = down4_torch(x, w, pm)
            for name in ("down4", "down4s"):
                _conv4_check(f"{name} {c}->{o} @{h} {pm}",
                             fwds[name](x, w, pm), t, 2 ** -7)
        t = convt4_torch(x, w)
        t32 = convt4_torch(x, w, torch.float32)
        d32 = down4_torch(x, w, "reflect", torch.float32)
        for name in ("convt4", "convt4s"):
            _conv4_check(f"{name} {c}->{o} @{h}", fwds[name](x, w), t,
                         2 ** -7)
            _conv4_check(f"{name} f32 {c}->{o} @{h}",
                         fwds[name](x, w, torch.float32), t32, 1e-4)
        for name in ("down4", "down4s"):
            _conv4_check(f"{name} f32 {c}->{o} @{h}",
                         fwds[name](x, w, "reflect", torch.float32), d32,
                         1e-4)
    torch.cuda.synchronize()
    log(f"[kernels] 4x4 odd shapes {CONV4_ODD}: all four kernels agree "
        "(bf16 within 2^-7 of max, f32 within 1e-4), both pad modes")
    conv4_bitwise()

    for name, a in acc.items():
        parts = a["works"] + a["dgrad_works"]
        r = dict(max_abs_err=max(a["errs"] + a["dgrad_errs"]),
                 ms=a["ms"] + a["dgrad_ms"],
                 plain_ms=a["plain_ms"] + a["dgrad_plain_ms"],
                 library_ms=a["library_ms"] + a["dgrad_library_ms"],
                 fwd_ms=a["ms"], fwd_plain_ms=a["plain_ms"],
                 fwd_library_ms=a["library_ms"],
                 fwd_bound_ms=add_bounds(a["works"])["bound_ms"],
                 **add_bounds(parts))
        if a["dgrad_works"]:
            r.update(dgrad_ms=a["dgrad_ms"],
                     dgrad_bound_ms=add_bounds(a["dgrad_works"])["bound_ms"],
                     dgrad_max_abs_err=max(a["dgrad_errs"]))
        if "same_dgrad_errs" in a:
            r["same_dgrad_max_abs_err"] = max(a["same_dgrad_errs"])
        if name in queued:
            q = queued[name]
            r.update(queued_ms=q["queued_ms"],
                     library_queued_ms=q["library_queued_ms"],
                     host_us=float(np.mean(q["host"])),
                     tflops=q["flops"] / q["queued_ms"] / 1e9,
                     shapes=q["shapes"])
            log(f"[kernels] {name}, {len(parts)} launches queued: "
                f"{q['queued_ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s), "
                f"cuDNN queued {q['library_queued_ms']:.4f} ms, host "
                f"{r['host_us']:.1f} us a call")
        rec[name] = r
        log(f"[kernels] {name}, {len(parts)} launches of a b1 train step: "
            f"kernel {r['ms']:.3f} ms (forward {r['fwd_ms']:.3f}), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), cuDNN "
            f"{r['library_ms']:.3f} ms, plain {r['plain_ms']:.3f} ms")
    rec["_pallas3_4x4"] = dict(down_ms=shipped["down"], up_ms=shipped["up"])
    log(f"[kernels] the pallas3 route's 4x4 convs of a frame (cuDNN through "
        f"the U-Net's modules, reflect pad included): downs "
        f"{shipped['down']:.3f} ms, transpose convs {shipped['up']:.3f} ms")
    torch.cuda.synchronize()


def conv4_bitwise() -> None:
    """K8's pair, then K6, twice on the same inputs, bf16 and f32 out, at
    one large and one split-K shape of each (their own seed): bitwise
    equal."""
    from rnr_tpu_torch.ops.conv4_cuda import conv4_plan, conv4s_plan
    rng = np.random.default_rng(10)
    cases = (("down4s", DOWN4_SHAPES[2]), ("down4s", DOWN4_SHAPES[4]),
             ("convt4s", CONVT4_SHAPES[3]), ("convt4s", CONVT4_SHAPES[0]),
             ("down4", DOWN4_SHAPES[2]), ("down4", DOWN4_SHAPES[4]),
             ("convt4", CONVT4_SHAPES[3]), ("convt4", CONVT4_SHAPES[0]))
    fwds = {"down4s": down4s_fwd, "convt4s": convt4s_fwd, "down4": down4_fwd,
            "convt4": convt4_fwd}
    for name, (c, o, h) in cases:
        x, w = _bf16_input(rng, (1, h, h, c)), _conv4_weight(rng, c, o)
        up = name.startswith("convt4")
        fwd = fwds[name]
        fn = ((lambda od: fwd(x, w, od)) if up
              else (lambda od: fwd(x, w, "reflect", od)))
        for od in (torch.bfloat16, torch.float32):
            if not torch.equal(fn(od), fn(od)):
                raise AssertionError(f"{name} {c}->{o} @{h} {od}: two runs "
                                     "differ")
        plan = conv4s_plan if name.endswith("s") else conv4_plan
        log(f"[kernels] {name} {c}->{o} @{h}: bitwise equal over two runs, "
            f"bf16 and f32 out (plan bn, wgs, sw, splits, per = "
            f"{plan(1, h, h, c, o, up)})")
        del x, w


# K4's feature widths in the kernels phase: the GCN's 64 first (its
# record), then the ragged and the widest the kernel takes
KNN_C = (64, 3, 130, 512)


def knn_case(x: torch.Tensor, tag: str) -> dict:
    """K4 against its plain version on x: picks equal except at near-ties
    (compare_picks: the two picks' scores in double within the sum of
    their f32 rounding bounds), and two runs bit-equal."""
    ki = stratified_knn(x, 16)
    k2 = stratified_knn(x, 16)
    ti = stratified_knn_torch(x, 16)
    torch.cuda.synchronize()
    r = compare_picks(x, ki, ti)
    if r["violations"]:
        raise AssertionError(f"stratified_knn {tag}: {len(r['violations'])} "
                             "picks differ from the plain version beyond "
                             f"f32 rounding, first {r['violations'][:3]}")
    if not torch.equal(ki, k2):
        raise AssertionError(f"stratified_knn {tag}: two runs differ")
    log(f"[kernels] stratified_knn {tag}: {ki.numel()} indices, "
        f"{r['differ']} differ from the plain version: {r['exact_ties']} "
        f"exact ties, {r['near_ties']} near-ties, largest gap "
        f"{r['worst_gap_over_bound']:.3g} of its bound; two runs bit-equal")
    return r


def kernels_knn(rec: dict, rng) -> None:
    """K4 at V 7500 and C 64 (the GCN's width; x from the phase's random
    stream), 3, 130 and 512 (each from its own seed), held to its plain
    version by compare_picks and bitwise across two runs; then duplicated
    vertices (rows 2m and 2m + 1 equal), where every pick must be the
    lower of the pair, bit for bit.  TFLOP/s of the 2 V^2 C products, the
    device time of calls queued back to back and the wrapper's host time
    per call beside the single-call median."""
    v = GCN_V
    x64 = torch.from_numpy(rng.standard_normal((v, 64)).astype(
        np.float32)).to(DEV)
    for c in KNN_C:
        x = x64 if c == 64 else torch.from_numpy(np.random.default_rng(
            c).standard_normal((v, c)).astype(np.float32)).to(DEV)
        r = knn_case(x, f"V{v} C{c}")
        ms = cuda_ms(lambda: stratified_knn(x, 16))
        q_ms = queued_ms(lambda: stratified_knn(x, 16))
        log(f"[kernels] stratified_knn V{v} C{c}: {ms:.4f} ms "
            f"({2 * v * v * c / ms / 1e9:.1f} TFLOP/s), queued "
            f"{q_ms:.4f} ms ({2 * v * v * c / q_ms / 1e9:.1f} TFLOP/s)")
        if c != 64:
            continue
        ns = -(-v // 16)
        rec["stratified_knn"] = dict(
            max_abs_err=float(len(r["violations"])), exact_ties=r["exact_ties"],
            near_ties=r["near_ties"],
            worst_gap_over_bound=r["worst_gap_over_bound"], ms=ms,
            queued_ms=q_ms, host_us=host_us(lambda: stratified_knn(x, 16)),
            plain_ms=cuda_ms(lambda: stratified_knn_torch(x, 16)),
            library_ms=None,
            # the kernel reads x in bf16 and writes int32 indices; its 2
            # V^2 C score operations are bf16 products (exact in f32) with
            # f32 sums, the work of a bf16 tensor-core GEMM, so bound at
            # that unit's peak
            **bound(v * c * 2 + v * ns * 4, 2 * v * v * c, BF16_TENSOR_FLOPS))
    half = np.random.default_rng(7).standard_normal((v // 2, 64)).astype(
        np.float32)
    xd = torch.from_numpy(np.repeat(half, 2, axis=0)).to(DEV)
    knn_case(xd, f"V{v} C64 duplicated vertices")
    kd = stratified_knn(xd, 16)
    if not bool((kd % 2 == 0).all()):
        raise AssertionError("stratified_knn: a tie between duplicated "
                             "vertices did not go to the lower index")
    plain_even = bool((stratified_knn_torch(xd, 16) % 2 == 0).all())
    log("[kernels] stratified_knn duplicated vertices: every pick the lower "
        f"of its pair (the plain version's too: {plain_even})")
    torch.cuda.synchronize()


def ring_faces(n_lat: int, n_lon: int, elevation: float, views, s: int):
    """The UV sphere's faces [N, F, 3, 3] in NDC from views of the camera
    ring, on the card."""
    from rnr_tpu_torch.ops.gbuffer import make_mesh_buffers, project_faces
    from rnr_tpu_torch.synthetic import camera_ring, sphere_mesh
    mb = make_mesh_buffers(sphere_mesh(n_lat, n_lon))
    ring = camera_ring(s, elevation_deg=elevation)

    def host(k):
        return torch.from_numpy(np.stack([ring[i][k] for i in views])).to(DEV)

    return project_faces(mb, host("proj"), host("pose"), host("dist_coeffs"),
                         None, None, s)[1]


def overflow_faces() -> torch.Tensor:
    """rnr_tpu's overflow case: 8 faces over the whole 32^2 screen at
    depths 1..2 (tests/test_rasterize_pallas.py:52)."""
    faces = np.zeros((1, 8, 3, 3), np.float32)
    faces[..., :2] = np.array([[-0.9, -0.9], [0.9, -0.9], [0.0, 0.9]])
    faces[..., 2] = np.linspace(1, 2, 8)[None, :, None]
    return torch.from_numpy(faces).to(DEV)


def degenerate_faces_512() -> torch.Tensor:
    """synthetic.degenerate_faces at 512^2 among 600 random faces, on the
    card (its own seed)."""
    from rnr_tpu_torch.synthetic import degenerate_faces, random_faces
    rng = np.random.default_rng(14)
    faces = np.concatenate([degenerate_faces(rng, IMG),
                            random_faces(rng, 1, 600)], 1)
    return torch.from_numpy(faces).to(DEV)


def kernels_raster(rec: dict) -> None:
    """K7 against its plain version on the card, bit for bit (face index
    and depth), and the card's binning against the CPU's (ids, counts,
    overflow).  The first case is the G-buffer phase's: its times and
    bound go into the record."""
    lat, lon = MESH_LAT_LON
    worst45 = ring_faces(128, 192, 45.0, range(N_VIEWS), IMG)
    ov45 = bin_faces(worst45, IMG, 32, 128, 2048)[3]
    v45 = int(torch.argmax(ov45))
    del worst45
    cases = [
        (f"{2 * lon * (lat - 1)} faces, 30 deg (G-buffer phase)",
         ring_faces(lat, lon, 30.0, [0], IMG), IMG, 2048, "zero"),
        ("48768 faces, 0 deg", ring_faces(128, 192, 0.0, [0], IMG), IMG,
         2048, None),
        (f"48768 faces, 45 deg, view {v45}, cap 2048",
         ring_faces(128, 192, 45.0, [v45], IMG), IMG, 2048, "positive"),
        ("12096 faces, 30 deg, N = 2", ring_faces(64, 96, 30.0, [0, 5], IMG),
         IMG, 2048, "zero"),
        ("8 faces over 32^2, cap 4", overflow_faces(), 32, 4, 4),
        ("degenerate and random faces at the edge of the cull's "
         "exactness", degenerate_faces_512(), IMG, 2048, "zero"),
    ]
    for i, (name, faces, s, cap, want_ov) in enumerate(cases):
        th, tw = min(32, s), min(128, s)
        binned = bin_faces(faces, s, th, tw, cap)
        table, ids, counts, ov = binned
        kd, ki = rasterize_tiles(table, ids, counts, s, th, tw)
        td, ti = rasterize_tiles_torch(table, ids, counts, s, th, tw)
        cpu = bin_faces(faces.cpu(), s, th, tw, cap)
        torch.cuda.synchronize()
        n_idx = int((ki != ti).sum())
        err = float((kd - td).abs().max())
        if n_idx or not torch.equal(kd, td):
            raise AssertionError(f"rasterize_tiles {name}: {n_idx} face "
                                 f"indices differ, depth max err {err}")
        for what, a, c in zip(("table", "ids", "counts", "overflow"), binned,
                              cpu):
            # NaN where a vertex is NaN: equal as NaN, whatever its bits
            a, nan = a.cpu(), c.isnan()
            if not (torch.equal(a.isnan(), nan)
                    and torch.equal(a[~nan], c[~nan])):
                raise AssertionError(f"bin_faces {name}: {what} differs "
                                     "between the card and the CPU")
        ovl = ov.tolist()
        if ((want_ov == "zero" and any(ovl))
                or (want_ov == "positive" and not all(ovl))
                or (isinstance(want_ov, int) and ovl != [want_ov])):
            raise AssertionError(f"rasterize_tiles {name}: overflow {ovl}, "
                                 f"expected {want_ov}")
        def k7():
            return rasterize_tiles(table, ids, counts, s, th, tw)
        ms, q_ms, h_us = cuda_ms(k7), queued_ms(k7), host_us(k7)
        plain_ms = cuda_ms(lambda: rasterize_tiles_torch(
            table, ids, counts, s, th, tw), iters=3, warmup=1)
        bin_ms = cuda_ms(lambda: bin_faces(faces, s, th, tw, cap), iters=5)
        work = raster_work(table, ids, counts, ki, th, tw, s)
        cull = cull_counts(table, ids, counts, s, th, tw)
        log(f"[kernels] rasterize_tiles {name}: {s}^2, N {faces.shape[0]}, "
            f"{cull['candidates']} candidates (largest tile "
            f"{cull['largest_list']}), overflow {ovl}; bitwise equal to the "
            f"plain version, binning equal to the CPU's; kernel {ms:.4f} ms "
            f"single, {q_ms:.4f} queued, host {h_us:.1f} us, bound "
            f"{work['bound_ms']:.6f} ({work['bound_by']}; "
            f"{work['inside_pairs']} inside (pixel, candidate) pairs), "
            f"bound over every listed pair "
            f"{work['listed_pairs_bound_ms']:.4f} "
            f"({work['listed_pairs_bound_by']}; "
            f"{cull['candidates'] * th * tw} pairs, no floor under the "
            f"cull), plain {plain_ms:.3f}, binning {bin_ms:.3f} ms")
        log(f"[kernels] rasterize_tiles {name}: the cull keeps "
            f"{cull['block_pairs']} (block, candidate) pairs (largest block "
            f"{cull['largest_block']}), the warps walk "
            f"{cull['warp_pairs']} (warp, candidate) pairs, "
            f"{cull['pixel_pairs']} (pixel, candidate) pairs")
        if i == 0:
            rec["rasterize_tiles"] = dict(
                max_abs_err=err, idx_mismatches=n_idx, ms=ms, queued_ms=q_ms,
                host_us=h_us, plain_ms=plain_ms, library_ms=None,
                bin_ms=bin_ms, largest_tile=cull["largest_list"], cull=cull,
                **work)
    torch.cuda.synchronize()


def phase_kernels(rec: dict, launches: dict) -> None:
    rng = np.random.default_rng(0)
    b = _gbuffer(IMG)
    kernels_sh(rec, b, rng)
    kernels_shade(rec, b)
    kernels_texture(rec, b, rng)
    kernels_conv(rec, rng)
    kernels_conv4(rec, rng)
    kernels_gemm_chain(rec, launches, rng)
    kernels_knn(rec, rng)
    kernels_raster(rec)
    kernels_conv3_odd(rng)
    for name, r in rec.items():
        if name.startswith("_"):
            continue
        log(f"[kernels] {name}: kernel {r['ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
            f"{r['plain_ms']:.3f} ms, library "
            + ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.3f} ms"))


def override(cfg, **sections):
    """`cfg` with fields of its sections replaced: section=dict(...)."""
    return dataclasses.replace(cfg, **{
        k: dataclasses.replace(getattr(cfg, k), **v)
        for k, v in sections.items() if v})


def canonical_config(img: int = IMG, rays: dict | None = None,
                     render_net: dict | None = None, **gcn):
    """The canonical configuration; `rays`, `render_net` and `gcn`
    override fields of those sections."""
    from rnr_tpu_torch.synthetic import build_config
    cfg = build_config(img_size=img, tex_size=512, lmax=10, nf0=64,
                       num_down=5, gcn_blocks=20, num_azi=6, num_polar=2,
                       num_sample=4096)
    return override(cfg, gcn=gcn, rays=rays, render_net=render_net)


def variant(model, rays: dict | None = None, device=None,
            render_net: dict | None = None):
    """A model of `model`'s configuration with the `rays` and
    `render_net` overrides and its weights (and buffers), on `device`
    (the card when None)."""
    from rnr_tpu_torch.models.rnr import RNRModel
    device = DEV if device is None else device
    cfg = override(model.cfg, rays=rays, render_net=render_net)
    out = RNRModel(cfg, GCN_V, device=device)
    out.load_state_dict({k: v.to(device)
                         for k, v in model.state_dict().items()})
    return out


def phase_slice(eval_launches: dict) -> dict:
    from rnr_tpu_torch.models.rnr import RNRModel
    from rnr_tpu_torch.synthetic import init_weights
    from rnr_tpu_torch.train.steps import make_rnr_eval_step
    model = init_weights(RNRModel(canonical_config(), GCN_V), seed=0)
    if model.lighting.coeff.device != DEV:
        raise AssertionError("RNRModel did not build on the card")
    b = _gbuffer(IMG)
    step = make_rnr_eval_step(model)
    frames = 3
    reset_launches()
    with torch.inference_mode():
        vf = model.compute_v_feature(b["gcn_pos"])
    k4_gcn = stratified_knn.launches
    outs = [step(b, v_feature=vf)["img"] for _ in range(frames)]
    torch.cuda.synchronize()
    eval_launches.update(read_launches())
    log(f"[slice] launches in v_feature + {frames} frames: {eval_launches}")
    if k4_gcn != 17:
        raise AssertionError(f"K4 launched {k4_gcn} times per GCN forward, "
                             "expected 17")
    if eval_launches["conv3x3"] != 14 * frames:
        raise AssertionError(f"K3 launched {eval_launches['conv3x3']} times "
                             f"in {frames} frames, expected {14 * frames}")
    for name in ("sh_shade_fan", "mipmap_gather"):
        if eval_launches[name] < frames:
            raise AssertionError(f"{name} launched {eval_launches[name]} "
                                 f"times in {frames} frames")
    for name in ("sh_shade_fan_bwd", "mipmap_scatter", "conv3x3_wgrad"):
        if eval_launches[name]:
            raise AssertionError(f"{name} launched under inference_mode")
    img = outs[-1].float()
    if img.shape != (1, IMG, IMG, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"image {tuple(img.shape)} not finite")
    inside = b["alpha_map"][..., 0] > 0
    std = float(img[inside].std())
    if not std > 1e-4:
        raise AssertionError(f"image constant over the object (std {std})")
    if not bool(torch.equal(outs[0], outs[-1])):
        raise AssertionError("eval frames of one input differ")
    log(f"[slice] image {tuple(img.shape)} finite, std over object "
        f"{std:.4g}, mean {float(img[inside].mean()):.4g}")

    with torch.inference_mode():
        gcn_ms = cuda_ms(lambda: model.compute_v_feature(b["gcn_pos"]),
                         iters=5, warmup=1)
        n = 20
        for _ in range(3):
            step(b, v_feature=vf)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step(b, v_feature=vf)
        torch.cuda.synchronize()
        fps = n / (time.perf_counter() - t0)
        frame_ms = cuda_ms(lambda: step(b, v_feature=vf), iters=10)
    log(f"[slice] GCN forward (v_feature, V 7500, 20 blocks): {gcn_ms:.3f} ms "
        f"(with K4's earlier FMA design: {GCN_MS_FMA_K4} ms)")
    log(f"[slice] eval frames/s at {IMG}^2 (cached v_feature): {fps:.3f}; "
        f"frame {frame_ms:.3f} ms by CUDA events")
    return {"model": model, "v_feature": vf, "gcn_pos": b["gcn_pos"],
            "batch": b, "img": img}


def slice_routes(state: dict, route_launches: dict, frames: int = 3) -> None:
    """Eval frames of the slice's model under the U-Net's conv routes
    "pallas" (K3 + K6), "p3s4" (K3 + K8's 4x4 pair), "slab3" (K8a) and
    "slab" (K8a + K8's 4x4 pair), same weights and v_feature: the launches per frame, a finite image near the shipped
    route's (the same function in bf16: held as the parity phase holds the
    card to the CPU), frames/s and frame ms."""
    from rnr_tpu_torch.train.steps import make_rnr_eval_step
    model, vf, b, shipped = (state[k] for k in ("model", "v_feature",
                                                "batch", "img"))
    inside = b["alpha_map"][..., 0] > 0
    for route, want in ROUTE_FRAME_LAUNCHES.items():
        m = variant(model, render_net=dict(conv_backend=route))
        step = make_rnr_eval_step(m)
        step(b, v_feature=vf)          # warm-up: allocator, first launches
        torch.cuda.synchronize()
        reset_launches()
        outs = [step(b, v_feature=vf)["img"] for _ in range(frames)]
        torch.cuda.synchronize()
        got = read_launches()
        route_launches[route] = got
        log(f"[slice] {route} route: launches in {frames} frames: {got}")
        for name, n in want.items():
            if got[name] != n * frames:
                raise AssertionError(f"{route} route: {name} launched "
                                     f"{got[name]} times in {frames} "
                                     f"frames, expected {n * frames}")
        img = outs[-1].float()
        if img.shape != (1, IMG, IMG, 3) or not bool(
                torch.isfinite(img).all()):
            raise AssertionError(f"{route} route: image {tuple(img.shape)} "
                                 "not finite")
        std = float(img[inside].std())
        if not std > 1e-4:
            raise AssertionError(f"{route} route: image constant over the "
                                 f"object (std {std})")
        scale = float(shipped.abs().max())
        d = (img - shipped).abs()
        err, mean = float(d.max()), float(d.mean())
        log(f"[slice] {route} route vs the shipped route's frame: max abs "
            f"diff {err:.4g} (rel {err / scale:.3g}), mean {mean:.4g} "
            f"(rel {mean / scale:.3g})")
        check(f"{route} route vs shipped max", err, 5e-2 * scale)
        check(f"{route} route vs shipped mean", mean, 5e-3 * scale)
        with torch.inference_mode():
            n = 20
            for _ in range(3):
                step(b, v_feature=vf)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                step(b, v_feature=vf)
            torch.cuda.synchronize()
            fps = n / (time.perf_counter() - t0)
            frame_ms = cuda_ms(lambda: step(b, v_feature=vf), iters=10)
        log(f"[slice] {route} route: eval frames/s at {IMG}^2 (cached "
            f"v_feature): {fps:.3f}; frame {frame_ms:.3f} ms by CUDA events")
        with torch.inference_mode():
            profile_window(f"frame, {route} route",
                           lambda: step(b, v_feature=vf), 1, top=8)
        del m, step, outs
        torch.cuda.empty_cache()


def profile_window(name: str, fn, n: int, top: int = 12,
                   warm: bool = True) -> float:
    """torch.profiler over n runs of fn (after one untraced run when
    `warm`): device time by kernel, and the share of the traced window
    the device was busy (sum of kernel times over first kernel start to
    last kernel end).  Returns the kernel time per run in ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    span = (max(e.time_range.end for e in kern)
            - min(e.time_range.start for e in kern)) / 1e3
    log(f"[profile] {name} x{n}: kernels {busy:.3f} ms in a "
        f"{span:.3f} ms window: device busy {100 * busy / span:.1f}%, "
        f"idle {100 * (1 - busy / span):.1f}%")
    ka = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    for e in sorted(ka, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile]   {e.self_device_time_total / 1e3 / n:8.3f} "
            f"ms/run  x{e.count // n:<4d} {e.key[:100]}")
    return busy / n


def profile_slice(state: dict) -> None:
    from torch.profiler import ProfilerActivity, profile

    from rnr_tpu_torch.train.steps import make_rnr_eval_step
    model, vf = state["model"], state["v_feature"]
    b = _gbuffer(IMG)
    step = make_rnr_eval_step(model)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device=DEV).add_(1)   # the first trace pays CUPTI
        torch.cuda.synchronize()             # set-up
    with torch.inference_mode():
        profile_window("gcn", lambda: model.compute_v_feature(b["gcn_pos"]),
                       1)
        profile_window("frame", lambda: step(b, v_feature=vf), 5)


def _finite_maps(gb: dict, tag: str) -> None:
    for k, v in gb.items():
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{tag}: G-buffer map {k} not finite")


def phase_gbuffer(state: dict, view_launches: dict) -> None:
    """Inference from a mesh: per view of the ring, the G-buffer (K7) and
    the eval frame with the slice's model and cached v_feature."""
    from rnr_tpu_torch.drivers import test_rnr
    from rnr_tpu_torch.ops.gbuffer import (make_mesh_buffers, project_faces,
                                           render_gbuffer, render_raster)
    from rnr_tpu_torch.synthetic import camera_ring, sphere_mesh
    from rnr_tpu_torch.train.steps import make_rnr_eval_step
    # the G-buffer's f32 products (torch.linalg.inv, any matmul) in full
    # f32: TF32 off, as phase_device already set
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, vf, gcn_pos = state["model"], state["v_feature"], state["gcn_pos"]
    step = make_rnr_eval_step(model)
    lat, lon = MESH_LAT_LON
    mesh = sphere_mesh(lat, lon)
    mb = make_mesh_buffers(mesh)
    if mb.vertices.device != DEV:
        raise AssertionError("make_mesh_buffers did not build on the card")
    views = camera_ring(IMG, n_views=N_VIEWS)

    def frame(view):
        gb = test_rnr._gbuffer(render_gbuffer, mb, view, IMG)
        return gb, step(test_rnr._to_batch(gb, gcn_pos), v_feature=vf)["img"]

    frame(views[0])          # warm-up: allocator, first launches
    torch.cuda.synchronize()
    reset_launches()
    outs, per_view = [], []
    for v in views:
        before = read_launches()
        outs.append(frame(v))
        per_view.append({k: n - before[k] for k, n in read_launches().items()})
    torch.cuda.synchronize()
    view_launches.update(read_launches())
    log(f"[gbuffer] launches in {N_VIEWS} views (G-buffer + frame): "
        f"{view_launches}")
    for i, got in enumerate(per_view):
        for name, want in VIEW_LAUNCHES.items():
            if got[name] != want:
                raise AssertionError(f"view {i}: {name} launched "
                                     f"{got[name]} times, expected {want}")
        for name in VIEW_AT_LEAST_ONE:
            if got[name] < 1:
                raise AssertionError(f"view {i}: {name} not launched")

    # per view: overflow, coverage, finite maps and image, the tile lists
    covs, stds, largest = [], [], []
    for i, ((gb, img), view) in enumerate(zip(outs, views)):
        tag = f"view {i}"
        ov = int(gb["raster_overflow"][0])
        cov = float(gb["alpha_map"].mean())
        if ov:
            raise AssertionError(f"{tag}: raster overflow {ov}")
        if not 0.3 <= cov <= 0.9:
            raise AssertionError(f"{tag}: coverage {cov:.3f}")
        _finite_maps(gb, tag)
        img = img.float()
        if img.shape != (1, IMG, IMG, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{tag}: image {tuple(img.shape)} not finite")
        inside = gb["alpha_map"][0] > 0
        std = float(img[0][inside].std())
        if not std > 1e-4:
            raise AssertionError(f"{tag}: image constant over the object "
                                 f"(std {std})")
        faces = project_faces(mb, *(torch.from_numpy(view[k][None]).to(DEV)
                                    for k in ("proj", "pose", "dist_coeffs")),
                              None, None, IMG)[1]
        largest.append(int(bin_faces(faces, IMG, min(32, IMG), min(128, IMG),
                                     2048)[2].max()))
        covs.append(cov)
        stds.append(std)
    log(f"[gbuffer] {N_VIEWS} views of the {len(mesh.f_v_idx)}-face sphere "
        f"at {IMG}^2: overflow 0 in every view; coverage "
        f"{min(covs):.4f}..{max(covs):.4f}; image finite, std over the "
        f"object {min(stds):.4g}..{max(stds):.4g}; largest tile candidate "
        f"count per view {largest} (max {max(largest)} of 2048)")
    del outs

    with torch.inference_mode():
        for v in views[:3]:
            frame(v)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for v in views:
            frame(v)
        torch.cuda.synchronize()
        vps = N_VIEWS / (time.perf_counter() - t0)
        gb_ms = cuda_ms(lambda: test_rnr._gbuffer(render_gbuffer, mb, views[0],
                                                IMG), iters=10)
        raster_ms = cuda_ms(lambda: test_rnr._gbuffer(render_raster, mb,
                                                    views[0], IMG), iters=10)
        view_ms = cuda_ms(lambda: frame(views[0]), iters=10)
    log(f"[gbuffer] {vps:.3f} views/s at {IMG}^2 (host clock, G-buffer + "
        f"frame, {N_VIEWS} views); by CUDA events: G-buffer {gb_ms:.3f} ms, "
        f"raster only (render_raster) {raster_ms:.3f} ms, view "
        f"{view_ms:.3f} ms")
    with torch.inference_mode():
        profile_window("view (G-buffer + frame)", lambda: frame(views[0]), 1,
                       top=16)
        profile_window("G-buffer", lambda: test_rnr._gbuffer(
            render_gbuffer, mb, views[0], IMG), 1, top=10)
    gbuffer_card_vs_cpu(test_rnr, make_mesh_buffers, render_gbuffer,
                        camera_ring, sphere_mesh)


def gbuffer_card_vs_cpu(test_rnr, make_mesh_buffers, render_gbuffer,
                        camera_ring, sphere_mesh) -> None:
    """The 12,096-face sphere's G-buffer at 128^2, card (K7) against CPU
    (its plain version), two views.  Both sides run the same elementwise
    f32 arithmetic (TF32 off), so the face index maps agree but for
    depth ties within an ulp; on agreeing pixels uv / normal / position
    agree to 1e-5 and TBN to 1e-4.  At 128^2 a 32 x 128 tile spans the
    width, and this mesh overflows the default cap by about a hundred
    candidates: the same ones on both sides."""
    mesh = sphere_mesh(64, 96)
    mbc, mbh = make_mesh_buffers(mesh), make_mesh_buffers(mesh, "cpu")
    torch.set_num_threads(os.cpu_count() or 1)
    for vi in (0, 7):
        view = camera_ring(128)[vi]
        gc = test_rnr._gbuffer(render_gbuffer, mbc, view, 128)
        t0 = time.perf_counter()
        gh = test_rnr._gbuffer(render_gbuffer, mbh, view, 128)
        cpu_s = time.perf_counter() - t0
        fc = gc["face_index_map"].cpu()
        agree = fc == gh["face_index_map"]
        share = float(agree.float().mean())
        if share < 0.9999:
            raise AssertionError(f"card vs CPU 128^2 view {vi}: face index "
                                 f"agrees on {share:.6f} of pixels")
        if not torch.equal(gc["raster_overflow"].cpu(), gh["raster_overflow"]):
            raise AssertionError(f"card vs CPU 128^2 view {vi}: overflow "
                                 "differs")
        errs = {}
        for k, tol in (("uv_map", 1e-5), ("normal_map", 1e-5),
                       ("position_map", 1e-5), ("TBN_map", 1e-4)):
            d = (gc[k].cpu() - gh[k]).abs().reshape(agree.shape + (-1,))
            errs[k] = float(d[agree].max())
            check(f"card vs CPU G-buffer {k}", errs[k], tol)
        log(f"[gbuffer] card vs CPU at 128^2, view {vi}, 12096 faces: face "
            f"index agrees on {share:.6f} of pixels; on those, max abs err "
            + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
            + f" (tol 1e-5, TBN 1e-4); overflow card "
            f"{gc['raster_overflow'].tolist()} cpu "
            f"{gh['raster_overflow'].tolist()}; CPU G-buffer {cpu_s:.2f} s")


def phase_relight(state: dict, relight_launches: dict) -> None:
    """Relighting from a mesh (rnr_tpu's test_rnr per view and lighting):
    the slice's model and v_feature, N_PROBES procedural probes, the
    gbuffer phase's 20 views, one frame per view, probe and route."""
    from rnr_tpu_torch.drivers import test_rnr
    from rnr_tpu_torch.ops.gbuffer import make_mesh_buffers, render_gbuffer
    from rnr_tpu_torch.synthetic import camera_ring, make_probes, sphere_mesh
    from rnr_tpu_torch.train.steps import make_rnr_eval_step
    model, vf, gcn_pos = state["model"], state["v_feature"], state["gcn_pos"]
    probes = make_probes(N_PROBES, seed=0)
    lights = {True: test_rnr.lightings(model, probes, lp_sh=True),
              False: test_rnr.lightings(model, probes, lp_sh=False)}
    fit_ms = cuda_ms(lambda: test_rnr.lightings(model, probes, lp_sh=True),
                     iters=5)
    models = {r: (variant(model, rays) if rays else model)
              for r, (rays, _, _) in RELIGHT_ROUTES.items()}
    steps = {r: make_rnr_eval_step(m) for r, m in models.items()}
    mb = make_mesh_buffers(sphere_mesh(*MESH_LAT_LON))
    views = camera_ring(IMG, n_views=N_VIEWS)

    def batch_of(view):
        return test_rnr._to_batch(test_rnr._gbuffer(render_gbuffer, mb, view,
                                                    IMG), gcn_pos)

    def frame(route, batch, lp, sh):
        return test_rnr.relit_frame(steps[route], batch, lp, sh, vf,
                                    save_lp_background=True)

    b0 = batch_of(views[0])
    for route, (_, fit, _) in RELIGHT_ROUTES.items():   # warm-up
        frame(route, b0, *lights[fit][0][1:])
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    finite, stds = [], {r: [] for r in RELIGHT_ROUTES}
    for i, view in enumerate(views):
        batch = batch_of(view)
        inside = batch["alpha_map"][0, ..., 0] > 0
        for route, (_, fit, want) in RELIGHT_ROUTES.items():
            for name, lp, sh in lights[fit]:
                before = read_launches()
                img = frame(route, batch, lp, sh)
                got = {k: n - before[k] for k, n in read_launches().items()}
                for k, n in want.items():
                    if got[k] != n:
                        raise AssertionError(
                            f"relight view {i} {route} {name}: {k} launched "
                            f"{got[k]} times, expected {n}")
                if got["sh_shade_fan_bwd"] or got["sh_shade_bwd"]:
                    raise AssertionError("a backward kernel launched in "
                                         "inference")
                if img.shape != (IMG, IMG, 3):
                    raise AssertionError(f"relit image {tuple(img.shape)}")
                finite.append(torch.isfinite(img).all())
                stds[route].append(img[inside].std())
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    relight_launches.update(read_launches())
    if not bool(torch.stack(finite).all()):
        raise AssertionError("relight: an image is not finite")
    n_frames = N_VIEWS * N_PROBES
    log(f"[relight] launches in {N_VIEWS} views x {N_PROBES} probes x "
        f"{len(RELIGHT_ROUTES)} routes (G-buffer once per view): "
        f"{relight_launches}")
    for route, s in stds.items():
        lo = float(torch.stack(s).min())
        if not lo > 1e-4:
            raise AssertionError(f"relight {route}: an image is constant "
                                 f"over the object (std {lo})")
    log(f"[relight] {len(finite)} frames finite, launches per frame as "
        f"expected ({ {r: w for r, (_, _, w) in RELIGHT_ROUTES.items()} }); "
        f"std over the object: "
        + ", ".join(f"{r} {float(torch.stack(s).min()):.4g}.."
                    f"{float(torch.stack(s).max()):.4g}"
                    for r, s in stds.items())
        + f"; {N_VIEWS} views (G-buffer + {len(finite) // N_VIEWS} frames "
        f"each) in {loop_s:.3f} s, {N_VIEWS / loop_s:.3f} relit views/s")
    log(f"[relight] fit_sh of {N_PROBES} probes (LightingLP from the "
        f"256x512 probes, fit to lmax 10, bands reconciled): {fit_ms:.3f} ms "
        f"by CUDA events")

    batches = [batch_of(v) for v in views]
    with torch.inference_mode():
        for route, (_, fit, _) in RELIGHT_ROUTES.items():
            lp, sh = lights[fit][0][1:]
            ms = cuda_ms(lambda: frame(route, b0, lp, sh), iters=10)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for batch in batches:
                for _, lp_, sh_ in lights[fit]:
                    frame(route, batch, lp_, sh_)
            torch.cuda.synchronize()
            fps = n_frames / (time.perf_counter() - t0)
            log(f"[relight] {route}: frame {ms:.3f} ms by CUDA events, "
                f"{fps:.3f} frames/s by host clock ({n_frames} frames, "
                f"G-buffers ready)")
    with torch.inference_mode():
        lp, sh = lights[False][0][1:]
        profile_window("relit frame, probe route",
                       lambda: frame("probe", b0, lp, sh), 1, top=10)
    del batches
    relight_card_vs_cpu(models, lights, vf)


def relight_card_vs_cpu(models: dict, lights: dict, vf) -> None:
    """One 128^2 relit frame per route on the card against the CPU (plain
    versions), the synthetic G-buffer, the card's v_feature and lightings;
    and the CPU's SH fit of the probes against the card's."""
    from rnr_tpu_torch.drivers import test_rnr
    from rnr_tpu_torch.synthetic import build_batch, make_probes, to_torch
    from rnr_tpu_torch.train.steps import make_rnr_eval_step
    torch.set_num_threads(os.cpu_count() or 1)
    nb = build_batch(128, GCN_V)
    bc, bh = to_torch(nb, DEV), to_torch(nb, "cpu")
    cpu = {r: variant(m, {}, "cpu") for r, m in models.items()}
    fit_c = test_rnr.lightings(cpu["sh"], make_probes(N_PROBES, seed=0))
    for (_, _, a), (_, _, r) in zip(lights[True], fit_c):
        e = float((a.cpu() - r).abs().max())
        # f32 sums over 4096 samples in another order on the card
        check("fit_sh card vs cpu", e, 1e-4 * float(r.abs().max()))
    log(f"[relight] fit_sh card vs CPU: coefficients agree to 1e-4 of max")
    for route, (_, fit, _) in RELIGHT_ROUTES.items():
        _, lp, sh = lights[fit][0]
        a = test_rnr.relit_frame(make_rnr_eval_step(models[route]), bc, lp,
                                 sh, vf, save_lp_background=True).cpu()
        t0 = time.perf_counter()
        r = test_rnr.relit_frame(
            make_rnr_eval_step(cpu[route]), bh, lp.cpu(),
            None if sh is None else sh.cpu(), vf.cpu(),
            save_lp_background=True)
        cpu_s = time.perf_counter() - t0
        scale = float(r.abs().max())
        d = (a - r).abs()
        err, mean = float(d.max()), float(d.mean())
        # the bf16 U-Net, as the parity phase
        log(f"[relight] card vs CPU 128^2 {route}: max abs err {err:.4g} "
            f"(rel {err / scale:.3g}, tol 5e-2), mean {mean:.4g} (rel "
            f"{mean / scale:.3g}, tol 5e-3); CPU frame {cpu_s:.1f} s")
        check(f"relight parity {route} max", err, 5e-2 * scale)
        check(f"relight parity {route} mean", mean, 5e-3 * scale)


def phase_parity(state: dict) -> None:
    """The slice's model at 128^2 under the shipped route and each conv
    route: card (kernels) vs CPU (plain versions), both from the card's
    v_feature."""
    model, vf = state["model"], state["v_feature"]
    from rnr_tpu_torch.synthetic import build_batch, to_torch
    from rnr_tpu_torch.train.steps import make_rnr_eval_step
    nb = build_batch(128, GCN_V)
    bc, bh = to_torch(nb, DEV), to_torch(nb, "cpu")
    torch.set_num_threads(os.cpu_count() or 1)
    for route in ("pallas3", *ROUTE_FRAME_LAUNCHES):
        card = (model if route == model.cfg.render_net.conv_backend
                else variant(model, render_net=dict(conv_backend=route)))
        cpu = variant(card, device="cpu")
        a = make_rnr_eval_step(card)(bc, v_feature=vf)["img"].float().cpu()
        t0 = time.perf_counter()
        r = make_rnr_eval_step(cpu)(bh, v_feature=vf.cpu())["img"].float()
        log(f"[parity] {route}: CPU frame at 128^2: "
            f"{time.perf_counter() - t0:.1f} s")
        scale = float(r.abs().max())
        d = (a - r).abs()
        err, mean = float(d.max()), float(d.mean())
        # bf16 U-Net (14 convs, 5 levels of batch statistics): a flipped
        # bf16 rounding (2^-8 relative) in one layer moves the next
        # layers' inputs
        tol_max, tol_mean = 5e-2 * scale, 5e-3 * scale
        log(f"[parity] {route}: card vs CPU image 128^2: max abs err "
            f"{err:.4g} (rel {err / scale:.3g}, tol {tol_max:.4g}), mean abs "
            f"err {mean:.4g} (rel {mean / scale:.3g}, tol {tol_mean:.4g}), "
            f"max |ref| {scale:.4g}")
        check(f"parity {route} max", err, tol_max)
        check(f"parity {route} mean", mean, tol_mean)


# ------------------------------------------------------------ training

LOSS_KEYS = ("loss", "loss_rn", "loss_lighting", "loss_rays_lt_chrom",
             "loss_alb")


def blocked_by_batch_norm(name: str) -> bool:
    """The GCN and the fusion block's Dense reach the loss only through a
    per-channel shift that is constant over (N, H, W), which the next
    batch norm removes: their exact gradient is zero, and what they get is
    the rounding of the bf16 backward (the batch norm's input gradient is
    cast to bf16 before it is summed over the frame), scaled by the size
    of v_feature.  Nonzero, but no signal to compare between devices."""
    return name.startswith("gcn.") or "GcnFuseBlock_0.Dense_0" in name


def check_step(model, before: dict, u_before: dict, met: dict) -> None:
    """Losses finite; every gradient finite and nonzero where the loss
    reaches; the parameters moved; the SNDense vectors advanced."""
    for k in LOSS_KEYS:
        if not bool(torch.isfinite(met[k])):
            raise AssertionError(f"{k} = {float(met[k])}")
    log("[train] losses: " + ", ".join(f"{k} {float(met[k]):.6g}"
                                       for k in LOSS_KEYS)
        + f"; psnr_valid {float(met['psnr_valid']):.4g}")
    grads = {n: p.grad for n, p in model.named_parameters()}
    for n, g in grads.items():
        if g is None or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{n}: gradient missing or not finite")
    top = max(float(g.abs().max()) for g in grads.values())
    noise = []
    smallest = (None, float("inf"))
    for n, g in grads.items():
        if n == "lighting.coeff":
            # lighting_idx 0 trains; the other lightings take no part
            if not float(g[0].abs().max()) > 0 or float(g[1:].abs().max()):
                raise AssertionError("lighting.coeff gradient: row 0 must "
                                     "be nonzero, the other rows zero")
            continue
        m = float(g.abs().max())
        if not m > 0:
            raise AssertionError(f"{n}: zero gradient")
        if blocked_by_batch_norm(n):
            noise.append(m / top)
        elif m < smallest[1]:
            smallest = (n, m)
    log(f"[train] {len(grads)} gradients finite and nonzero; largest "
        f"{top:.4g}; smallest outside the GCN: {smallest[0]} "
        f"{smallest[1]:.4g}; zero by design: lighting.coeff[1:] (lightings "
        f"other than 0 take no part); {len(noise)} tensors behind batch "
        f"norm (GCN, fusion Dense) hold bf16 rounding only, up to "
        f"{max(noise):.3g} x the largest")
    still = [n for n, p in model.named_parameters()
             if torch.equal(p.detach(), before[n])]
    if [n for n in still if not blocked_by_batch_norm(n)]:
        raise AssertionError(f"parameters did not move: {still}")
    for n, u in u_before.items():
        if torch.equal(dict(model.named_buffers())[n], u):
            raise AssertionError(f"{n} did not advance")
    log(f"[train] {len(before) - len(still)} of {len(before)} parameter "
        f"tensors moved (unmoved, behind batch norm: {still}); "
        f"{len(u_before)} SNDense vectors advanced")


def counted_step(model, step, b, statics, gen, want: dict, launches: dict,
                 tag: str) -> None:
    """One training step with the launch counts set to 0 just before it
    and read just after: each kernel of `want` launched that many times,
    the AT_LEAST_ONE kernels at least once; then check_step."""
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    u_before = {n: u.clone() for n, u in model.named_buffers()
                if n.endswith(".u")}
    reset_launches()
    met = step(b, statics, gen)
    torch.cuda.synchronize()
    launches.update(read_launches())
    log(f"[train] launches in one {tag} step at batch 1: {launches}")
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"in a {tag} step, expected {n}")
    for name in AT_LEAST_ONE:
        if launches[name] < 1:
            raise AssertionError(f"{name} not launched in a {tag} step")
    check_step(model, before, u_before, met)


def timed_steps(step, b, statics, gen, bsz: int, tag: str,
                n: int = 5) -> dict:
    """n steps on the host clock after a synchronize, n by CUDA events,
    the peak memory of the first n."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n):
        met = step(b, statics, gen)
    torch.cuda.synchronize()
    fps = bsz * n / (time.perf_counter() - t0)
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = cuda_ms(lambda: step(b, statics, gen), iters=n, warmup=0)
    loss = float(met["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"loss {loss} in a {tag} step at batch {bsz}")
    log(f"[train] {tag} batch {bsz} at {IMG}^2: {fps:.3f} train frames/s "
        f"(host clock, {n} steps after synchronize); step {step_ms:.3f} ms "
        f"by CUDA events; peak memory {mem:.3f} GiB; loss {loss:.6g}")
    return dict(fps=fps, step_ms=step_ms, peak_gib=mem)


def probe_scatter(model, b: dict, step_ms: float) -> None:
    """The probe step's ray_render on its own: the gather from the
    learned lighting's 64 x 128 probe and its backward (the scatter into
    the probe, and d rays_lt) at the step's rays, the gather timed by CUDA
    events and the backward by one profiled run, with the backward's share
    of the step; beside it, as a yardstick the port does not use, one
    index_add_ per tap of the same taps into the probe."""
    from rnr_tpu_torch.models.rays import ray_render
    from rnr_tpu_torch.ops.interpolate import bilinear_taps
    with torch.no_grad():
        out = model(b, train=False)
    lp = model.lighting(0, is_lp=True).detach().requires_grad_()
    rays_lt = out["rays_lt"].detach().requires_grad_()
    args = (out["albedo_specular"], out["rays_uv"], rays_lt, lp)
    kw = dict(num_ray_diffuse=model.num_ray_diffuse,
              albedo_diffuse=out["albedo_diffuse"], separate_albedo=True)
    g = torch.ones_like(out["img"])

    def fwd():
        return ray_render(*args, **kw)["out"]

    def fwd_bwd():
        torch.autograd.grad(fwd(), (lp, rays_lt), g)

    f_ms = cuda_ms(fwd)
    fb_ms = profile_window("probe ray_render gather + backward", fwd_bwd, 1,
                           top=8, warm=False)
    hl, wl = lp.shape[1], lp.shape[2]
    taps = bilinear_taps(
        torch.clamp(out["rays_uv"][..., 0, :] * wl, max=wl - 1).reshape(-1),
        torch.clamp(out["rays_uv"][..., 1, :] * hl, max=hl - 1).reshape(-1),
        hl, wl)
    src = torch.ones((taps[0][0].numel(), 3), device=DEV)

    def index_add():
        acc = torch.zeros((hl * wl, 3), device=DEV)
        for idx, w in taps:
            acc.index_add_(0, idx, src * w[:, None])
        return acc

    ia_ms = cuda_ms(index_add)
    log(f"[train] probe step's ray_render at {IMG}^2 "
        f"({out['rays_uv'].shape[-1]} rays, {hl}x{wl} probe): gather "
        f"{f_ms:.3f} ms by CUDA events; gather + backward {fb_ms:.3f} ms of "
        f"kernels in one profiled run, backward {fb_ms - f_ms:.3f} ms = "
        f"{100 * (fb_ms - f_ms) / step_ms:.1f}% of the step's "
        f"{step_ms:.3f} ms; index_add_ of the same 4 x {src.shape[0]} taps "
        f"into the probe (a yardstick, unused): {ia_ms:.3f} ms")


def phase_train(train_launches: dict, variant_launches: dict) -> dict:
    from rnr_tpu_torch.models.rnr import RNRModel
    from rnr_tpu_torch.synthetic import build_statics, init_weights
    from rnr_tpu_torch.train.steps import (create_rnr_optimizer,
                                           make_generator,
                                           make_rnr_train_step)
    model = init_weights(RNRModel(canonical_config(), GCN_V), seed=0)
    statics = build_statics(model, 4096)
    step = make_rnr_train_step(model, create_rnr_optimizer(model, 1e-3))
    gen = make_generator(0)
    if gen.device != DEV:
        raise AssertionError("make_generator did not build on the card")
    out = {}
    for bsz in (1, 2):
        b = _gbuffer(IMG, bsz)
        for _ in range(2):
            step(b, statics, gen)
        torch.cuda.synchronize()
        if bsz == 1:   # the main path: one step, counted and checked
            counted_step(model, step, b, statics, gen, TRAIN_LAUNCHES,
                         train_launches, "shipped")
        out[bsz] = timed_steps(step, b, statics, gen, bsz, "shipped")
        if bsz == 1:
            profile_window("train step b1", lambda: step(b, statics, gen), 1,
                           top=20)
    del model, step
    torch.cuda.empty_cache()
    # the relighting configurations and the conv routes, batch 1, from the
    # same seeded weights
    b = _gbuffer(IMG, 1)
    for name, (sections, want) in TRAIN_VARIANTS.items():
        model = init_weights(RNRModel(canonical_config(**sections), GCN_V),
                             seed=0)
        step = make_rnr_train_step(model, create_rnr_optimizer(model, 1e-3))
        if name != "probe":
            for _ in range(2):
                step(b, statics, gen)
        variant_launches[name] = {}
        counted_step(model, step, b, statics, gen, want,
                     variant_launches[name], name)
        out[name] = timed_steps(step, b, statics, gen, 1, name,
                                TIMED_STEPS[name])
        if name == "probe":
            probe_scatter(model, b, out[name]["step_ms"])
        else:
            profile_window(f"train step {name} b1",
                           lambda: step(b, statics, gen), 1, top=12)
        del model, step
        torch.cuda.empty_cache()
    # the conv routes under zero padding at SAME_IMG^2: one counted step
    b = _gbuffer(SAME_IMG, 1)
    for name, want in SAME_LAUNCHES.items():
        cfg = canonical_config(img=SAME_IMG, render_net=dict(
            conv_backend=name, pad_mode="same"))
        model = init_weights(RNRModel(cfg, GCN_V), seed=0)
        step = make_rnr_train_step(model, create_rnr_optimizer(model, 1e-3))
        step(b, statics, gen)
        torch.cuda.synchronize()
        variant_launches[f"{name}_same"] = {}
        counted_step(model, step, b, statics, gen, want,
                     variant_launches[f"{name}_same"],
                     f"{name} same-padding {SAME_IMG}^2")
        del model, step
        torch.cuda.empty_cache()
    return out


def _loss_and_grads(model, nb: dict, dev) -> dict:
    """One loss and backward of `model` on batch `nb`, dropout off; the
    loss terms and every gradient (f32, on the CPU)."""
    from rnr_tpu_torch.synthetic import build_statics, to_torch
    from rnr_tpu_torch.train.steps import make_generator, make_rnr_loss_fn
    model.render_net.Unet_0.use_dropout = False
    # the device's own tex_flatten_init: the albedo prior compares bit for
    # bit with what that device's flatten_mipmap gives
    statics = build_statics(model, 4096)
    t0 = time.perf_counter()
    loss, aux = make_rnr_loss_fn(model)(to_torch(nb, dev), statics,
                                        make_generator(0, dev))
    loss.backward()
    torch.cuda.synchronize()
    log(f"[train_parity] {dev} step at 128^2: "
        f"{time.perf_counter() - t0:.2f} s")
    return dict(aux={k: float(aux[k].detach()) for k in LOSS_KEYS},
                grads={n: p.grad.detach().float().cpu()
                       for n, p in model.named_parameters()})


# CPU reruns of the step with the non-albedo texture channels scaled: each
# flips some bf16 roundings of the U-Net input and nothing else
PERTURB = (1.0 + 1e-3, 1.0 - 1e-3, 1.0 + 2e-3)
COS_MARGIN = 0.2             # card cosine >= the reruns' lowest - this
NORM_MARGIN = math.log(1.25)  # |log norm ratio| <= the reruns' largest + this
COEFF_REL = 1e-2             # lighting.coeff: max diff / max |g|


def _grad_agreement(a: dict, r: dict) -> dict:
    """Per gradient tensor that passes through the U-Net backward (not the
    batch-norm-blocked ones, not lighting.coeff): the cosine of a against
    r and |log| of the ratio of their norms, in f64."""
    out = {}
    for n, gr in r.items():
        if blocked_by_batch_norm(n) or n == "lighting.coeff":
            continue
        ga, gr = a[n].double().flatten(), gr.double().flatten()
        na, nr = float(ga.norm()), float(gr.norm())
        cos = float(ga @ gr) / max(na * nr, 1e-300)
        out[n] = (cos, abs(math.log(max(na, 1e-300) / max(nr, 1e-300))))
    return out


def _coeff_err(a: dict, r: dict) -> float:
    """lighting.coeff: the trained lighting's row, max abs difference over
    its max |g|; the other rows must be zero on both sides."""
    ga, gr = a["lighting.coeff"], r["lighting.coeff"]
    if float(ga[1:].abs().max()) or float(gr[1:].abs().max()):
        raise AssertionError("lighting.coeff gradient: rows of the unused "
                             "lightings are not zero")
    return float((ga[0] - gr[0]).abs().max()) / float(gr[0].abs().max())


def phase_train_parity() -> None:
    """One training step at 128^2 and V 1024: card vs CPU, same weights,
    dropout and the stochastic GCN off (the two generators cannot match).

    lighting.coeff's gradient is K1b's d coeff (basis x rays_lt x the loss
    gradient of the image) plus the lighting loss's: no U-Net backward lies
    between it and the loss, so it is held to COEFF_REL of its max.  The
    other tensors pass through the bf16 U-Net backward, which at random
    weights is chaotic in its deep levels: on the CPU alone, a 1e-3 scale
    of the non-albedo texture channels moves the innermost levels'
    gradients to a cosine of ~0.55 with the unperturbed ones.  So the CPU
    step is rerun under each PERTURB, and each tensor's card-vs-CPU cosine
    and norm ratio are held to what those reruns reach, with COS_MARGIN
    and NORM_MARGIN: a dropped gradient gives cosine 0, a flipped sign -1,
    and a 2x scale error |log ratio| 0.69 where the reruns reach ~0."""
    from rnr_tpu_torch.models.rnr import RNRModel
    from rnr_tpu_torch.synthetic import build_batch, init_weights
    cfg = canonical_config(img=128, stochastic=False)
    gpu = init_weights(RNRModel(cfg, 1024), seed=1)
    # before any step: training advances the SNDense vectors in place
    state = {k: v.cpu().clone() for k, v in gpu.state_dict().items()}
    nb = build_batch(128, 1024)
    torch.set_num_threads(os.cpu_count() or 1)
    card = _loss_and_grads(gpu, nb, DEV)
    runs = []
    for scale in (1.0,) + PERTURB:
        cpu = RNRModel(cfg, 1024, device="cpu")
        cpu.load_state_dict(state)
        with torch.no_grad():   # channels 0:6 feed the albedo prior
            cpu.texture_mapper.texture_0[..., 6:] *= scale
        runs.append(_loss_and_grads(cpu, nb, "cpu"))
    ref, reruns = runs[0], runs[1:]
    for k in LOSS_KEYS:
        e = abs(card["aux"][k] - ref["aux"][k])
        # the bf16 U-Net: the image agrees to ~5e-3 x max on average
        tol = 1e-2 * abs(ref["aux"][k]) + 1e-6
        log(f"[train_parity] {k}: card {card['aux'][k]:.7g} cpu "
            f"{ref['aux'][k]:.7g} (abs diff {e:.3g}, tol {tol:.3g})")
        check(f"train_parity {k}", e, tol)
    ce = _coeff_err(card["grads"], ref["grads"])
    ce_floor = max(_coeff_err(x["grads"], ref["grads"]) for x in reruns)
    log(f"[train_parity] lighting.coeff: card vs cpu max diff {ce:.3g} x "
        f"max |g| (tol {COEFF_REL:g}; perturbed reruns up to {ce_floor:.3g})")
    check("train_parity grad lighting.coeff", ce, COEFF_REL)
    got = _grad_agreement(card["grads"], ref["grads"])
    floors = [_grad_agreement(x["grads"], ref["grads"]) for x in reruns]
    worst = []
    for n, (cos, lr) in got.items():
        fcos = min(f[n][0] for f in floors)
        flr = max(f[n][1] for f in floors)
        worst.append((cos - fcos, n, cos, fcos, lr, flr))
        check(f"train_parity grad {n} cosine {cos:.4f} vs reruns' "
              f"{fcos:.4f}", fcos - COS_MARGIN - cos, 0.0)
        check(f"train_parity grad {n} |log norm ratio| {lr:.4f} vs "
              f"reruns' {flr:.4f}", lr - flr - NORM_MARGIN, 0.0)
    worst.sort()
    log(f"[train_parity] {len(got)} gradient tensors through the U-Net: "
        f"card cosine min {min(v[0] for v in got.values()):.4f}, reruns' min "
        f"{min(min(v[0] for v in f.values()) for f in floors):.4f}; "
        f"|log norm ratio| card max {max(v[1] for v in got.values()):.4f}, "
        f"reruns' max {max(max(v[1] for v in f.values()) for f in floors):.4f}"
        f" (margins {COS_MARGIN}, {NORM_MARGIN:.4f}); nearest the floor: "
        + ", ".join(f"{w[1]} cos {w[2]:.3f} vs {w[3]:.3f}, log ratio "
                    f"{w[4]:.3f} vs {w[5]:.3f}" for w in worst[:4]))
    noise = [(float(card["grads"][n].abs().max()),
              float(ref["grads"][n].abs().max()))
             for n in ref["grads"] if blocked_by_batch_norm(n)]
    log(f"[train_parity] {len(noise)} behind batch norm not compared (bf16 "
        f"rounding, max |g| up to {max(x[0] for x in noise):.3g} on the "
        f"card, {max(x[1] for x in noise):.3g} on the CPU)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="device,build,kernels,slice,"
                                        "gbuffer,relight,parity,train,"
                                        "train_parity")
    phases = ap.parse_args().phases.split(",")
    t_start = time.perf_counter()
    smi = phase_device()
    rec: dict = {}
    eval_launches: dict = {}
    train_launches: dict = {}
    view_launches: dict = {}
    relight_launches: dict = {}
    variant_launches: dict = {}
    route_launches: dict = {}
    kernel_launches: dict = {}

    def done(name):
        torch.cuda.synchronize()
        log(f"[time] {name} done at {time.perf_counter() - t_start:.1f} s")

    if "build" in phases:
        phase_build()
        done("build")
    if "kernels" in phases:
        phase_kernels(rec, kernel_launches)
        done("kernels")
    # gbuffer, relight and parity reuse the slice's model and v_feature
    if {"slice", "gbuffer", "relight", "parity"} & set(phases):
        state = phase_slice(eval_launches)
        profile_slice(state)
        slice_routes(state, route_launches)
        done("slice")
        if "gbuffer" in phases:
            phase_gbuffer(state, view_launches)
            done("gbuffer")
        if "relight" in phases:
            phase_relight(state, relight_launches)
            done("relight")
        if "parity" in phases:
            phase_parity(state)
            done("parity")
        del state
        torch.cuda.empty_cache()
    if "train" in phases:
        phase_train(train_launches, variant_launches)
        done("train")
    if "train_parity" in phases:
        phase_train_parity()
        done("train_parity")
    # launches: the count on the kernel's main path, the training step
    # (one step at b1), or for K7 the G-buffer path (N_VIEWS views), for
    # K5 the relight path (N_VIEWS views x N_PROBES probes x the routes),
    # for K5b the unfused training step, for K6, K8's 4x4 pair and the 3x3
    # slab pair the b1 training step of their conv route ("pallas", "p3s4",
    # "slab3"), for P1 the kernels phase
    paths = {"train": train_launches, "gbuffer": view_launches,
             "relight": relight_launches,
             "train_unfused": variant_launches.get("unfused", {}),
             "train_pallas": variant_launches.get("pallas", {}),
             "train_p3s4": variant_launches.get("p3s4", {}),
             "train_slab3": variant_launches.get("slab3", {}),
             "kernels": kernel_launches}
    kernels = [dict(name=n, route="cuda", source=s["source"],
                    replaces=s["replaces"],
                    launches=paths[s.get("path", "train")].get(n),
                    eval_launches=eval_launches.get(n),
                    eval_route_launches={
                        r: c.get(n) for r, c in route_launches.items()},
                    view_launches=view_launches.get(n),
                    relight_launches=relight_launches.get(n),
                    train_variant_launches={
                        v: c.get(n) for v, c in variant_launches.items()},
                    **rec.get(n, {}))
               for n, s in KERNELS.items()]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
