"""Drive the PyTorch + CUDA port on one NVIDIA GPU: the serving path, the
training step, inference from a mesh (G-buffer, then the frame),
relighting under novel light probes, the U-Net's conv routes "pallas"
(K6), "p3s4" (K8's 4x4 pair), "slab3" (K8's 3x3 slab conv, K8a and K8b)
and "slab" (the 3x3 slab conv and K8's 4x4 pair), the offline drivers,
Deferred Neural Rendering, the differentiable rasterizer, remat and
data parallelism over ranks, and the quality gate's shipped arm.

    python3 chip_smoke.py            # every phase (one H100, a few minutes)
    python3 chip_smoke.py --phases device,build,kernels
    python3 chip_smoke.py --phases device,build,train
    python3 chip_smoke.py --phases device,build,kernels,slice,gbuffer
    python3 chip_smoke.py --phases device,build,kernels,slice,relight
    python3 chip_smoke.py --phases device,build,kernels,slice,train
    python3 chip_smoke.py --phases device,build,drivers
    python3 chip_smoke.py --phases device,build,drivers,dnr,edge_grad
    python3 chip_smoke.py --phases device,build,parallel
    python3 chip_smoke.py --phases device,build,sp
    python3 chip_smoke.py --phases device,build,gate
    python3 chip_smoke.py --phases device,build,determinism

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
           F.grid_sample calls timed beside it as a yardstick; K2b (64-bit
           fixed-point sums) must be bit-equal to its arithmetic in plain
           torch (mipmap_scatter_fixed_torch) and run to run, and also runs
           at batch 2, with every pixel on the corner texel and
           with a uv seam inside its pixel tiles, and on uv and g views
           off their alignment, behind MipmapSampleFn and through its
           wrapper (copied there), its C entry refusing such bases.  K4 runs at V 7500 and C
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
  drivers  the offline workflow of scripts/preproc.sh, train_rnr.sh and
           test_rnr.sh through the port's entry points (their main(argv))
           in this process, on a scene it writes under build/: the
           gbuffer phase's sphere, a 7,500-vertex GCN sphere, 10 views of
           the camera ring (8 to train, 2 to validate), two procedural
           256 x 512 HDR probes.  precompute (both meshes), stitch_lp
           (on the PNG views, then at its default suffix on the same views
           as ZIP EXR: the two stitches equal), train_rnr at the
           canonical configuration and shipped knobs for
           6 iterations (one validation, one checkpoint), test_rnr.main on
           model_final.ckpt under the trained lighting, the probes' SH
           fit (also per stage: K5) and their gather.  Checks every
           output file, finite losses and validation metrics, the
           launches of K1, K1b, K2, K2b, K3, K3b, K4, K5 and K7 on that
           path (drivers_launches), the checkpoint's round trip (every
           tensor) and test_rnr.main's frame of a view bit-equal to the
           eval step's on the trained model; train_rnr's reader of the
           stitched 0.exr; the JPEG / BMP fixtures of tests/data/images
           decoded bit-equal to their committed cv2 decodes (both cv2
           flags, host ms each); train_dnr --tex_fp on the EXIF-6 JPEG
           fixture for two iterations; reports precompute s/view,
           train_rnr iterations/s through the driver beside the train
           phase's bare step, test_rnr views/s and buckets, the
           checkpoint's size and save and load seconds, and the trained
           model's step kernels on a view's G-buffer with the scene's GCN
           sphere, that sphere jittered and the train phase's GCN points.
  dnr      Deferred Neural Rendering through the port's entry points on
           the drivers phase's scene (its own copy): precompute,
           train_dnr at full width (512^2, texture 512^2 x 30 channels x 4
           levels, nf0 64, 5 downs, batch 1, apply_sh, "auto"; the U-Net
           in f32 as rnr_tpu's, each conv's kernel three times on bf16
           parts, each weight gradient's six) for 20 iterations with one
           validation and one checkpoint, test_dnr.main on
           model_final.ckpt, make_spiral (8
           steps) and test_dnr on the spiral.  Checks every file, finite
           losses and metrics, the launches of K2, K2b, K3, K3b and K7 on
           that path, test_dnr's frame bit-equal to the eval step's on the
           trained model, the launches of one step and one frame
           (dnr_launches), their CUDA-event medians and the step's share
           in kernels by name, the f32 route's glue (its splits and
           sums) by name; K3's forward and data gradient and K3b on the
           f32 route at the step's own conv inputs against their plain
           f32 versions (5e-5 of the largest; a one-pass bf16 control
           must fail that check); K2 and K2b at C 30 on the scene's uv
           against their plain versions (single, queued and host times,
           the bound), also on views off their alignment; one step under
           "pallas" (K6a, K6b).
  edge_grad  silhouette and rasterize_opt (ops/edge_grad.py) on the UV
           sphere of the G-buffer phase from a ring view at 480^2 (32 x
           128 tiles, the last column cut to 96 by the frame), 256^2 and
           512^2: K7 once a call, overflow 0, the
           oracle never taken;
           K7's face index, weights and alpha and both Functions' forward
           outputs bit-equal to rasterize_face_index's; the gradients of
           a random weighting against the same Functions on the oracle's
           maps; times.  At 320^2 (the last column of tiles cut to 64)
           the overflow rule: K7
           once, its overflow reported, the oracle's maps.  Then a
           20-step Adam silhouette fit at 256^2 whose loss must fall (K7
           once a step).
  parallel  remat, data parallelism and the native OBJ parser at full
           width (512^2, the canonical config, the shipped knobs).  The
           shipped train step at batch 4 under remat "none", "wide" and
           "all": peak memory (MiB), step ms by CUDA events (median and
           range of 5), K3's launches; a rerun of "none" and each mode
           against "none": the loss, the dropout generator's end state
           and every gradient bit for bit; then
           train_rnr --unet_remat wide for 3 synthetic iterations.  A
           one-rank NCCL group on cuda:0: the dp = 1 step, its
           collectives over NCCL, bit-equal to the step run with no
           process group (the shipped route, every gradient).  Two ranks on the one card over Gloo with CUDA tensors
           (spawned by parallel.run_ranks; NCCL refuses two ranks on one
           device), global batch 2 of two distinct views, dropout off,
           against one process's b2 step and frame: the sharded RNR step
           and eval rows with f32 rays and U-Net (DETERMINISTIC_NET), the
           same under remat "wide", at the shipped bf16, and the sharded
           DNR step (f32, DETERMINISTIC_NET); each (but the remat one)
           also as a control without the cross-rank norm.  Each limit
           (DP_LIMITS: the loss, the gradient cosine, each gradient's
           largest error, the eval rows) lies between the sound run's
           reading and the control's: the sound run within, the control
           outside; at bf16 the cosines and elementwise errors are
           reported.  The ranks' parameters equal by digest after two
           steps (dropout on).  Last, the native OBJ parser
           (csrc/obj_parse.cpp; fails where it did not run) and its
           arrays against the Python parser's on the gbuffer phase's
           sphere.
  sp       image rows across ranks (rnr_tpu's sp axis) at full width:
           Gloo ranks on cuda:0 (spawned by parallel.run_ranks), dropout
           off, against one process on the same global batch.  Two ranks:
           (a) sp 2 with the shipped route at b1, its train step and eval
           frame; (d) the eval frame under every other conv route
           ("xla", "pallas", "p3s4", "slab3", "slab") and under
           norm="group"; (e) sp 2 at 480 rows (15 units of 32 rows: 256
           and 224 rows a rank), the shipped train step and eval frame.
           Four ranks: (b) sp 4, the shipped eval frame;
           (c) (dp 2, sp 2) at b2 of two distinct views, one f32 train
           step and its eval frame (DETERMINISTIC_NET).  Each case also
           runs as a control without the halo (each rank's convs padding
           its own rows); each limit of SP_LIMITS lies between the two
           readings.  Each rank's launches (sp_launches in the kernels
           line) must equal the others' and the route's own counts: an
           eval frame K4 17, K3 14, K1 1, K2 1 on each rank.
  determinism  every training and eval path from the same weights,
           batch and generator four times, twice under
           torch.use_deterministic_algorithms(True) and twice as the
           entry points leave it: the shipped b1 train step (5 steps) under
           every conv route ("pallas3", "pallas", "p3s4", "slab3", "slab",
           "xla"), the unfused step (5), one probe step, 3 DNR steps and
           the DNR frame, the shipped eval frame with its v_feature, the
           drivers' fresh weights (init_rnr_params under another global
           RNG seed each run) and rasterize_opt forward and backward at
           512^2.  Parameters,
           buffers, Adam state, losses, frames and gradients must be
           bit-equal by digest within each pair.
  gate     the quality gate (rnr_tpu_torch/tools/quality_gate.py) at
           canonical width: its "ship" arm (tools/out/best_config.json's
           knobs) in this process through the module's main (--one_arm
           ship --canonical --img 512 --iters GATE_ITERS): the 24-view
           scene of 72 x 104 sphere segments, precompute, stitch_lp,
           GATE_ITERS train_rnr iterations and one validation with
           relighting.  Checks the loss falls, every validation figure
           finite, the launches of K1, K1b, K2, K2b, K3, K3b, K4 and K7
           on that path (gate_launches), and that every load_obj call ran
           the native parser (csrc/obj_parse.cpp); reports iterations/s,
           peak device MiB and host RSS.  Then the native parser against
           the Python one on a 1,001,112-face sphere, both timed.
The slice phase also holds K4 to its plain version (compare_picks) on
the canonical GCN's own block features, and the parity phase runs the
canonical model with group norm at 128^2 on the card against the CPU.
The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and the one before that the per-kernel JSON
record.  Nothing is printed as a result without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
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
                                              tile_extent, tile_grid,
                                              tile_in_frame, tile_pixels)
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
                                            mipmap_scatter_fixed_torch,
                                            mipmap_scatter_torch,
                                            scatter_rounding_bound,
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
        h.update(t.contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
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
    frame = tile_in_frame(s, tile_h, tile_w, dev)[None, :, None, :]
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
        total += (ins & live[..., None] & frame).sum()
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
    eh, ew = tile_extent(s, tile_h, tile_w, dev)
    # each warp's block, and its pixels in the tile (and the frame)
    blk = ((wy * wh // bh)[:, None] * -(-tile_w // bw)
           + (wx * WARP_W // bw)[None, :]).reshape(-1)
    pix = ((torch.clamp(eh[:, None] - wy * wh, 0, wh))[:, :, None]
           * torch.clamp(ew[:, None] - wx * WARP_W, 0, WARP_W)[:, None, :]
           ).reshape(len(eh), -1)                            # [T, Rw]
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
    scatter_misaligned_case(texs, uv)
    torch.cuda.synchronize()


def _offset_copy(t: torch.Tensor, off: int) -> torch.Tensor:
    """A contiguous copy of t that starts `off` floats into its allocation
    (4 * off bytes off the allocator's alignment)."""
    v = torch.empty(t.numel() + off, device=t.device)[off:].view(t.shape)
    v.copy_(t)
    return v


def scatter_misaligned_case(texs, uv: torch.Tensor) -> None:
    """K2b on views at unaligned offsets: the G-buffer's uv one float off
    (K2b reads uv as float2) and g two floats off (read as float4 at 24
    channels), `misaligned_views`; then K2b's C entry refusing each such
    base (cudaErrorInvalidValue, nothing written)."""
    misaligned_views(texs, uv, 2)
    f = _build.fn("mipmap_scatter", "rnr_mipmap_scatter", 8, 9)
    d = torch.full((8, 8, 4), 7.0, device=DEV)
    acc = torch.empty(8 * 8 * 4, dtype=torch.int64, device=DEV)
    mbits = torch.empty(1, dtype=torch.int32, device=DEV)
    base_uv = torch.zeros(2 * 4 * 4 * 2 + 4, device=DEV)
    base_g = torch.ones(2 * 4 * 4 * 4 + 4, device=DEV)
    for uv_off, g_off in ((1, 0), (0, 1), (0, 2)):
        rc = f(d.data_ptr(), 0, 0, 0, acc.data_ptr(), mbits.data_ptr(),
               base_uv.data_ptr() + 4 * uv_off,
               base_g.data_ptr() + 4 * g_off, 8, 0, 0, 0, 1, 2, 4, 4, 4,
               torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if rc != 1 or not bool((d == 7.0).all()):
            raise AssertionError(f"rnr_mipmap_scatter took a base {uv_off} "
                                 f"/ {g_off} floats off: rc {rc}")
    log("[kernels] mipmap_scatter: the C entry refused three misaligned "
        "bases")


def misaligned_views(texs, uv: torch.Tensor, g_off: int) -> None:
    """K2 and K2b on the uv view one float off and a g view `g_off` floats
    off their alignment, C = texs' channels, behind MipmapSampleFn
    (forward and backward, against the aligned run: both bit-equal) and
    through mipmap_scatter against its plain version (each level within
    1e-5 x the sum of its terms' magnitudes + K2b's fixed-point rounding).
    Its own seed."""
    ch = texs[0].shape[-1]
    g = torch.from_numpy(np.random.default_rng(216).standard_normal(
        (1, IMG, IMG, ch)).astype(np.float32)).to(DEV)
    uv_m, g_m = _offset_copy(uv, 1), _offset_copy(g, g_off)
    if uv_m.data_ptr() % 8 == 0 or g_m.data_ptr() % 16 == 0:
        raise AssertionError("mipmap_scatter misaligned case: views aligned")

    def through_fn(u, gg):
        lv = [t.detach().clone().requires_grad_(True) for t in texs]
        out = mipmap_sample(lv, u)
        out.backward(gg)
        return out.detach(), [t.grad for t in lv]

    out_a, grads_a = through_fn(uv, g)
    out_m, grads_m = through_fn(uv_m, g_m)
    direct = mipmap_scatter(uv_m, g_m, TEX_SIZES)
    plain = mipmap_scatter_torch(uv, g, TEX_SIZES)
    mag = mipmap_scatter_torch(uv, g.abs(), TEX_SIZES)
    grid = scatter_rounding_bound(uv, g, TEX_SIZES)
    torch.cuda.synchronize()
    if not torch.equal(out_m, out_a):
        raise AssertionError("mipmap_gather on a misaligned uv differs from "
                             "the aligned run")
    for a, r in zip(grads_m, grads_a):
        if not torch.equal(a, r):
            raise AssertionError("mipmap_scatter on misaligned views differs "
                                 "from the aligned run")
    err = 0.0
    for a, r, m, q in zip(direct, plain, mag, grid):
        check(f"mipmap_scatter misaligned uv and g, C {ch}",
              float(((a - r).abs().double() - 1e-5 * m.double() - q).max()),
              0.0)
        err = max(err, float((a - r).abs().max()))
    log(f"[kernels] mipmap_gather / mipmap_scatter at C {ch} on uv 1 and g "
        f"{g_off} floats off their alignment: forward and backward "
        f"bit-equal to the aligned run's through MipmapSampleFn; "
        f"mipmap_scatter's max abs err {err:.3g} (tol 1e-5 x the sum of each "
        "texel's |terms| + its taps x half a grid step)")


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
             **gather_work(uv, texs[0].shape[-1], TEX_SIZES))
    log(f"[kernels] mipmap_gather {tag} -> 4 levels x {texs[0].shape[-1]}: "
        f"max abs err "
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
    ch = texs[0].shape[-1]
    out = torch.empty((n, h, w, ch), device=DEV)
    f = _build.fn("mipmap_gather", "rnr_mipmap_gather", 6, 10)
    args = (*[t.data_ptr() for t in texs], uv.data_ptr(), out.data_ptr(),
            *TEX_SIZES, len(TEX_SIZES), n, h, w, ch, 0,
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
    within 1e-5 x the sum of its terms' magnitudes (the plain version's f32
    sums and K2b's in another order, so each texel may differ by a
    rounding of its partial sums; the corner texel of the uncovered pixels
    sums 131,072 terms) plus K2b's fixed-point rounding, (its taps) x half
    a grid step (scatter_rounding_bound); bit-equal to its fixed-point
    arithmetic in plain torch (mipmap_scatter_fixed_torch), and the
    run-to-run difference 0.  Returns the max abs error, the run-to-run
    max difference and the count of taps of nonzero weight (the kernel
    skips the others)."""
    kg = mipmap_scatter(uv, g, TEX_SIZES)
    kg2 = mipmap_scatter(uv, g, TEX_SIZES)
    tg = mipmap_scatter_torch(uv, g, TEX_SIZES)
    mag = mipmap_scatter_torch(uv, g.abs(), TEX_SIZES)
    fixed = mipmap_scatter_fixed_torch(uv, g, TEX_SIZES)
    grid = scatter_rounding_bound(uv, g, TEX_SIZES)
    torch.cuda.synchronize()
    err = rerun = 0.0
    for a, a2, r, m, f, q, s in zip(kg, kg2, tg, mag, fixed, grid,
                                    TEX_SIZES):
        excess = float(((a - r).abs().double() - 1e-5 * m.double()
                        - q).max())
        check(f"mipmap_scatter {tag} level {s}", excess, 0.0)
        if not torch.equal(a, f):
            raise AssertionError(f"mipmap_scatter {tag} level {s}: differs "
                                 "from mipmap_scatter_fixed_torch by "
                                 f"{float((a - f).abs().max()):.3g}")
        err = max(err, float((a - r).abs().max()))
        rerun = max(rerun, float((a - a2).abs().max()))
    check(f"mipmap_scatter {tag} run to run", rerun, 0.0)
    taps = 0
    for s in TEX_SIZES:
        x, y = level_coords(uv, s)
        taps += sum(int((w != 0).sum()) for _, w in bilinear_taps(x, y, s, s))
    log(f"[kernels] mipmap_scatter {tag} -> 4 levels x {g.shape[-1]}: max "
        f"abs err "
        f"{err:.3g} (tol 1e-5 x the sum of each texel's |terms| + its "
        f"taps x half a grid step); bit-equal to its fixed-point arithmetic "
        f"in plain torch; run-to-run max difference {rerun:.3g}; {taps} "
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
        # tiles cut by the frame: 16 x 4 tiles at 509^2, 7 x 2 at 200^2
        # (there the sphere's tiles overflow the cap: K7 and its plain
        # version drop the same candidates)
        (f"{2 * lon * (lat - 1)} faces, 30 deg, 509^2",
         ring_faces(lat, lon, 30.0, [0], 509), 509, 2048, "zero"),
        (f"{2 * lon * (lat - 1)} faces, 30 deg, 200^2",
         ring_faces(lat, lon, 30.0, [3], 200), 200, 2048, None),
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
            f"{ids.shape[1]} tiles of {th} x {tw}, "
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
                   warm: bool = True, by_name: dict | None = None,
                   ranges: dict | None = None) -> float:
    """torch.profiler over n runs of fn (after one untraced run when
    `warm`): device time by kernel, and the share of the traced window
    the device was busy (sum of kernel times over first kernel start to
    last kernel end).  Returns the kernel time per run in ms; `by_name`
    ({label: (substrings of kernel names)}) is filled in place with each
    label's device ms per run, `ranges` ({label: record_function name})
    with the device ms per run of the kernels launched inside that host
    range and the ranges per run."""
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
    # kernels only: a named host range may also show as a device-side
    # annotation spanning its kernels
    names = set((ranges or {}).values())
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and e.name not in names]
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    span = (max(e.time_range.end for e in kern)
            - min(e.time_range.start for e in kern)) / 1e3
    log(f"[profile] {name} x{n}: kernels {busy:.3f} ms in a "
        f"{span:.3f} ms window: device busy {100 * busy / span:.1f}%, "
        f"idle {100 * (1 - busy / span):.1f}%")
    for label, rname in (ranges or {}).items():
        ev = [e for e in prof.events() if e.name == rname
              and e.device_type == DeviceType.CPU]
        ranges[label] = dict(ms=sum(e.device_time_total for e in ev) / 1e3
                             / n, ranges=len(ev) // n)
    ka = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
          and e.key not in names]
    for label, subs in (by_name or {}).items():
        by_name[label] = sum(e.self_device_time_total for e in ka
                             if any(x in e.key for x in subs)) / 1e3 / n
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
    group_norm_parity()


def group_norm_parity() -> None:
    """norm "group" (flax's GroupNorm, groups of 16 channels) on the card:
    the canonical model at 128^2 with group norm and seeded weights, its
    frame on the card (the shipped route, pallas3) against the CPU's
    (plain versions) from the card's v_feature, to the conv routes'
    tolerances."""
    from rnr_tpu_torch.models.rnr import RNRModel
    from rnr_tpu_torch.synthetic import build_batch, init_weights, to_torch
    from rnr_tpu_torch.train.steps import make_rnr_eval_step
    card = init_weights(RNRModel(canonical_config(
        128, render_net=dict(norm="group")), GCN_V), seed=0)
    cpu = variant(card, device="cpu")
    nb = build_batch(128, GCN_V)
    bc, bh = to_torch(nb, DEV), to_torch(nb, "cpu")
    with torch.inference_mode():
        vf = card.compute_v_feature(bc["gcn_pos"])
    a = make_rnr_eval_step(card)(bc, v_feature=vf)["img"].float().cpu()
    r = make_rnr_eval_step(cpu)(bh, v_feature=vf.cpu())["img"].float()
    scale = float(r.abs().max())
    d = (a - r).abs()
    err, mean = float(d.max()), float(d.mean())
    log(f"[parity] group norm, pallas3: card vs CPU image 128^2: max abs err "
        f"{err:.4g} (rel {err / scale:.3g}, tol {5e-2 * scale:.4g}), mean "
        f"abs err {mean:.4g} (rel {mean / scale:.3g}, tol "
        f"{5e-3 * scale:.4g}), max |ref| {scale:.4g}")
    check("parity group norm max", err, 5e-2 * scale)
    check("parity group norm mean", mean, 5e-3 * scale)


def gcn_block_knn(state: dict) -> None:
    """K4 on the canonical GCN's own block features: the inputs that the
    slice's model gives stratified_knn in one GCN forward (eval, on the
    canonical batch's 7,500 points), each held to the plain version by
    compare_picks and bitwise over two runs (knn_case)."""
    import rnr_tpu_torch.models.gcn as gcn_mod
    seen = []
    real = gcn_mod.stratified_knn

    def record(x, width):
        seen.append(x.clone())
        return real(x, width)

    gcn_mod.stratified_knn = record
    try:
        with torch.inference_mode():
            state["model"].compute_v_feature(_gbuffer(IMG)["gcn_pos"])
    finally:
        gcn_mod.stratified_knn = real
    ties = [knn_case(x, f"GCN block {i} features") for i, x in
            enumerate(seen)]
    log(f"[slice] stratified_knn on the GCN's {len(seen)} stratified blocks' "
        f"features: {sum(t['differ'] for t in ties)} picks differ from the "
        f"plain version, {sum(t['exact_ties'] for t in ties)} exact ties, "
        f"{sum(t['near_ties'] for t in ties)} near-ties, none beyond the "
        "f32 rounding bound")


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


# the drivers phase: the offline workflow of scripts/preproc.sh,
# train_rnr.sh and test_rnr.sh through the port's own entry points, on a
# scene written by this script: the gbuffer phase's sphere as the mesh, a
# UV sphere of GCN_LAT_LON (60 x 125 = 7,500 vertices) as the GCN mesh,
# a ring of DRIVER_VIEWS views (the first DRIVER_TRAIN_VIEWS to train,
# the rest to validate) and the relight phase's probes
DRIVER_VIEWS = 10
DRIVER_TRAIN_VIEWS = 8
GCN_LAT_LON = (59, 124)
DRIVER_ITERS = 6
# kernels each driver run must launch (the drivers path): the training
# steps and validation (K1, K1b, K2, K2b, K3, K3b, K4), precompute and
# test_rnr (K7) and test_rnr's per-stage SH route (K5)
DRIVER_KERNELS = ("sh_shade_fan", "sh_shade_fan_bwd", "mipmap_gather",
                  "mipmap_scatter", "conv3x3", "conv3x3_wgrad",
                  "stratified_knn", "rasterize_tiles", "sh_shade")


def write_obj(path: str, mesh) -> None:
    """A mesh of synthetic.sphere_mesh (uv and normal per vertex) as OBJ,
    formatted row by row from Python lists (a million faces in seconds)."""
    rows = [("v %.7f %.7f %.7f\n", mesh.v), ("vt %.7f %.7f\n", mesh.vt),
            ("vn %.7f %.7f %.7f\n", mesh.vn),
            ("f %d/%d/%d %d/%d/%d %d/%d/%d\n",
             np.repeat(mesh.f_v_idx + 1, 3, axis=1))]
    with open(path, "w") as f:
        for fmt, a in rows:
            f.writelines(map(fmt.__mod__, map(tuple, a.tolist())))


def write_scene(root: str) -> None:
    """mesh.obj, mesh_7500v.obj, calib.mat (DRIVER_VIEWS views of the
    camera ring at IMG^2), rgb0/ and rgb1/ (a shaded disc per view and
    lighting, 8-bit PNG), lp/ (two procedural 256 x 512 HDR probes) and
    exr/, stitch_lp's default input: mesh.obj, calib.mat and
    rgb0/%03d.exr, rgb0's views over 255 as float32 ZIP OpenEXR."""
    import shutil

    import scipy.io
    from rnr_tpu_torch.data.imageio import write_exr, write_hdr, write_png
    from rnr_tpu_torch.synthetic import camera_ring, make_probes, sphere_mesh
    for d in ("rgb0", "rgb1", "lp", "exr/rgb0"):
        os.makedirs(os.path.join(root, d))
    write_obj(os.path.join(root, "mesh.obj"), sphere_mesh(*MESH_LAT_LON))
    write_obj(os.path.join(root, "mesh_7500v.obj"), sphere_mesh(*GCN_LAT_LON))
    views = camera_ring(IMG, DRIVER_VIEWS)
    yy, xx = np.mgrid[0:IMG, 0:IMG] / IMG
    disc = (np.hypot(yy - 0.5, xx - 0.5) < 0.4).astype(np.float32)
    for i in range(DRIVER_VIEWS):
        for light, shade in enumerate((0.4 + 0.6 * xx, 1.0 - 0.5 * yy)):
            img = disc[..., None] * shade[..., None] * np.array(
                [200.0, 150.0, 100.0]) * (0.8 + 0.02 * i)
            write_png(os.path.join(root, f"rgb{light}", "%06d.png" % i),
                      img.astype(np.uint8))
            if light == 0:
                write_exr(os.path.join(root, "exr", "rgb0", "%03d.exr" % i),
                          img.astype(np.uint8).astype(np.float32) / 255.0)
    for k, probe in enumerate(make_probes(N_PROBES, seed=0)):
        write_hdr(os.path.join(root, "lp", f"{k}.hdr"), probe)
    scipy.io.savemat(os.path.join(root, "calib.mat"), {
        "poses": np.stack([v["pose"] for v in views]),
        "projs": np.stack([v["proj"] for v in views]),
        "dist_coeffs": np.stack([v["dist_coeffs"] for v in views]),
        "img_hws": np.tile([IMG, IMG], (DRIVER_VIEWS, 1)),
        "global_RT": np.eye(4)})
    for f in ("mesh.obj", "calib.mat"):
        shutil.copy(os.path.join(root, f), os.path.join(root, "exr", f))


def _files(path: str) -> list:
    if not os.path.isdir(path):
        raise AssertionError(f"drivers: {path} is missing")
    return sorted(f for f in os.listdir(path) if not f.startswith("."))


def check_outputs(root: str, log_dir: str) -> None:
    """Every file the workflow writes: the two precompute trees, the
    stitch, the run's files and PNG directories."""
    stems = ["%06d" % i for i in range(DRIVER_VIEWS)]
    res = os.path.join(root, "precomp_mesh", f"resol_{IMG}")
    for sub in ("raster", "uv_map", "normal_map", "normal_map_cam",
                "position_map", "position_map_cam", "view_dir_map",
                "view_dir_map_cam", "view_dir_map_tangent", "sh_basis_map",
                "reflect_dir_map", "TBN_map", "proj"):
        if _files(os.path.join(res, sub)) != [s + ".mat" for s in stems]:
            raise AssertionError(f"drivers: precompute {sub} incomplete")
    for sub in ("alpha_map", "img_gt"):
        if _files(os.path.join(res, sub)) != [s + ".png" for s in stems]:
            raise AssertionError(f"drivers: precompute {sub} incomplete")
    low = os.path.join(root, "precomp_mesh_7500v", f"resol_{IMG}")
    if _files(low) != ["raster"] or len(_files(os.path.join(
            low, "raster"))) != DRIVER_VIEWS:
        raise AssertionError("drivers: the GCN mesh's raster is incomplete")
    st = os.path.join(root, f"light_probe_stitch_first_{DRIVER_TRAIN_VIEWS}")
    for f in ("0.png", "0.exr", "mask/0.png", "count/0.png", "count/0.mat"):
        if not os.path.isfile(os.path.join(st, f)):
            raise AssertionError(f"drivers: stitch_lp did not write {f}")
    for f in ("params.json", "model_final.ckpt",
              f"model_iter-{DRIVER_ITERS - 1}.ckpt", "summary.json"):
        if not os.path.isfile(os.path.join(log_dir, f)):
            raise AssertionError(f"drivers: train_rnr did not write {f}")
    for sub in ("val_out", "val_err", "val_gt", "val_relight_out"):
        if len(_files(os.path.join(log_dir, sub))) != (
                DRIVER_VIEWS - DRIVER_TRAIN_VIEWS):
            raise AssertionError(f"drivers: {sub} incomplete")


IMAGE_FIXTURES = os.path.join(ROOT, "tests", "data", "images")


def exr_stitch_equal(root: str, pattern: str) -> None:
    """stitch_lp at its default suffix on the scene's EXR views (exr/)
    against its `--img_suffix .png` run on the same values: the f32
    probe, its mask and counts equal."""
    import scipy.io
    from rnr_tpu_torch.data.imageio import read_exr, read_png
    a = os.path.join(root, f"light_probe_stitch_{pattern}")
    b = os.path.join(root, "exr", f"light_probe_stitch_{pattern}")
    if not np.array_equal(read_exr(os.path.join(a, "0.exr")),
                          read_exr(os.path.join(b, "0.exr"))):
        raise AssertionError("drivers: stitch_lp's 0.exr from EXR views "
                             "differs from its run on the PNG views")
    for f in ("0.png", "mask/0.png", "count/0.png"):
        if not np.array_equal(read_png(os.path.join(a, f)),
                              read_png(os.path.join(b, f))):
            raise AssertionError(f"drivers: stitch_lp's {f} from EXR views "
                                 "differs from its run on the PNG views")
    ca, cb = (scipy.io.loadmat(os.path.join(d, "count", "0.mat"))
              for d in (a, b))
    if not (np.array_equal(ca["count"], cb["count"])
            and ca["num_view"].item() == cb["num_view"].item()
            == DRIVER_TRAIN_VIEWS):
        raise AssertionError("drivers: stitch_lp's counts from EXR views "
                             "differ")


def image_formats(root: str, split: list, smi: str) -> None:
    """The formats rnr_tpu reads through cv2: train_rnr's reader of the
    stitched 0.exr; every committed JPEG / BMP fixture decoded (both cv2
    flags) bit-equal to its committed cv2 decode, with its host decode
    ms; train_dnr --tex_fp on the EXIF-6 JPEG fixture for two
    iterations at full width, its texture's level 0 starting from the
    JPEG's turned read."""
    from rnr_tpu_torch.data.imageio import (IMREAD_COLOR, IMREAD_UNCHANGED,
                                            read_exr, read_image, read_png,
                                            resize)
    from rnr_tpu_torch.drivers import train_dnr
    from rnr_tpu_torch.drivers.common import read_texture_init
    from rnr_tpu_torch.drivers.train_rnr import _read_stitch
    st = os.path.join(root, f"light_probe_stitch_{split[0]}")
    probe, cover = _read_stitch(st, 0, 1.0)
    covered = cover[..., 0] == 1
    if not (covered.any() and np.array_equal(
            probe[covered], read_exr(os.path.join(st, "0.exr"))[covered])):
        raise AssertionError("drivers: train_rnr's stitch reader does not "
                             "return 0.exr")
    names = sorted(f for f in os.listdir(IMAGE_FIXTURES)
                   if f.endswith((".jpg", ".bmp")))
    if len(names) < 10:
        raise AssertionError(f"drivers: {len(names)} image fixtures")
    ms = {}
    for name in names:
        path = os.path.join(IMAGE_FIXTURES, name)
        stem = os.path.splitext(path)[0]
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            img = read_image(path, IMREAD_UNCHANGED)
            times.append(time.perf_counter() - t0)
        ms[name] = 1e3 * min(times)
        color = (stem + ".color.png" if os.path.isfile(stem + ".color.png")
                 else stem + ".png")
        if not (np.array_equal(img, read_png(stem + ".png"))
                and np.array_equal(read_image(path, IMREAD_COLOR),
                                   read_png(color))):
            raise AssertionError(f"drivers: {name} decodes differently from "
                                 "its committed cv2 decode")
    log(f"[drivers] image fixtures ({len(names)}, 107 x 75) decoded "
        "bit-equal to their cv2 decodes under both flags; host decode ms "
        f"(best of 3, {smi}): "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    tex = os.path.join(IMAGE_FIXTURES, "exif6.jpg")
    want = read_texture_init(tex, 512)
    upright = resize(read_image(tex, IMREAD_UNCHANGED), (512, 512),
                     "area").astype(np.float32) / 255.0
    t0 = time.perf_counter()
    log_dir, mods = train_dnr.main([
        "--data_root", root, "--img_size", str(IMG), "--logging_root",
        os.path.join(root, "logs_tex"), "--texture_size", "512",
        "--texture_num_ch", str(DNR_CH), "--mipmap_level", "4", "--nf0",
        "64", "--sampling_pattern", split[0], "--sampling_pattern_val",
        split[1], "--max_iter", "2", "--val_freq", "100", "--ckp_freq",
        "100", "--log_freq", "100", "--tex_fp", tex])
    t_tex = time.perf_counter() - t0
    with open(os.path.join(log_dir, "summary.json")) as f:
        summary = json.load(f)
    level0 = mods.texture_mapper.texture_0.detach()[..., :3].cpu().numpy()
    moved = float(np.abs(level0 - want).max())
    if (summary["iters"] != 2 or not np.isfinite(summary["last_loss"])
            or moved > 0.01 or float(np.abs(upright - want).max()) < 0.1):
        raise AssertionError(f"drivers: train_dnr --tex_fp: summary "
                             f"{summary}, level 0 moved {moved:.3g} from the "
                             "JPEG's read")
    log(f"[drivers] train_dnr --tex_fp exif6.jpg: 2 iterations at full "
        f"width in {t_tex:.3f} s (main()), level 0 within {moved:.3g} of "
        "the JPEG's EXIF-turned read")
    del mods


def phase_drivers(driver_launches: dict, train_out: dict, smi: str) -> None:
    """The offline workflow through the port's entry points, in this
    process: precompute (both meshes), stitch_lp (on the PNG views, then
    at its default suffix on the same views as EXR), train_rnr at the
    canonical configuration for DRIVER_ITERS iterations (one validation,
    one checkpoint), then test_rnr.main on model_final.ckpt under the
    trained lighting, the novel probes by SH fit (also per stage) and by
    gather.  Checks every output file, the two stitches equal, finite
    losses and metrics, the checkpoint's round trip, test_rnr.main's
    frame bit-equal to the eval step's on the trained model, and the
    launches of DRIVER_KERNELS; then `image_formats`, and profiles the
    trained model's step on three sets of GCN points."""
    import shutil
    from rnr_tpu_torch.data import Mesh, ViewDataset, load_obj
    from rnr_tpu_torch.drivers import precompute, stitch_lp, test_rnr
    from rnr_tpu_torch.drivers import train_rnr
    from rnr_tpu_torch.models.rnr import RNRModel
    from rnr_tpu_torch.ops.gbuffer import make_mesh_buffers, render_gbuffer
    from rnr_tpu_torch.train.checkpoint import (load_checkpoint,
                                                save_checkpoint)
    from rnr_tpu_torch.train.steps import (create_rnr_optimizer,
                                           make_rnr_eval_step)
    root = os.path.join(ROOT, "build", "drivers_scene")
    shutil.rmtree(root, ignore_errors=True)
    write_scene(root)
    dr = ["--data_root", root, "--img_size", str(IMG)]
    split = [f"first_{DRIVER_TRAIN_VIEWS}", f"after_{DRIVER_TRAIN_VIEWS}"]
    reset_launches()
    t0 = time.perf_counter()
    precompute.main([*dr])
    t_pre = time.perf_counter() - t0
    t0 = time.perf_counter()
    precompute.main([*dr, "--obj_fp", "_/mesh_7500v.obj",
                     "--only_mesh_related", "true"])
    t_low = time.perf_counter() - t0
    t0 = time.perf_counter()
    stitch_lp.main(["--data_root", root, "--sampling_pattern", split[0],
                    "--img_suffix", ".png"])
    t_stitch = time.perf_counter() - t0
    t0 = time.perf_counter()
    stitch_lp.main(["--data_root", os.path.join(root, "exr"),
                    "--sampling_pattern", split[0]])
    t_stitch_exr = time.perf_counter() - t0
    exr_stitch_equal(root, split[0])
    t0 = time.perf_counter()
    log_dir, model = train_rnr.main([
        *dr, "--logging_root", os.path.join(root, "logs"),
        "--sampling_pattern", split[0], "--sampling_pattern_val", split[1],
        "--lighting_idx", "0", "--lighting_relight_idx", "1",
        "--lp_dir", "_/lp", "--rays_dtype", "bfloat16",
        "--unet_conv_backend", "pallas3", "--sphere_samples_fp",
        "nonexistent.mat", "--max_iter", str(DRIVER_ITERS),
        "--val_freq", str(DRIVER_ITERS - 1), "--ckp_freq",
        str(DRIVER_ITERS - 1), "--log_freq", "100"])
    t_train = time.perf_counter() - t0
    tr = ["--data_root", root, "--checkpoint_dir", log_dir,
          "--img_size", str(IMG), "--sphere_samples_fp", "nonexistent.mat"]
    runs = {}
    for name, extra in (
            ("train", ["--lighting_type", "train"]),
            ("sh", ["--lp_dir", "_/lp", "--save_lp_background", "true"]),
            ("gather", ["--lp_dir", "_/lp", "--lp_sh", "false"]),
            ("sh_staged", ["--lp_dir", "_/lp", "--per_stage_timing", "true",
                           "--sampling_pattern", split[1]])):
        out = os.path.join(log_dir, f"test_{name}")
        runs[name] = test_rnr.main([*tr, *extra, "--out_dir", out],
                                   keep_frames=name == "train")
        n_png = sum(len(_files(os.path.join(out, d))) for d in _files(out))
        if n_png != runs[name]["views"] * runs[name]["lightings"]:
            raise AssertionError(f"drivers: test_rnr {name} wrote {n_png} "
                                 "PNGs")
    torch.cuda.synchronize()
    driver_launches.update(read_launches())
    missing = [k for k in DRIVER_KERNELS if not driver_launches[k]]
    if missing:
        raise AssertionError(f"drivers: {missing} never launched")
    log(f"[drivers] launches on the drivers path: {driver_launches}")
    check_outputs(root, log_dir)
    image_formats(root, split, smi)

    with open(os.path.join(log_dir, "summary.json")) as f:
        summary = json.load(f)
    vals = [summary["first_loss"], summary["last_loss"],
            *summary["val"].values()]
    if summary["iters"] != DRIVER_ITERS or not np.isfinite(vals).all():
        raise AssertionError(f"drivers: summary {summary}")
    timing = summary["timing"]
    step_ms = train_out.get(1, {}).get("step_ms")
    log(f"[drivers] precompute: {t_pre / DRIVER_VIEWS:.4f} s/view with "
        f"every map ({DRIVER_VIEWS} views, .mat and .png writes "
        f"included), {t_low / DRIVER_VIEWS:.4f} s/view for the GCN mesh's "
        f"raster; stitch_lp {t_stitch:.3f} s ({DRIVER_TRAIN_VIEWS} views, "
        f"1600 x 3200 probe), {t_stitch_exr:.3f} s from the same views as "
        "ZIP EXR (its default suffix; probe, mask and counts equal)")
    log(f"[drivers] train_rnr: {timing['iters_per_s']:.3f} iterations/s "
        f"through the driver ({1e3 / timing['iters_per_s']:.3f} ms an "
        f"iteration over {timing['iters_timed']} after the first; "
        f"validation {timing['validate_s']:.3f} s, checkpoint "
        f"{timing['checkpoint_s']:.3f} s; main() {t_train:.3f} s in all) "
        "beside the bare step "
        + (f"{step_ms:.3f} ms (train phase, CUDA events)" if step_ms
           else "(not measured: the train phase did not run)")
        + f"; losses {summary['first_loss']:.6g} -> "
        f"{summary['last_loss']:.6g}")
    for name, r in runs.items():
        b = {k: round(v / r["views"], 6) for k, v in r["buckets"].items()}
        log(f"[drivers] test_rnr {name}: {r['views'] / r['render_s']:.3f} "
            f"views/s ({r['views']} views x {r['lightings']} lightings, PNG "
            f"writes included); per view, s: {b}")

    # the checkpoint: size, save and load seconds, and its round trip
    path = os.path.join(log_dir, "model_final.ckpt")
    opt = create_rnr_optimizer(model, 1e-3)
    t0 = time.perf_counter()
    save_checkpoint(path + ".again", model, opt, DRIVER_ITERS)
    t_save = time.perf_counter() - t0
    gcn_pos = load_obj(os.path.join(root, "mesh_7500v.obj")).v
    back = RNRModel(model.cfg, len(gcn_pos), l_dir=model.lighting.l_dir.cpu()
                    .numpy())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = load_checkpoint(path, back)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    if step != DRIVER_ITERS:
        raise AssertionError(f"drivers: checkpoint step {step}")
    for (k, a), (k2, b) in zip(model.state_dict().items(),
                               back.state_dict().items()):
        if k != k2 or not torch.equal(a, b):
            raise AssertionError(f"drivers: checkpoint round trip: {k}")
    log(f"[drivers] checkpoint {os.path.getsize(path) / 2 ** 20:.3f} MiB: "
        f"save {t_save:.3f} s, load {t_load:.3f} s; every tensor of "
        f"{len(back.state_dict())} equal after the round trip")

    # test_rnr.main's frame against the eval step's on the trained model
    ds = ViewDataset(root, os.path.join(root, "calib.mat"), (IMG, IMG),
                     load_img=False)
    mesh_buf = make_mesh_buffers(Mesh(os.path.join(root, "mesh.obj"),
                                      global_RT=np.eye(4, dtype=np.float32)))
    view = ds.read_view(DRIVER_TRAIN_VIEWS)
    with torch.inference_mode():
        vf = model.compute_v_feature(torch.from_numpy(gcn_pos).to(DEV))
    batch = test_rnr._to_batch(test_rnr._gbuffer(render_gbuffer, mesh_buf,
                                                 view, IMG), gcn_pos)
    (name, lp, sh), = test_rnr.lightings(model, lighting_idx=0)
    img = test_rnr.relit_frame(make_rnr_eval_step(model), batch, lp, sh, vf)
    got = runs["train"]["frames"][(view["img_fn"].split(".")[0], name)]
    if not torch.equal(img, got) or not bool(torch.isfinite(img).all()):
        raise AssertionError("drivers: test_rnr.main's frame differs from "
                             "the eval step's on the trained model: max "
                             f"{float((img - got).abs().max()):.3g}")
    log(f"[drivers] test_rnr.main's frame of view {view['img_fn']} under "
        f"{name} bit-equal to the eval step's on the trained model "
        f"(mean {float(img.mean()):.6g})")

    # the driver's step beside the train phase's: the trained model's
    # step on this view's G-buffer with the scene's GCN sphere (its poles
    # and seam repeat vertices), that sphere jittered by 1e-5, and the
    # train phase's GCN points; kernels a step by the profiler
    from rnr_tpu_torch.synthetic import build_batch, build_statics
    from rnr_tpu_torch.train.steps import make_generator, make_rnr_train_step
    tstep = make_rnr_train_step(model, create_rnr_optimizer(model, 1e-3))
    statics, gen = build_statics(model, 4096), make_generator(0)
    jitter = np.random.default_rng(0).standard_normal(gcn_pos.shape)
    points = {"scene sphere": gcn_pos,
              "scene sphere jittered": gcn_pos + 1e-5 * jitter,
              "train phase points": build_batch(IMG, len(gcn_pos))["gcn_pos"]}
    step_ms = {}
    for what, pos in points.items():
        b = dict(batch, gcn_pos=torch.as_tensor(pos, dtype=torch.float32,
                                                 device=DEV))
        step_ms[what] = profile_window(
            f"drivers: train step, {what}",
            lambda b=b: tstep(b, statics, gen), 1, top=2)
    log("[drivers] train step kernels by GCN points: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in step_ms.items()))
    del model, back, runs, tstep
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


# ------------------------------------------------------------------- DNR

DNR_ITERS = 20
DNR_CH = 30
DNR_SPIRAL = 8
# the kernels of the DNR path: the texture (K2, K2b), the U-Net's 3x3
# convs (K3, K3b) and test_dnr's G-buffer (K7); K6's pair under "pallas"
DNR_KERNELS = ("mipmap_gather", "mipmap_scatter", "conv3x3", "conv3x3_wgrad",
               "rasterize_tiles")
# the DNR step's kernels by name in the profiler: K3 with its reflect
# dgrad's ring fold, K3b with its split-K sum
DNR_PROFILE = {"mipmap_gather": ("mipmap_gather_kernel",),
               "mipmap_scatter": ("mipmap_scatter_kernel",),
               "conv3x3": ("conv3x3_kernel", "fold_ring_kernel"),
               "conv3x3_wgrad": ("wgrad_kernel", "reduce_splits"),
               "down4": ("conv4_kernel",)}


def dnr_want(mods, train: bool) -> dict:
    """The launches of one DNR step (train) or eval frame of `mods`: K2
    once, K2b once a step.  The U-Net computes in f32, so each conv takes
    its kernel three times (conv_cuda.f32_by_three) and each weight
    gradient six (conv_cuda.f32_by_six): per 3x3 conv K3 3 and, in a step,
    3 for its data gradient and K3b 6; under "pallas" per
    4x4 down conv down4 3, per transpose conv convt4 3 and, in a step,
    down4 3 for its data gradient (the down convs' is the plain conv's
    under reflect padding)."""
    from rnr_tpu_torch.models.unet import Conv, ConvTranspose
    ms = list(mods.render_net.modules())
    n3 = sum(isinstance(m, Conv) and m.route == "k3" for m in ms)
    nd = sum(isinstance(m, Conv) and m.route == "down4" for m in ms)
    nt = sum(isinstance(m, ConvTranspose) and m.route == "convt4" for m in ms)
    want = dict.fromkeys(KERNELS, 0)
    want.update(mipmap_gather=1, mipmap_scatter=int(train),
                conv3x3=3 * n3 * (1 + int(train)),
                conv3x3_wgrad=6 * n3 * int(train),
                down4=3 * nd + 3 * nt * int(train), convt4=3 * nt)
    return want


def counted(fn, want: dict, tag: str):
    """fn() with the launch counts set to 0 just before it and read just
    after, each equal to `want`'s: (the counts, fn's result)."""
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    got = read_launches()
    bad = {k: (got[k], n) for k, n in want.items() if got[k] != n}
    if bad:
        raise AssertionError(f"{tag}: launches (got, expected) {bad}")
    log(f"[dnr] launches in one {tag}: "
        + json.dumps({k: v for k, v in got.items() if v}))
    return got, out


DNR_PARITY_IMG = 128
# the f32 route's limit at the U-Net's own inputs, as
# tests/test_torch_cuda.py::test_f32_activations_take_three_launches
CONV_F32_TOL = 5e-5


def dnr_card_vs_cpu(cfg) -> None:
    """One DNR loss, every gradient and the eval frame at 128^2 on the
    card (kernels, the f32 convs by three bf16 launches, their weight
    gradients by six) and on the CPU
    (plain f32 versions): the same seeded weights and a random batch of
    its own seed, dropout off.  The loss and the frame within 1e-4 (the
    f32 cuDNN 4x4 convs and the split products round apart); each
    parameter's gradient at a cosine of at least 0.999 with the CPU's and
    a norm within 1% (five levels of batch statistics amplify those
    roundings in the backward; the largest elementwise error is
    reported).  The conv kernels themselves are held elementwise at
    512^2 by dnr_conv_parity."""
    from rnr_tpu_torch.drivers.train_dnr import _synthetic_views, make_batch
    from rnr_tpu_torch.train import steps as st
    from rnr_tpu_torch.train.losses import image_l1_loss
    s = DNR_PARITY_IMG
    views = _synthetic_views(np.random.default_rng(128), 1, s)
    out = []
    for d in (DEV, torch.device("cpu")):
        mods = st.init_dnr_params(st.build_dnr_modules(cfg, device=d), 0)
        mods.render_net.Unet_0.use_dropout = False
        b = make_batch(views, d)
        img, _ = st.dnr_forward(mods, b, train=True,
                                sh_start_ch=cfg.sh_start_ch)
        loss = image_l1_loss(img, b["img_gt"], b["alpha_map"],
                             cfg.loss.border_crop)
        loss.backward()
        frame = st.make_dnr_eval_step(cfg, mods)(b)
        out.append((float(loss.detach()), frame.cpu(),
                    {n: p.grad.cpu() for n, p in mods.named_parameters()}))
    (la, fa, ga), (lr, fr, gr) = out
    check("dnr card vs CPU loss", abs(la - lr), 1e-4 * abs(lr))
    check("dnr card vs CPU frame", float((fa - fr).abs().max()),
          1e-4 * float(fr.abs().max()))
    rel, cos, ratio = {}, {}, {}
    for n in gr:
        a, r = ga[n].double().flatten(), gr[n].double().flatten()
        rel[n] = float((a - r).abs().max() / r.abs().max())
        cos[n] = float(a @ r / (a.norm() * r.norm()))
        ratio[n] = float(a.norm() / r.norm())
    worst = max(rel, key=rel.get)
    log(f"[dnr] card vs CPU at {s}^2 (f32 U-Net, dropout off): loss "
        f"{la:.7g} / {lr:.7g}, frame max abs err "
        f"{float((fa - fr).abs().max()):.3g}; of the {len(gr)} gradients "
        f"the largest max abs err {rel[worst]:.3g} of its largest "
        f"({worst}), lowest cosine {min(cos.values()):.7f}, norm ratios "
        f"{min(ratio.values()):.6f}..{max(ratio.values()):.6f}")
    for n in gr:
        check(f"dnr card vs CPU gradient {n}: 1 - cosine", 1 - cos[n], 1e-3)
        check(f"dnr card vs CPU gradient {n}: |norm ratio - 1|",
              abs(ratio[n] - 1), 1e-2)


def dnr_conv_parity(step) -> dict:
    """K3's forward, K3's data gradient and K3b on the f32 route
    (conv_cuda.f32_by_three, three bf16 launches; f32_by_six, six, for
    K3b) at the inputs that one DNR train step at full width gives them,
    captured from the step (as gcn_block_knn captures K4's): each output
    within CONV_F32_TOL of the largest value of the plain f32 version on
    the same inputs (TF32 off).  The control, one bf16 launch on the same
    inputs with an f32 output, must fail the same check (miss the limit
    on at least one call of each kind: a weight gradient's sum over 512^2
    pixels can average one pass's roundings below it), so the check can
    tell the f32 route from one pass.  Each call's errors against the
    float64 sums are logged beside, the plain version's too.  Returns per
    kind the calls, the route's largest error, the control's smallest
    and largest, the calls where the control misses, and the largest
    errors against float64."""
    from rnr_tpu_torch.ops import conv_cuda as cc
    bf = torch.bfloat16
    real = {k: getattr(cc, f"conv3x3_{k}") for k in ("fwd", "dgrad", "wgrad")}
    seen = {k: [] for k in real}
    real_vjp = cc._vjp

    def fwd(x, w, b, pad_mode):
        seen["fwd"].append([x.detach().clone(), w.detach().clone(),
                            b.detach().clone(), pad_mode])
        return real["fwd"](x, w, b, pad_mode)

    def vjp(ctx, g, dgrad, wgrad):
        # the backward's operands as _vjp gives them to its dgrad / wgrad
        x, w = ctx.saved_tensors
        gx = g.to(x.dtype).detach().clone()
        seen["dgrad"].append([gx, w.detach().clone(), ctx.pad_mode])
        seen["wgrad"].append([x.detach().clone(), gx, ctx.pad_mode])
        return real_vjp(ctx, g, dgrad, wgrad)

    cc.conv3x3_fwd, cc._vjp = fwd, vjp
    try:
        step()
        torch.cuda.synchronize()
    finally:
        cc.conv3x3_fwd, cc._vjp = real["fwd"], real_vjp
    # (the route, the plain f32 version, the one-pass control) per kind
    runs = {
        "fwd": lambda x, w, b, p: (
            real["fwd"](x, w, b, p), cc.conv3x3_torch(x, w, b, p),
            real["fwd"](x.to(bf), w, b, p, torch.float32)),
        "dgrad": lambda g, w, p: (
            real["dgrad"](g, w, p), cc.conv3x3_dgrad_torch(g, w, p),
            real["dgrad"](g.to(bf), w, p)),
        "wgrad": lambda x, g, p: (
            real["wgrad"](x, g, p), cc.conv3x3_wgrad_torch(x, g, p),
            real["wgrad"](x.to(bf), g.to(bf), p))}
    f64 = torch.float64

    def conv64(x, w):
        return torch.nn.functional.conv2d(
            x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
            padding=1).permute(0, 2, 3, 1)

    # the same functions in float64: how far the f32 plain version itself
    # lies from the exact sums
    exact = {
        "fwd": lambda x, w, b, p: torch.nn.functional.conv2d(
            cc._pad_nhwc(x.to(f64), p).permute(0, 3, 1, 2),
            w.to(f64).permute(3, 2, 0, 1)).permute(0, 2, 3, 1) + b.to(f64),
        "dgrad": lambda g, w, p: cc._dgrad(g.to(f64), w.to(f64), p, conv64),
        "wgrad": lambda x, g, p: torch.stack([
            torch.einsum("nhwc,nhwo->co", cc._pad_nhwc(x.to(f64), p)[
                :, dy:dy + x.shape[1], dx:dx + x.shape[2]], g.to(f64))
            for dy in range(3) for dx in range(3)]).reshape(
                3, 3, x.shape[-1], g.shape[-1])}
    out, errs = {}, {}
    for kind, calls in seen.items():
        if not calls or any(t.dtype != torch.float32 for a in calls
                            for t in a[:2]):
            raise AssertionError(f"dnr conv parity: {len(calls)} {kind} "
                                 "calls captured, all must be f32")
        e = errs[kind] = {"route": [], "control": [], "route_exact": [],
                          "plain_exact": [], "shapes": []}
        for a in calls:
            k, p, one = runs[kind](*a)
            x64 = exact[kind](*a)
            scale, s64 = float(p.abs().max()), float(x64.abs().max())
            if not scale > 0:
                raise AssertionError(f"dnr conv parity {kind}: plain "
                                     "output all zero")
            e["route"].append(float((k - p).abs().max()) / scale)
            e["control"].append(float((one - p).abs().max()) / scale)
            e["route_exact"].append(float((k.to(f64) - x64).abs().max())
                                    / s64)
            e["plain_exact"].append(float((p.to(f64) - x64).abs().max())
                                    / s64)
            e["shapes"].append([tuple(a[0].shape), tuple(a[1].shape)])
        out[kind] = dict(calls=len(calls), route_max_rel=max(e["route"]),
                         one_pass_min_rel=min(e["control"]),
                         one_pass_max_rel=max(e["control"]),
                         one_pass_calls_beyond=sum(
                             x > CONV_F32_TOL for x in e["control"]),
                         route_vs_f64_max_rel=max(e["route_exact"]),
                         plain_vs_f64_max_rel=max(e["plain_exact"]))
        del calls[:]
    log("[dnr] f32 route per call (route vs plain f32, one pass vs plain "
        "f32, route vs f64, plain f32 vs f64, each over the reference's "
        "largest value): " + json.dumps(
            {k: [[f"{v['route'][i]:.3g}", f"{v['control'][i]:.3g}",
                  f"{v['route_exact'][i]:.3g}", f"{v['plain_exact'][i]:.3g}",
                  v["shapes"][i]] for i in range(len(v["route"]))]
             for k, v in errs.items()}))
    log(f"[dnr] the f32 route at the DNR step's own conv inputs ({IMG}^2), "
        f"error over the plain f32 version's largest value, limit "
        f"{CONV_F32_TOL}: " + json.dumps(
            {k: {n: float(f"{x:.3g}") if isinstance(x, float) else x
                 for n, x in v.items()} for k, v in out.items()}))
    for kind, e in errs.items():
        for i, err in enumerate(e["route"]):
            check(f"dnr conv parity {kind} {i} {e['shapes'][i]} (route)",
                  err, CONV_F32_TOL)
        if not out[kind]["one_pass_calls_beyond"]:
            raise AssertionError(
                f"dnr conv parity {kind}: one bf16 pass within "
                f"{CONV_F32_TOL} on all {len(e['control'])} calls (largest "
                f"{max(e['control']):.3g}): the check cannot tell it from "
                "the f32 route")
    return out


def f32_glue_ranges():
    """conv_cuda's f32 route with its operand splits (split_bf16) and its
    sums of the products (add_parts) each in a named profiler range, for
    profile_window's `ranges`; restore with the returned function."""
    from torch.profiler import record_function

    from rnr_tpu_torch.ops import conv_cuda as cc
    real = {"split_bf16": cc.split_bf16, "add_parts": cc.add_parts}

    def ranged(name):
        def f(*a, **k):
            with record_function(f"f32 route: {name}"):
                return real[name](*a, **k)
        return f

    for name in real:
        setattr(cc, name, ranged(name))
    return lambda: [setattr(cc, n, f) for n, f in real.items()]


def phase_dnr(dnr_launches: dict, rec: dict) -> None:
    """The DNR vertical through the port's entry points, in this process,
    on the drivers phase's scene (written under build/dnr_scene/):
    precompute, train_dnr at full width (512^2, texture 512^2 x 30 x 4
    levels, nf0 64, 5 downs, batch 1, apply_sh, "auto") for DNR_ITERS
    iterations (one validation, one checkpoint), test_dnr.main on
    model_final.ckpt, make_spiral (DNR_SPIRAL steps) and test_dnr on the
    spiral.  Checks every file, finite losses and metrics, the launches
    of DNR_KERNELS on that path, test_dnr's frame bit-equal to the eval
    step's on the trained model, then the launches of one step and one
    frame against dnr_want, their CUDA-event medians and the step's
    share in kernels; K2 and K2b at C 30 against their plain versions
    (and on misaligned views); one step under "pallas" (K6a, K6b)."""
    import shutil
    from rnr_tpu_torch.data import Mesh, ViewDataset
    from rnr_tpu_torch.drivers import (make_spiral, precompute, test_dnr,
                                       train_dnr)
    from rnr_tpu_torch.drivers.test_rnr import _gbuffer
    from rnr_tpu_torch.ops.gbuffer import make_mesh_buffers, render_gbuffer
    from rnr_tpu_torch.train import steps as st
    root = os.path.join(ROOT, "build", "dnr_scene")
    shutil.rmtree(root, ignore_errors=True)
    write_scene(root)
    dr = ["--data_root", root, "--img_size", str(IMG)]
    split = [f"first_{DRIVER_TRAIN_VIEWS}", f"after_{DRIVER_TRAIN_VIEWS}"]
    t0 = time.perf_counter()
    precompute.main(dr)
    t_pre = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    log_dir, mods = train_dnr.main([
        *dr, "--logging_root", os.path.join(root, "logs"),
        "--texture_size", "512", "--texture_num_ch", str(DNR_CH),
        "--mipmap_level", "4", "--nf0", "64", "--sampling_pattern", split[0],
        "--sampling_pattern_val", split[1], "--max_iter", str(DNR_ITERS),
        "--val_freq", str(DNR_ITERS - 1), "--ckp_freq", str(DNR_ITERS - 1),
        "--log_freq", "100"])
    t_train = time.perf_counter() - t0
    tr = ["--data_root", root, "--checkpoint_dir", log_dir, "--img_size",
          str(IMG)]
    t0 = time.perf_counter()
    res = test_dnr.main([*tr, "--out_dir", os.path.join(log_dir, "test")],
                        keep_frames=True)
    t_test = time.perf_counter() - t0
    make_spiral.main(["--data_root", root, "--num_step", str(DNR_SPIRAL),
                      "--out_dir", "_/test_seq/spiral"])
    spiral = test_dnr.main([*tr, "--calib_dir", "_/test_seq/spiral",
                            "--out_dir", os.path.join(log_dir, "spiral")])
    torch.cuda.synchronize()
    dnr_launches["path"] = read_launches()
    missing = [k for k in DNR_KERNELS if not dnr_launches["path"][k]]
    if missing:
        raise AssertionError(f"dnr: {missing} never launched")
    log(f"[dnr] launches on the DNR path: {dnr_launches['path']}")

    for f in ("params.json", "model_final.ckpt",
              f"model_iter-{DNR_ITERS - 1}.ckpt", "summary.json"):
        if not os.path.isfile(os.path.join(log_dir, f)):
            raise AssertionError(f"dnr: train_dnr did not write {f}")
    for sub, n in (("val_out", DRIVER_VIEWS - DRIVER_TRAIN_VIEWS),
                   ("test", DRIVER_VIEWS), ("spiral", DNR_SPIRAL)):
        if len(_files(os.path.join(log_dir, sub))) != n:
            raise AssertionError(f"dnr: {sub} holds "
                                 f"{len(_files(os.path.join(log_dir, sub)))}"
                                 f" files, expected {n}")
    if (res["views"], spiral["views"]) != (DRIVER_VIEWS, DNR_SPIRAL):
        raise AssertionError(f"dnr: test_dnr rendered {res['views']} and "
                             f"{spiral['views']} views")
    with open(os.path.join(log_dir, "summary.json")) as f:
        summary = json.load(f)
    vals = [summary["first_loss"], summary["last_loss"],
            *summary["val"].values()]
    if summary["iters"] != DNR_ITERS or not np.isfinite(vals).all():
        raise AssertionError(f"dnr: summary {summary}")
    timing = summary["timing"]
    log(f"[dnr] precompute {t_pre / DRIVER_VIEWS:.4f} s/view; train_dnr "
        f"{timing['iters_per_s']:.3f} iterations/s through the driver "
        f"({1e3 / timing['iters_per_s']:.3f} ms an iteration over "
        f"{timing['iters_timed']} after the first; validation "
        f"{timing['validate_s']:.3f} s, checkpoint "
        f"{timing['checkpoint_s']:.3f} s; main() {t_train:.3f} s in all); "
        f"losses {summary['first_loss']:.6g} -> {summary['last_loss']:.6g}; "
        f"val {summary['val']}; test_dnr.main {res['views'] / res['render_s']:.3f}"
        f" views/s ({t_test:.3f} s with the checkpoint's load), the spiral "
        f"{spiral['views'] / spiral['render_s']:.3f} views/s (PNG writes "
        "included)")

    # test_dnr.main's frame against the eval step's on the trained model
    cfg = mods.cfg
    eval_step = st.make_dnr_eval_step(cfg, mods)
    ds = ViewDataset(root, os.path.join(root, "calib.mat"), (IMG, IMG),
                     load_img=False)
    mesh_buf = make_mesh_buffers(Mesh(os.path.join(root, "mesh.obj"),
                                      global_RT=np.eye(4, dtype=np.float32)))
    view = ds.read_view(DRIVER_TRAIN_VIEWS)
    gbatch = test_dnr.gbuffer_batch(_gbuffer(render_gbuffer, mesh_buf, view,
                                             IMG))
    reruns = [eval_step(gbatch) for _ in range(2)]
    if not torch.equal(reruns[0], reruns[1]):
        raise AssertionError("dnr: two eval frames differ by "
                             f"{float((reruns[0] - reruns[1]).abs().max()):.3g}")
    img = reruns[0][0] * gbatch["alpha_map"][0]
    got = res["frames"][view["img_fn"].split(".")[0]]
    if not torch.equal(img, got) or not bool(torch.isfinite(img).all()):
        raise AssertionError("dnr: test_dnr.main's frame differs from the "
                             "eval step's on the trained model: max "
                             f"{float((img - got).abs().max()):.3g}")
    log(f"[dnr] test_dnr.main's frame of view {view['img_fn']} bit-equal to "
        f"the eval step's on the trained model (mean {float(img.mean()):.6g};"
        f" two eval frames bit-equal)")

    # one step and one frame: launches, times, the step's share in kernels
    tds = ViewDataset(root, os.path.join(root, "calib.mat"), (IMG, IMG),
                      img_dir=os.path.join(root, "rgb0"),
                      load_precompute=True,
                      precomp_high_dir=os.path.join(root, "precomp_mesh"),
                      precomp_low_dir=os.path.join(root, "precomp_mesh"))
    b = train_dnr.make_batch([tds.read_view(0)], DEV)
    gen = st.make_generator(0)
    step = st.make_dnr_train_step(cfg, mods,
                                  st.create_rnr_optimizer(mods, 1e-3))
    step(b, gen)
    dnr_launches["step"], met = counted(lambda: step(b, gen),
                                        dnr_want(mods, True), "DNR step")
    if not all(np.isfinite(float(v)) for v in met.values()):
        raise AssertionError(f"dnr: step metrics {met}")
    dnr_launches["frame"], _ = counted(lambda: eval_step(b),
                                       dnr_want(mods, False), "DNR frame")
    step_ms = cuda_ms(lambda: step(b, gen), iters=5, warmup=1)
    frame_ms = cuda_ms(lambda: eval_step(b))
    # the f32 route's glue (its operand splits and output sums) by name
    glue = {"split": "f32 route: split_bf16", "sum": "f32 route: add_parts"}
    s_by, s_glue = dict(DNR_PROFILE), dict(glue)
    f_by, f_glue = dict(DNR_PROFILE), dict(glue)
    restore = f32_glue_ranges()
    try:
        s_k = profile_window("dnr: train step", lambda: step(b, gen), 3,
                             top=10, by_name=s_by, ranges=s_glue)
        f_k = profile_window("dnr: eval frame", lambda: eval_step(b), 5,
                             top=6, by_name=f_by, ranges=f_glue)
    finally:
        restore()
    log(f"[dnr] step {step_ms:.3f} ms (CUDA events, median of 5), "
        f"{s_k:.3f} ms in kernels ({100 * s_k / step_ms:.1f}% of the "
        f"step); frame {frame_ms:.3f} ms (median of 10), {f_k:.3f} ms in "
        f"kernels ({100 * f_k / frame_ms:.1f}%); by kernel a step "
        + json.dumps({k: round(v, 4) for k, v in s_by.items()})
        + ", a frame " + json.dumps({k: round(v, 4) for k, v in f_by.items()})
        + "; the f32 route's glue (device ms of the kernels in its ranges, "
        "ranges) a step " + json.dumps(s_glue) + ", a frame "
        + json.dumps(f_glue))
    for name in DNR_PROFILE:
        rec.setdefault(name, {})["dnr"] = dict(
            step_kernel_ms=s_by[name], frame_kernel_ms=f_by[name],
            launches_step=dnr_launches["step"][name],
            launches_frame=dnr_launches["frame"][name])
    rec.setdefault("dnr_step", {}).update(
        step_ms=step_ms, frame_ms=frame_ms, step_kernel_ms=s_k,
        frame_kernel_ms=f_k, step_f32_glue=s_glue, frame_f32_glue=f_glue)
    parity = dnr_conv_parity(lambda: step(b, gen))
    rec["conv3x3"]["dnr"]["f32_route"] = {k: parity[k]
                                          for k in ("fwd", "dgrad")}
    rec["conv3x3_wgrad"]["dnr"]["f32_route"] = parity["wgrad"]

    # K2 and K2b at the DNR shape: 4 levels 512..64 x 30 channels on the
    # scene's uv (its own seed)
    rng = np.random.default_rng(30)
    texs = [torch.from_numpy((0.5 + 0.5 * rng.standard_normal(
        (s, s, DNR_CH))).astype(np.float32)).to(DEV) for s in TEX_SIZES]
    uv = b["uv_map"].contiguous()
    n_pix = IMG * IMG
    r, _ = gather_case(texs, uv, f"DNR view uv, C {DNR_CH}")
    r["plain_ms"] = cuda_ms(lambda: mipmap_sample_torch(texs, uv))
    g = torch.from_numpy(rng.standard_normal((1, IMG, IMG, DNR_CH)).astype(
        np.float32)).to(DEV)
    err, rerun, taps = scatter_case(uv, g, f"DNR view uv, C {DNR_CH}")
    sc = dict(max_abs_err=err, rerun_max_diff=rerun,
              ms=cuda_ms(lambda: mipmap_scatter(uv, g, TEX_SIZES)),
              queued_ms=queued_ms(lambda: mipmap_scatter(uv, g, TEX_SIZES)),
              host_us=host_us(lambda: mipmap_scatter(uv, g, TEX_SIZES)),
              plain_ms=cuda_ms(lambda: mipmap_scatter_torch(uv, g, TEX_SIZES),
                               iters=3, warmup=1),
              **texture_work(n_pix, DNR_CH, TEX_SIZES, taps))
    log(f"[dnr] mipmap_scatter C {DNR_CH}: {sc['ms']:.4f} ms, queued "
        f"{sc['queued_ms']:.4f} ms, host {sc['host_us']:.1f} us, plain "
        f"{sc['plain_ms']:.4f} ms; bound {sc['bound_ms']:.4f} ms "
        f"({sc['bound_by']}), {scatter_bytes(n_pix, DNR_CH) / sc['ms'] / 1e6:.1f}"
        " GB/s")
    misaligned_views(texs, uv, 1)
    rec["mipmap_gather"]["dnr"]["shape"] = r
    rec["mipmap_scatter"]["dnr"]["shape"] = sc

    dnr_card_vs_cpu(override(cfg, train=dict(img_size=DNR_PARITY_IMG)))

    # one step under "pallas": K6a / K6b on the U-Net's 4x4 convs
    pcfg = override(cfg, render_net=dict(conv_backend="pallas"))
    pm = st.build_dnr_modules(pcfg)
    pm.load_state_dict(mods.state_dict())
    pstep = st.make_dnr_train_step(pcfg, pm, st.create_rnr_optimizer(pm, 1e-3))
    pstep(b, gen)
    dnr_launches["pallas_step"], pmet = counted(
        lambda: pstep(b, gen), dnr_want(pm, True), "DNR step under pallas")
    if not np.isfinite(float(pmet["loss"])):
        raise AssertionError(f"dnr: pallas step loss {pmet['loss']}")
    p_ms = cuda_ms(lambda: pstep(b, gen), iters=3, warmup=0)
    rec["dnr_step"]["pallas_step_ms"] = p_ms
    log(f"[dnr] step under pallas {p_ms:.3f} ms (CUDA events, median of "
        f"3), loss {float(pmet['loss']):.6g}")
    del mods, pm, step, pstep, eval_step
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


# ------------------------------------------------------------- edge_grad

# 480^2: K7's 32 x 128 tiles do not divide the frame, so the last column
# of tiles is cut to 96 pixels (at 224^2 on 32 x 128 tiles the sphere's
# pole overflows a tile's 2048 candidates, and the oracle is taken)
EDGE_SIZES = (480, 256, 512)
# the sphere's pole puts more than K7's 2048 candidates in a tile (the
# last column of tiles cut to 64): the overflow rule's case
EDGE_OVERFLOW_SIZE = 320
EDGE_FIT_STEPS = 20
EDGE_FIT_SIZE = 256
EDGE_ELEVATION = 30.0


def k7_tiles(s: int) -> tuple[int, int, int, int]:
    """K7's tiles at an s^2 frame on the differentiable paths: tile rows
    and columns (min 32 x 128 with s), then tiles down and across."""
    th, tw = min(32, s), min(128, s)
    return (th, tw, *tile_grid(s, th, tw))


def edge_case(faces: torch.Tensor, s: int, rng) -> dict:
    """silhouette and rasterize_opt on faces at s^2 against the same
    Functions on the oracle's winner maps (backend "xla"): K7 once a call,
    overflow 0 and no oracle run; K7's face index, weights and alpha
    bit-equal to rasterize_face_index's (its depth within one f32 rounding)
    and both Functions' forward outputs too; the gradients of a random
    weighting
    within 1e-5 of the largest; times of the forward and of forward +
    backward."""
    from rnr_tpu_torch.ops import edge_grad as eg
    from rnr_tpu_torch.ops.rasterize import rasterize_face_index
    tag = f"{faces.shape[1]} faces at {s}^2"
    eg.ORACLE_TAKEN.update(overflow=0)
    reset_launches()
    win = eg._rasterize_winner(faces, s, 0.0, 100.0)
    torch.cuda.synchronize()
    overflow = int(win.overflow.sum())
    ref = rasterize_face_index(faces, s, near=0.0, far=100.0)
    for k in ("face_index_map", "weight_map", "alpha_map"):
        if not torch.equal(getattr(win, k), getattr(ref, k)):
            raise AssertionError(f"edge_grad {tag}: K7's {k} differs from "
                                 "rasterize_face_index's")
    # the z-buffer's depth (used by neither Function: rasterize_opt
    # recomputes it from the face index) may differ by an f32 rounding
    dd = (win.depth_map - ref.depth_map).abs()
    check(f"edge_grad {tag} depth_map", float(dd.max()),
          2 ** -22 * float(ref.depth_map.abs().max()))
    w1 = torch.from_numpy(rng.uniform(0.2, 1, (1, s, s)).astype(
        np.float32)).to(DEV)
    w3 = torch.from_numpy(rng.uniform(0.2, 1, (1, 3, s, s)).astype(
        np.float32)).to(DEV)
    tex = torch.from_numpy(rng.uniform(0, 1, (1, faces.shape[1], 2, 2, 2, 3))
                           .astype(np.float32)).to(DEV)

    def sil(backend):
        f = faces.detach().clone().requires_grad_(True)
        a = eg.silhouette(f, s, 0.0, 100.0, backend)
        (a * w1).sum().backward()
        return a.detach(), f.grad

    def opt(backend):
        f = faces.detach().clone().requires_grad_(True)
        t = tex.clone().requires_grad_(True)
        o = eg.rasterize_opt(f, t, s, near=0.0, far=100.0, backend=backend)
        ((o["rgb"] * w3).sum() + (o["alpha"] * w1).sum()
         + (o["depth"] * w1).sum() * 1e-3).backward()
        return [o[k].detach() for k in ("rgb", "alpha", "depth")], (f.grad,
                                                                    t.grad)

    reset_launches()
    a, ga = sil("auto")
    o, go = opt("auto")
    torch.cuda.synchronize()
    k7 = rasterize_tiles.launches
    if k7 != 2 or eg.ORACLE_TAKEN != {"overflow": 0}:
        raise AssertionError(f"edge_grad {tag}: K7 launched {k7} times for "
                             f"2 calls, oracle taken {eg.ORACLE_TAKEN}")
    ra, rga = sil("xla")
    ro, rgo = opt("xla")
    if not torch.equal(a, ref.alpha_map) or not torch.equal(a, ra) or any(
            not torch.equal(x, y) for x, y in zip(o, ro)):
        raise AssertionError(f"edge_grad {tag}: forward differs from the "
                             "oracle's")
    errs = {}
    for name, got, want in (("silhouette d faces", ga, rga),
                            ("rasterize_opt d faces", go[0], rgo[0]),
                            ("rasterize_opt d textures", go[1], rgo[1])):
        scale = float(want.abs().max())
        errs[name] = float((got - want).abs().max())
        if not scale > 0:
            raise AssertionError(f"edge_grad {tag}: {name} is all zero")
        check(f"edge_grad {tag} {name}", errs[name], 1e-5 * scale)
    times = dict(
        silhouette_fwd_ms=cuda_ms(lambda: eg.silhouette(faces, s, 0.0,
                                                        100.0)),
        silhouette_ms=cuda_ms(lambda: sil("auto")),
        rasterize_opt_fwd_ms=cuda_ms(lambda: eg.rasterize_opt(
            faces, tex, s, near=0.0, far=100.0)),
        rasterize_opt_ms=cuda_ms(lambda: opt("auto")),
        oracle_fwd_ms=cuda_ms(lambda: rasterize_face_index(
            faces, s, near=0.0, far=100.0), iters=3, warmup=1))
    log(f"[edge_grad] {tag}: tiles {k7_tiles(s)}, overflow "
        f"{overflow}, K7 {k7} times in 2 calls, oracle taken 0 times; "
        "face index, weights, alpha and both forwards "
        f"bit-equal to the oracle's, {int((dd > 0).sum())} depth pixels off "
        f"by up to {float(dd.max()):.3g}; "
        f"gradients against the oracle's maps, max abs err "
        + json.dumps({k: float(f"{v:.3g}") for k, v in errs.items()})
        + "; ms (CUDA events) "
        + json.dumps({k: round(v, 4) for k, v in times.items()}))
    return dict(tiles=list(k7_tiles(s)), overflow=overflow, calls=2,
                k7_launches=k7, **times)


def phase_edge_grad(edge_launches: dict, rec: dict) -> None:
    """The differentiable rasterizer on the card: silhouette and
    rasterize_opt on the scene's UV sphere (MESH_LAT_LON) from a view of
    the camera ring at each of EDGE_SIZES (edge_case), the overflow rule
    at EDGE_OVERFLOW_SIZE, then a 20-step Adam
    silhouette fit at 256^2 toward the same sphere's silhouette scaled by
    0.92 and moved by (0.04, -0.03) in NDC: the loss falls, K7 once a
    step, the oracle never."""
    from rnr_tpu_torch.ops import edge_grad as eg
    from rnr_tpu_torch.ops.rasterize import rasterize_face_index
    rng = np.random.default_rng(17)
    out = {}
    for s in EDGE_SIZES:
        out[s] = edge_case(ring_faces(*MESH_LAT_LON, EDGE_ELEVATION, [0], s),
                           s, rng)
    # the overflow rule on the card: K7 once, its overflow reported, and
    # the oracle's maps returned, taken once if K7 overflowed
    s = EDGE_OVERFLOW_SIZE
    faces = ring_faces(*MESH_LAT_LON, EDGE_ELEVATION, [0], s)
    eg.ORACLE_TAKEN.update(overflow=0)
    reset_launches()
    win = eg._rasterize_winner(faces, s, 0.0, 100.0)
    torch.cuda.synchronize()
    k7, overflow = rasterize_tiles.launches, int(win.overflow.sum())
    ref = rasterize_face_index(faces, s, near=0.0, far=100.0)
    if (k7 != 1 or eg.ORACLE_TAKEN != {"overflow": int(overflow > 0)}
            or not torch.equal(win.face_index_map, ref.face_index_map)
            or not torch.equal(win.alpha_map, ref.alpha_map)):
        raise AssertionError(f"edge_grad at {s}^2: K7 {k7}, overflow "
                             f"{overflow}, oracle {eg.ORACLE_TAKEN}, or maps "
                             "differ from rasterize_face_index's")
    log(f"[edge_grad] {faces.shape[1]} faces at {s}^2 on tiles "
        f"{k7_tiles(s)}: K7 {k7} time, overflow {overflow} dropped "
        f"candidates, the oracle taken {eg.ORACLE_TAKEN['overflow']} time; "
        "face index and alpha equal to rasterize_face_index's")
    overflow_case = dict(size=s, tiles=list(k7_tiles(s)),
                         k7_launches=k7, overflow=overflow,
                         oracle_taken=eg.ORACLE_TAKEN["overflow"])
    s = EDGE_FIT_SIZE
    faces = ring_faces(*MESH_LAT_LON, EDGE_ELEVATION, [0], s).clone()
    moved = faces.clone()
    moved[..., :2] = moved[..., :2] * 0.92 + torch.tensor([0.04, -0.03],
                                                          device=DEV)
    target = eg.silhouette(moved, s, 0.0, 100.0)
    faces.requires_grad_(True)
    adam = torch.optim.Adam([faces], lr=5e-3, betas=(0.9, 0.999), eps=1e-8)
    eg.ORACLE_TAKEN.update(overflow=0)
    reset_launches()
    losses = []
    t0 = time.perf_counter()
    for _ in range(EDGE_FIT_STEPS):
        adam.zero_grad()
        loss = ((eg.silhouette(faces, s, 0.0, 100.0) - target) ** 2).mean()
        loss.backward()
        adam.step()
        losses.append(loss.detach())
    losses = [float(x) for x in losses]
    fit_s = time.perf_counter() - t0
    edge_launches.update(fit=rasterize_tiles.launches, fit_steps=EDGE_FIT_STEPS)
    if (rasterize_tiles.launches != EDGE_FIT_STEPS
            or eg.ORACLE_TAKEN != {"overflow": 0}
            or not np.isfinite(losses).all() or not losses[-1] < losses[0]):
        raise AssertionError(f"edge_grad fit: losses {losses}, K7 "
                             f"{rasterize_tiles.launches}, oracle "
                             f"{eg.ORACLE_TAKEN}")
    log(f"[edge_grad] silhouette fit at {s}^2, {EDGE_FIT_STEPS} Adam steps: "
        f"loss {losses[0]:.6g} -> {losses[-1]:.6g} (min {min(losses):.6g}); "
        f"{fit_s / EDGE_FIT_STEPS * 1e3:.3f} ms a step on the host clock; K7 "
        "once a step, the oracle never")
    rec.setdefault("rasterize_tiles", {})["edge_grad"] = dict(
        cases={str(k): v for k, v in out.items()}, overflow_case=overflow_case,
        fit_loss_first=losses[0], fit_loss_last=losses[-1],
        fit_step_ms=fit_s / EDGE_FIT_STEPS * 1e3)
    edge_launches["calls"] = {str(k): v["k7_launches"]
                              for k, v in out.items()}


REMAT_MODES = ("none", "wide", "all")
REMAT_BATCH = 4
REMAT_STEPS = 5
REMAT_ITERS = 3
# train_rnr's flags besides the remat run's own: the synthetic views at
# the canonical width (train_rnr's defaults)
REMAT_RUN_ARGS = ["--synthetic", "--sphere_samples_fp", "nonexistent.mat"]
# two ranks at dp 2 against one process at b2, the same weights, dropout
# off.  Cases: "float32" f32 rays and U-Net with DETERMINISTIC_NET (the
# function), run also under U-Net remat "wide" ("remat_wide": its
# recompute repeats the norms' all-reduces) against the same reference
# and limits, "bfloat16" the shipped rays, U-Net and route, "dnr" the DNR
# step (f32, DETERMINISTIC_NET).  Each case also runs as a control: the
# same steps with each rank's batch norm over its own rows
# (`local_batch_norm`).  Readings: "loss" the global loss's relative
# error, "cosine" 1 - the cosine of the models' gradients (the GCN's,
# which batch norm blocks, left out), "grad" the largest gradient error
# of each gradient's largest value, "frame" the eval rows' error of the
# single-device frame's largest value.  Each limit in DP_LIMITS lies
# between the sound run's reading and the control's (both in PERF.md §6):
# the sound run must fall within it and the control outside it.
# A reading where the control is not set apart from the sound run is
# reported, not limited.  Not tighter elementwise: the batch statistics
# and the split sums round in another order over two ranks, and five
# levels of batch norm at random weights amplify a rounding difference
# to a few percent of some gradients' largest elements.
# The readings on an H100 (sound / control): float32 loss 9.05e-8 /
# 2.08e-6, cosine 5.1e-7 / 3.92e-4, grad 0.0811 / 0.618, frame 1.48e-5 /
# 0.0109 (remat_wide's as float32's); bfloat16 loss 1.81e-7 / 3.26e-6,
# frame 0.0204 / 0.0465, and not set apart: cosine 4.44e-4 / 1.62e-3
# (the bf16 backward is chaotic), grad 0.695 / 1.11; dnr loss 1.04e-7 /
# 8.96e-5, cosine 7e-8 / 1.07e-4, grad 0.0637 / 0.541.
DP_LIMITS = {
    "float32": dict(loss=4e-7, cosine=1e-5, grad=0.22, frame=4e-4),
    "bfloat16": dict(loss=8e-7, frame=0.03),
    "dnr": dict(loss=3e-6, cosine=3e-6, grad=0.19),
}


def two_views(img: int, dev) -> dict:
    """A global batch of 2 distinct views: the synthetic sphere and its
    mirror image, with another target."""
    from rnr_tpu_torch.synthetic import build_batch, to_torch
    b = build_batch(img, GCN_V, 2)
    for k, v in b.items():
        if v.ndim >= 3:
            v[1] = np.flip(v[1], axis=1)
    b["img_gt"][1] = 0.8 - 0.5 * b["img_gt"][1]
    return to_torch(b, dev)


def grad_errors(got: dict, want: dict) -> dict:
    """{name: max |got - want|} over each gradient's largest value, or the
    model's largest for the gradients batch norm blocks."""
    top = max(float(g.abs().max()) for g in want.values())
    return {n: float((got[n] - want[n]).abs().max())
            / (top if blocked_by_batch_norm(n)
               else max(float(want[n].abs().max()), 1e-30))
            for n in want}


def grad_cosine(a: dict, b: dict) -> float:
    """The cosine of the whole models' gradients, the GCN's left out."""
    keys = [n for n in b if not blocked_by_batch_norm(n)]
    x = torch.cat([a[n].double().flatten() for n in keys])
    y = torch.cat([b[n].double().flatten() for n in keys])
    return float(x @ y / (x.norm() * y.norm()))


def model_grads(model) -> dict:
    return {n: p.grad.detach().float().clone()
            for n, p in model.named_parameters() if p.grad is not None}


# the U-Net of the f32 dp and sp cases and of DNR's dp case: K6 for the
# 4x4 convs and zero padding (the cases' limits, DP_LIMITS and SP_LIMITS,
# were read on it; every route repeats bit for bit now, the determinism
# phase)
DETERMINISTIC_NET = dict(conv_backend="pallas", pad_mode="same")


def remat_grads(mode: str, net: dict, b: dict, statics: dict) -> dict:
    """One loss and backward of the canonical model under remat `mode`
    and the `net` overrides of render_net, dropout on (generator seed
    3): the loss, every gradient, the generator's end state."""
    from rnr_tpu_torch.models.rnr import RNRModel
    from rnr_tpu_torch.synthetic import init_weights
    from rnr_tpu_torch.train.steps import make_generator, make_rnr_loss_fn
    model = init_weights(RNRModel(canonical_config(render_net=dict(
        net, remat=mode)), GCN_V), seed=0)
    try:
        gen = make_generator(3)
        loss, aux = make_rnr_loss_fn(model)(b, statics, gen)
        loss.backward()
        torch.cuda.synchronize()
        return dict(loss=aux["loss"].detach().clone(),
                    grads=model_grads(model), gen=gen.get_state().cpu())
    finally:
        del model
        torch.cuda.empty_cache()


def worst_outside_gcn(got: dict, want: dict) -> tuple[float, str]:
    """The largest gradient error outside the GCN (grad_errors)."""
    err = grad_errors(got, want)
    return max((e, n) for n, e in err.items() if not blocked_by_batch_norm(n))


def remat_exact(b: dict, statics: dict) -> None:
    """A rerun of "none" and each other remat mode against "none" on the
    shipped route: the loss, the generator's end state and every gradient
    bit for bit."""
    ref = remat_grads("none", {}, b, statics)
    for mode in REMAT_MODES:
        got = remat_grads(mode, {}, b, statics)
        tag = "none, again," if mode == "none" else mode
        if not torch.equal(got["loss"], ref["loss"]):
            raise AssertionError(f"remat {tag} loss {float(got['loss'])} "
                                 f"!= none's {float(ref['loss'])}")
        if not torch.equal(got["gen"], ref["gen"]):
            raise AssertionError(f"remat {tag} the dropout generator ends "
                                 "elsewhere than without remat")
        differ = [n for n in ref["grads"]
                  if not torch.equal(got["grads"][n], ref["grads"][n])]
        if differ:
            raise AssertionError(f"remat {tag} gradients differ from "
                                 f"none's: {differ[:8]}")
        log(f"[parallel] remat {tag} against none, shipped route, batch "
            f"{REMAT_BATCH} at {IMG}^2: loss, the dropout generator's end "
            f"state and all {len(ref['grads'])} gradients bit-equal")


def remat_shipped(mode: str, b: dict, statics: dict, launches: dict) -> dict:
    """The shipped train step at batch REMAT_BATCH under remat `mode`: one
    counted step, the peak memory of a step, REMAT_STEPS steps by CUDA
    events."""
    from rnr_tpu_torch.models.rnr import RNRModel
    from rnr_tpu_torch.synthetic import init_weights
    from rnr_tpu_torch.train.steps import (create_rnr_optimizer,
                                           make_generator,
                                           make_rnr_train_step)
    out = {}
    model = init_weights(RNRModel(canonical_config(
        render_net=dict(remat=mode)), GCN_V), seed=0)
    step = make_rnr_train_step(model, create_rnr_optimizer(model, 1e-3))
    gen = make_generator(0)
    for _ in range(2):
        step(b, statics, gen)
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    step(b, statics, gen)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    launches[mode] = read_launches()
    times = []
    for _ in range(REMAT_STEPS):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        met = step(b, statics, gen)
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    if not np.isfinite(float(met["loss"])):
        raise AssertionError(f"remat {mode}: loss {float(met['loss'])}")
    out.update(peak_mib=peak, step_ms=float(np.median(times)),
               step_ms_min=min(times), step_ms_max=max(times),
               k3_launches=launches[mode]["conv3x3"])
    log(f"[parallel] remat {mode} batch {REMAT_BATCH} at {IMG}^2: peak "
        f"memory {peak:.1f} MiB; step {out['step_ms']:.3f} ms median "
        f"({min(times):.3f}-{max(times):.3f}) over {REMAT_STEPS} by CUDA "
        f"events; K3 {launches[mode]['conv3x3']} launches a step")
    del model, step
    torch.cuda.empty_cache()
    return out


def remat_driver_run() -> None:
    """train_rnr --unet_remat wide, REMAT_ITERS synthetic iterations at
    the canonical width."""
    from rnr_tpu_torch.drivers import train_rnr
    root = os.path.join(ROOT, "build", "parallel_remat_run")
    log_dir, model = train_rnr.main(REMAT_RUN_ARGS + [
        "--unet_remat", "wide", "--max_iter", str(REMAT_ITERS),
        "--log_freq", "1", "--logging_root", root])
    if model.render_net.Unet_0.remat != "wide":
        raise AssertionError("train_rnr --unet_remat wide built no remat")
    with open(os.path.join(log_dir, "summary.json")) as f:
        summary = json.load(f)
    if summary["iters"] != REMAT_ITERS or not np.isfinite(
            summary["last_loss"]):
        raise AssertionError(f"train_rnr --unet_remat wide: {summary}")
    log(f"[parallel] train_rnr --unet_remat wide: {REMAT_ITERS} iterations, "
        f"last loss {summary['last_loss']:.6g}, "
        f"{summary['timing'].get('iters_per_s', 0.0):.3f} iterations/s")
    del model
    torch.cuda.empty_cache()


def one_rank_nccl() -> None:
    """A one-rank NCCL group on cuda:0: the dp = 1 step, its collectives
    over the group, equals the step run with no process group bit for
    bit (loss terms, metrics, every gradient), on the shipped route."""
    from rnr_tpu_torch.models.rnr import RNRModel
    from rnr_tpu_torch.parallel import (init_distributed, make_mesh,
                                        make_sharded_rnr_train_step)
    from rnr_tpu_torch.parallel.distributed import free_port
    from rnr_tpu_torch.synthetic import build_statics, init_weights
    from rnr_tpu_torch.train.steps import (create_rnr_optimizer,
                                           make_generator,
                                           make_rnr_train_step)
    import torch.distributed as dist
    b = _gbuffer(IMG, 1)

    def run(mesh):
        model = init_weights(RNRModel(canonical_config(), GCN_V), 0)
        opt = create_rnr_optimizer(model, 1e-3)
        step = (make_rnr_train_step(model, opt) if mesh is None
                else make_sharded_rnr_train_step(model, opt, mesh))
        met = step(b, build_statics(model, 4096), make_generator(0))
        torch.cuda.synchronize()
        return {k: v.clone() for k, v in met.items()}, model_grads(model)

    try:
        m0, g0 = run(None)
        init_distributed(f"127.0.0.1:{free_port()}", 1, 0, 1)
        try:
            mesh = make_mesh(1)
            if dist.get_backend() != "nccl" or not mesh.grouped:
                raise AssertionError(f"backend {dist.get_backend()}, "
                                     f"grouped {mesh.grouped}")
            m1, g1 = run(mesh)
        finally:
            dist.destroy_process_group()
        for k in m0:
            if not torch.equal(m0[k], m1[k]):
                raise AssertionError(f"dp=1 NCCL step: {k} differs")
        for n in g0:
            if not torch.equal(g0[n], g1[n]):
                raise AssertionError(f"dp=1 NCCL step: gradient {n} differs")
        log(f"[parallel] one-rank NCCL group on cuda:0: the dp=1 step (its "
            f"collectives over NCCL) equals the step with no process group "
            f"bit for bit ({len(m0)} metrics, all {len(g0)} gradients), "
            "shipped route")
    finally:
        torch.cuda.empty_cache()


@contextlib.contextmanager
def local_batch_norm():
    """Inside: the steps' batch norms over each rank's own rows, not the
    global batch's (the control: dp without the cross-rank norm)."""
    from rnr_tpu_torch.parallel import sharding
    keep = sharding.global_batch_norm
    sharding.global_batch_norm = lambda model, mesh, rows=None: (
        contextlib.nullcontext())
    try:
        yield
    finally:
        sharding.global_batch_norm = keep


def param_digest(model) -> str:
    h = hashlib.sha256()
    for t in list(model.parameters()) + list(model.buffers()):
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _rnr_builder(dtype: str, remat: str = "none"):
    """A builder of the canonical model of a dp case (DP_LIMITS), dropout
    off."""
    from rnr_tpu_torch.models.rnr import RNRModel
    from rnr_tpu_torch.synthetic import init_weights
    net = DETERMINISTIC_NET if dtype == "float32" else {}
    cfg = canonical_config(rays=dict(rays_dtype=dtype), render_net=dict(
        net, compute_dtype=dtype, remat=remat))

    def build():
        m = init_weights(RNRModel(cfg, GCN_V), 0)
        m.render_net.Unet_0.use_dropout = False
        return m

    return build


def _dnr_builder():
    from rnr_tpu_torch.synthetic import init_weights
    from rnr_tpu_torch.train.steps import build_dnr_modules

    def build():
        mods = init_weights(build_dnr_modules(dnr_config()), 1)
        mods.render_net.Unet_0.use_dropout = False
        return mods

    return build


def _dp_run(kind: str, build, mesh, b: dict, statics: dict | None,
            control: bool, digest: bool):
    """One sharded step (and, for RNR, the sharded eval rows at the
    initial weights) of a fresh model: (result, gradients, this rank's
    rows or None).  With `digest`, a second step with dropout on and the
    parameters' digest."""
    from rnr_tpu_torch.parallel import (make_sharded_dnr_train_step,
                                        make_sharded_rnr_eval_step,
                                        make_sharded_rnr_train_step)
    from rnr_tpu_torch.train.steps import (create_rnr_optimizer,
                                           make_generator)
    model = build()
    opt = create_rnr_optimizer(model, 1e-3)
    row = None
    with local_batch_norm() if control else contextlib.nullcontext():
        if kind == "dnr":
            dstep = make_sharded_dnr_train_step(dnr_config(), model, opt,
                                                mesh, seed=7)

            def step(gen):
                return dstep(b, gen)
        else:
            # the frames at the initial weights: after a step the two
            # sides' weights differ by Adam's normalised updates of
            # gradients that differ in rounding
            row = make_sharded_rnr_eval_step(model, mesh)(b)["img"].float()
            rstep = make_sharded_rnr_train_step(model, opt, mesh, seed=7)

            def step(gen):
                return rstep(b, statics, gen)
        t0 = time.perf_counter()
        met = step(make_generator(0))
        torch.cuda.synchronize()
        r = dict(step_s=time.perf_counter() - t0, loss=float(met["loss"]))
        grads = model_grads(model)
        if digest:
            model.render_net.Unet_0.use_dropout = True
            step(make_generator(1))
            r["digest"] = param_digest(model)
    return r, grads, row


def _dp_reference(kind: str, build, b: dict):
    """The single-process b2 step of a fresh model: (loss, gradients,
    the eval frame at the initial weights or None)."""
    from rnr_tpu_torch.synthetic import build_statics
    from rnr_tpu_torch.train.steps import (create_rnr_optimizer,
                                           make_dnr_train_step,
                                           make_generator,
                                           make_rnr_eval_step,
                                           make_rnr_train_step)
    ref = build()
    opt = create_rnr_optimizer(ref, 1e-3)
    if kind == "dnr":
        frame = None
        met = make_dnr_train_step(dnr_config(), ref, opt)(b,
                                                          make_generator(0))
    else:
        frame = make_rnr_eval_step(ref)(b)["img"].float().cpu()
        met = make_rnr_train_step(ref, opt)(b, build_statics(ref, 4096),
                                            make_generator(0))
    torch.cuda.synchronize()
    return float(met["loss"]), model_grads(ref), frame


def _dp_rank(local_rank: int, port: int) -> dict:
    """One of two ranks on cuda:0 over Gloo (a spawned process): each dp
    case (DP_LIMITS) and its control; rank 0 also runs the
    single-process b2 steps and frames they are held to and reads each
    case against them.  Returns plain numbers."""
    import torch.distributed as dist
    from rnr_tpu_torch.parallel import init_distributed, make_mesh
    from rnr_tpu_torch.synthetic import build_statics
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    init_distributed(f"127.0.0.1:{port}", 1, 0, 2, local_rank=local_rank,
                     backend="gloo")
    out = {}
    try:
        mesh = make_mesh(2, dp=2)
        b = two_views(IMG, DEV)
        db = dnr_batch(DEV)
        plan = {"float32": ("rnr", _rnr_builder("float32"),
                            ("dp", "control", "remat_wide")),
                "bfloat16": ("rnr", _rnr_builder("bfloat16"),
                             ("dp", "control")),
                "dnr": ("dnr", _dnr_builder(), ("dp", "control"))}
        for case, (kind, build, runs) in plan.items():
            batch = db if kind == "dnr" else b
            statics = (None if kind == "dnr"
                       else build_statics(build(), 4096))
            res, got = {}, {}
            for run in runs:
                bld = (_rnr_builder("float32", "wide")
                       if run == "remat_wide" else build)
                r, grads, row = _dp_run(kind, bld, mesh, batch, statics,
                                        run == "control", run == "dp")
                if row is not None:
                    rows = [torch.empty_like(row).cpu() for _ in range(2)]
                    dist.all_gather(rows, row.cpu())
                    row = torch.cat(rows)
                res[run], got[run] = r, (grads, row)
                torch.cuda.empty_cache()
            if mesh.rank == 0:
                ref_loss, rg, rframe = _dp_reference(kind, build, batch)
                for run, (grads, rows) in got.items():
                    r = res[run]
                    r.update(ref_loss=ref_loss,
                             loss_rel=abs(r["loss"] - ref_loss)
                             / abs(ref_loss), **grad_summary(grads, rg))
                    if rows is not None:
                        r["frame_err"] = float((rows - rframe).abs().max()
                                               / rframe.abs().max())
                del rg
            out[case] = res
            del got
            torch.cuda.empty_cache()
        return out
    finally:
        dist.destroy_process_group()


def grad_summary(got: dict, want: dict) -> dict:
    """The whole models' gradient cosine (GCN left out), the largest
    elementwise error and the norm ratio furthest from 1 by tensor."""
    err = worst_outside_gcn(got, want)
    ratios = {n: float(got[n].norm() / want[n].norm().clamp_min(1e-30))
              for n in want if not blocked_by_batch_norm(n)}
    far = max(ratios, key=lambda n: abs(math.log(max(ratios[n], 1e-30))))
    return dict(cosine=grad_cosine(got, want), grad_err=err,
                norm_ratio=(ratios[far], far))


def dnr_config():
    """DNR at rnr_tpu's train_dnr widths (512^2, texture 512^2 x 30 x 4
    levels, nf0 64, 5 downs) with DETERMINISTIC_NET (K6 for its 4x4
    convs, on the f32 route)."""
    from rnr_tpu_torch.config import (DNRConfig, LossConfig, RenderNetConfig,
                                      TextureConfig, TrainConfig)
    return DNRConfig(
        texture=TextureConfig(texture_size=512, texture_num_ch=DNR_CH,
                              mipmap_level=4),
        render_net=RenderNetConfig(nf0=64, num_down_unet=5,
                                   **DETERMINISTIC_NET),
        loss=LossConfig(), train=TrainConfig(img_size=IMG))


def dnr_batch(dev) -> dict:
    """Two distinct views of the synthetic sphere's uv, SH basis (9 of
    the DNR texture's channels modulated), alpha and a target."""
    b = two_views(IMG, dev)
    return {"uv_map": b["uv_map"], "sh_basis_map": b["sh_basis_map"],
            "alpha_map": b["alpha_map"], "img_gt": b["img_gt"]}


def dp_readings(r: dict) -> dict:
    """The readings DP_LIMITS names, of one run read against its
    reference."""
    out = dict(loss=r["loss_rel"], cosine=1.0 - r["cosine"],
               grad=r["grad_err"][0])
    if "frame_err" in r:
        out["frame"] = r["frame_err"]
    return out


def dp_two_ranks() -> dict:
    """Two ranks on the one card over Gloo with CUDA tensors (NCCL
    refuses two ranks on one device), each its own process: every case
    and control read and logged, then held to DP_LIMITS."""
    from rnr_tpu_torch.parallel import run_ranks
    from rnr_tpu_torch.parallel.distributed import free_port
    t0 = time.perf_counter()
    r0, r1 = run_ranks(_dp_rank, 2, free_port())
    log(f"[parallel] two Gloo ranks on cuda:0: {time.perf_counter() - t0:.1f}"
        " s with their start")
    for case, runs in r0.items():
        for run, a in runs.items():
            name = case if run == "dp" else (
                f"{case} {run}" if run != "control"
                else f"{case} without the cross-rank norm (control)")
            frame = (f"; the eval rows against the single-device frame "
                     f"{a['frame_err']:.3g} of its largest"
                     if "frame_err" in a else "")
            log(f"[parallel] dp=2 {name} at b2 {IMG}^2: loss "
                f"{a['loss']:.8g} against one process's {a['ref_loss']:.8g} "
                f"(rel {a['loss_rel']:.3g}); gradient cosine "
                f"{a['cosine']:.8f}, largest elementwise error "
                f"{a['grad_err'][0]:.3g} ({a['grad_err'][1]}), norm ratio "
                f"{a['norm_ratio'][0]:.6f} ({a['norm_ratio'][1]}){frame}; "
                f"the ranks' first step {a['step_s']:.2f} / "
                f"{r1[case][run]['step_s']:.2f} s (host clock)")
    for case, runs in r0.items():
        for run, a in runs.items():
            if a["loss"] != r1[case][run]["loss"]:
                raise AssertionError(f"dp {case} {run}: the ranks' losses "
                                     "differ")
        if runs["dp"]["digest"] != r1[case]["dp"]["digest"]:
            raise AssertionError(f"dp {case}: the ranks' parameters differ "
                                 "after two steps")
    log("[parallel] every case's parameters bit-equal across the ranks "
        "after two steps (dropout on, each rank's own masks)")
    for case, runs in r0.items():
        limits = DP_LIMITS[case]
        for run, a in runs.items():
            if run == "control":
                continue
            got = dp_readings(a)
            for m, tol in limits.items():
                check(f"dp {case} {run} {m}", got[m], tol)
        if "control" in runs:
            got = dp_readings(runs["control"])
            passed = [m for m, tol in limits.items() if got[m] <= tol]
            if passed:
                raise AssertionError(f"dp {case}: the control without the "
                                     f"cross-rank norm passes {passed}")
    return r0


def native_parser(lat_lon: tuple, tag: str) -> dict:
    """load_obj's native parser (csrc/obj_parse.cpp) on a UV sphere of
    lat_lon, against the Python parser: both timed (host clock), the
    arrays equal (indices exactly, floats to 1e-6 relative).  Fails
    where the native parser did not run."""
    from rnr_tpu_torch.data import native
    from rnr_tpu_torch.data.obj import load_obj
    from rnr_tpu_torch.synthetic import sphere_mesh
    path = os.path.join(ROOT, "build", f"{tag}_sphere.obj")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t0 = time.perf_counter()
    write_obj(path, sphere_mesh(*lat_lon))
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    load_obj(path, use_native=True)      # builds the library at first use
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    nat = load_obj(path, use_native=True)
    t_nat = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = load_obj(path, use_native=False)
    t_py = time.perf_counter() - t0
    os.remove(path)
    if nat.parser != "native":
        raise AssertionError(f"[{tag}] load_obj(use_native=True) ran the "
                             f"{nat.parser} parser: "
                             f"{native.build_error.get('obj_parse')}")
    log(f"[{tag}] load_obj(use_native=True) ran the native parser "
        f"({t_nat * 1e3:.1f} ms, host clock; its first call, the build "
        f"included, {t_first:.2f} s; the Python parser "
        f"{t_py * 1e3:.1f} ms) on {len(py.v)} vertices, "
        f"{len(py.f_v_idx)} faces ({os.cpu_count()} cores; the file "
        f"written in {t_write:.2f} s)")
    for f in ("v", "vt", "vn", "f_v_idx", "f_vt_idx", "f_vn_idx"):
        a, c = getattr(nat, f), getattr(py, f)
        if a.shape != c.shape or (
                not np.array_equal(a, c) if f.startswith("f_")
                else not np.allclose(a, c, rtol=1e-6, atol=0)):
            raise AssertionError(f"[{tag}] native parser: {f} differs")
    log(f"[{tag}] the native parser's arrays equal the Python parser's "
        "(indices exactly, floats to 1e-6 relative)")
    return dict(parser=nat.parser, faces=len(py.f_v_idx), native_ms=t_nat *
                1e3, python_ms=t_py * 1e3, first_call_s=t_first)


def phase_parallel(remat_launches: dict, rec: dict) -> None:
    """Remat on the card, a one-rank NCCL group, two Gloo ranks on the
    one card, and the native OBJ parser (module docstring)."""
    from rnr_tpu_torch.models.rnr import RNRModel
    from rnr_tpu_torch.synthetic import build_statics, init_weights
    b = _gbuffer(IMG, REMAT_BATCH)
    statics = build_statics(init_weights(RNRModel(canonical_config(), GCN_V),
                                         0), 4096)
    remat_exact(b, statics)
    remat = {mode: remat_shipped(mode, b, statics, remat_launches)
             for mode in REMAT_MODES}
    del b, statics
    torch.cuda.empty_cache()
    remat_driver_run()
    one_rank_nccl()
    dp = dp_two_ranks()
    rec["parallel"] = dict(remat=remat, dp=dp,
                           parser=native_parser(MESH_LAT_LON, "parallel"))


# ------------------------------------------------------------ sp phase
#
# Image rows across ranks (rnr_tpu's sp axis): Gloo ranks on cuda:0
# (NCCL refuses two ranks on one card), spawned by run_ranks, each a
# (dp, sp) mesh rank at the canonical full width, dropout off, held to
# one process's step and frame on the same global batch.  Cases, by the
# ranks that run them: (a) "sp2": the shipped bf16 route (pallas3,
# reflect) at b1, its train step and eval frame; (d) "sp2_<route>" and
# "sp2_group": the eval frame under each other conv route and under
# norm="group"; (b) "sp4": the shipped eval frame over 4 row shards;
# (c) "dp2sp2": one f32 train step (f32 rays and U-Net,
# DETERMINISTIC_NET) and its eval frame over (dp 2, sp 2) at b2; (e)
# "sp2_480": as (a) on a 480^2 frame, its rows in uneven shards.  Each
# case also runs as a control without the halo: each rank's convs pad
# its own rows as a frame (`sharding.row_shards(halo=False)`).
# Readings: "loss" the global loss's relative error, "cosine" 1 - the
# cosine of the models' gradients (the GCN's left out), "grad" the
# largest gradient error of each gradient's largest value, "frame" the
# gathered frame's largest error of the single-device frame's largest
# value.  Each limit in SP_LIMITS lies between the sound run's reading
# and the control's (both in PERF.md §6): the sound run within, the
# control outside.  Gloo on one card is a correctness vehicle: its times
# are logged, not a speed figure.
SP_ROUTES = ("xla", "pallas", "p3s4", "slab3", "slab")
SP_CASES = {  # name: (ranks, dp, batch, runs, render_net overrides, dtype)
    "sp2": (2, 1, 1, ("frame", "step"), {}, "bfloat16"),
    **{f"sp2_{r}": (2, 1, 1, ("frame",), dict(conv_backend=r), "bfloat16")
       for r in SP_ROUTES},
    "sp2_group": (2, 1, 1, ("frame",), dict(norm="group"), "bfloat16"),
    "sp4": (4, 1, 1, ("frame",), {}, "bfloat16"),
    "dp2sp2": (4, 2, 2, ("frame", "step"), DETERMINISTIC_NET, "float32"),
    # rows in uneven shards: 480 = 15 units of 32 (5 downs), 8 and 7 units
    "sp2_480": (2, 1, 1, ("frame", "step"), {}, "bfloat16"),
}
# a case's frame side where it is not IMG
SP_IMG = {"sp2_480": 480}
# The readings on an H100 (sound / control): sp2 frame 0.0135 / 0.126,
# loss 2.71e-6 / 8.30e-6, and not set apart: cosine 6.42e-4 / 2.77e-3
# (the bf16 backward is chaotic), grad 0.564 / 0.992; the routes' frames
# 0.0104-0.0135 / 0.126-0.140; sp2_group frame 2.06e-3 / 0.0759; sp4
# frame 0.0114 / 0.194; dp2sp2 frame 1.54e-5 / 0.154, loss 9.05e-8 /
# 7.34e-5, cosine 5.03e-7 / 9.83e-4, grad 0.0882 / 1.011.
SP_LIMITS = {
    "sp2": dict(loss=5e-6, frame=0.04),
    **{f"sp2_{r}": dict(frame=0.04) for r in SP_ROUTES},
    "sp2_group": dict(frame=0.01),
    "sp4": dict(frame=0.04),
    "dp2sp2": dict(loss=4e-7, cosine=1e-5, grad=0.22, frame=4e-4),
    "sp2_480": dict(loss=5e-6, frame=0.04),
}
# launches per rank of one eval frame of the shipped route (cached
# nothing: the GCN runs too) and of each case's route
SP_FRAME_LAUNCHES = {"conv3x3": 14, "sh_shade_fan": 1, "mipmap_gather": 1,
                     "stratified_knn": 17}
SP_XLA_FRAME = dict(SP_FRAME_LAUNCHES, conv3x3=0)


def sp_frame_want(net: dict, dtype: str) -> dict:
    """The launches per rank of one eval frame under `net`'s route; an
    f32 U-Net's conv kernels launch three times a conv (f32_by_three)."""
    route = net.get("conv_backend", "pallas3")
    if route == "xla":
        return SP_XLA_FRAME
    want = dict(SP_FRAME_LAUNCHES, **ROUTE_FRAME_LAUNCHES.get(route, {}))
    if dtype == "float32":
        want.update({k: 3 * n for k, n in want.items()
                     if k.startswith(("conv", "down", "convt"))})
    return want


# the kernels of the f32 step under DETERMINISTIC_NET, each at least once
# (an f32 conv launches its kernel three times, its weight gradient six)
SP_F32_STEP_KERNELS = ("stratified_knn", "conv3x3", "conv3x3_wgrad", "down4",
                       "convt4", "sh_shade_fan", "sh_shade_fan_bwd",
                       "mipmap_gather", "mipmap_scatter")


def sp_check_launches(case: str, run: str, got: dict, want) -> None:
    """A rank's launches: each of `want` exactly (a dict) or at least
    once (a tuple of names)."""
    exact = isinstance(want, dict)
    for name in want:
        if (got[name] != want[name]) if exact else not got[name]:
            raise AssertionError(f"sp {case} {run}: {name} launched "
                                 f"{got[name]} times on a rank, expected "
                                 f"{want[name] if exact else 'some'}")


@contextlib.contextmanager
def no_halo():
    """Inside: the steps' convs on each rank's own rows, padded as a frame
    (the control: sp without the halo exchange)."""
    from rnr_tpu_torch.parallel import sharding
    keep = sharding.row_shards
    sharding.row_shards = functools.partial(keep, halo=False)
    try:
        yield
    finally:
        sharding.row_shards = keep


def _sp_builder(net: dict, dtype: str, img: int = IMG):
    """A builder of a case's model, dropout off: one model, its seeded
    weights and buffers restored at each call (a step moves them)."""
    from rnr_tpu_torch.models.rnr import RNRModel
    from rnr_tpu_torch.synthetic import init_weights
    cfg = canonical_config(img=img, rays=dict(rays_dtype=dtype),
                           render_net=dict(net, compute_dtype=dtype))
    model = init_weights(RNRModel(cfg, GCN_V), 0)
    model.render_net.Unet_0.use_dropout = False
    state = {k: v.clone() for k, v in model.state_dict().items()}

    def build():
        model.load_state_dict(state)
        model.zero_grad(set_to_none=True)
        return model

    return build


def _sp_run(run: str, build, mesh, b: dict, control: bool) -> dict:
    """One sharded eval frame (gathered) or train step of the case's model
    at its initial weights on this rank: its launches, seconds (host
    clock, synchronised) and the frame, or the loss and gradients."""
    from rnr_tpu_torch.parallel import (fetch_global,
                                        make_sharded_rnr_eval_step,
                                        make_sharded_rnr_train_step)
    from rnr_tpu_torch.synthetic import build_statics
    from rnr_tpu_torch.train.steps import (create_rnr_optimizer,
                                           make_generator)
    model = build()
    with no_halo() if control else contextlib.nullcontext():
        if run == "frame":
            step = make_sharded_rnr_eval_step(model, mesh)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            rows = step(b)["img"]
            torch.cuda.synchronize()
            r = dict(s=time.perf_counter() - t0, launches=read_launches())
            r["frame"] = fetch_global(rows, mesh.sp)
        else:
            statics = build_statics(model, 4096)
            step = make_sharded_rnr_train_step(
                model, create_rnr_optimizer(model, 1e-3), mesh)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            met = step(b, statics, make_generator(0))
            torch.cuda.synchronize()
            r = dict(s=time.perf_counter() - t0, launches=read_launches(),
                     loss=float(met["loss"]), grads=model_grads(model))
    del model
    torch.cuda.empty_cache()
    return r


def _sp_reference(run: str, build, b: dict) -> dict:
    """One process's eval frame or train step of the case's model at its
    initial weights on the whole global batch, with its host-clock
    seconds."""
    from rnr_tpu_torch.synthetic import build_statics
    from rnr_tpu_torch.train.steps import (create_rnr_optimizer,
                                           make_generator,
                                           make_rnr_eval_step,
                                           make_rnr_train_step)
    ref = build()
    torch.cuda.synchronize()
    if run == "frame":
        step = make_rnr_eval_step(ref)
        t0 = time.perf_counter()
        frame = step(b)["img"].float()
        torch.cuda.synchronize()
        r = dict(s=time.perf_counter() - t0, frame=frame.cpu().numpy())
    else:
        statics = build_statics(ref, 4096)
        step = make_rnr_train_step(ref, create_rnr_optimizer(ref, 1e-3))
        t0 = time.perf_counter()
        met = step(b, statics, make_generator(0))
        torch.cuda.synchronize()
        r = dict(s=time.perf_counter() - t0, loss=float(met["loss"]),
                 grads=model_grads(ref))
    del ref
    torch.cuda.empty_cache()
    return r


def sp_readings(got: dict, want: dict) -> dict:
    """The readings SP_LIMITS names, of one run against one process's."""
    if "frame" in got:
        f, w = got["frame"], want["frame"]
        return dict(frame=float(np.abs(f - w).max() / np.abs(w).max()))
    g = grad_summary(got["grads"], want["grads"])
    return dict(loss=abs(got["loss"] - want["loss"]) / abs(want["loss"]),
                cosine=1.0 - g["cosine"], grad=g["grad_err"][0])


def _sp_rank(local_rank: int, port: int, n: int) -> dict:
    """One of n ranks on cuda:0 over Gloo (a spawned process): every
    case of SP_CASES on n ranks and its control, each rank's launches;
    rank 0 also runs one process's frames and steps and reads each case
    against them.  Returns plain numbers."""
    import torch.distributed as dist
    from rnr_tpu_torch.parallel import init_distributed, make_mesh
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    init_distributed(f"127.0.0.1:{port}", 1, 0, n, local_rank=local_rank,
                     backend="gloo")
    out = {}
    try:
        for case, (ranks, dp, bsz, runs, net, dtype) in SP_CASES.items():
            if ranks != n:
                continue
            t_case = time.perf_counter()
            mesh = make_mesh(n, dp=dp)
            img = SP_IMG.get(case, IMG)
            b = two_views(img, DEV) if bsz == 2 else _gbuffer(img, 1)
            build = _sp_builder(net, dtype, img)
            res = {}
            for run in runs:
                sound = _sp_run(run, build, mesh, b, control=False)
                control = _sp_run(run, build, mesh, b, control=True)
                res[run] = dict(s=sound["s"], launches=sound["launches"],
                                control_s=control["s"])
                if mesh.rank == 0:
                    ref = _sp_reference(run, build, b)
                    res[run].update(ref_s=ref["s"],
                                    sound=sp_readings(sound, ref),
                                    control=sp_readings(control, ref))
                    if run == "step":
                        res[run].update(loss=sound["loss"],
                                        ref_loss=ref["loss"])
                    del ref
                del sound, control
                torch.cuda.empty_cache()
            del build
            torch.cuda.empty_cache()
            res["case_s"] = time.perf_counter() - t_case
            out[case] = res
        return out
    finally:
        dist.destroy_process_group()


def phase_sp(sp_launches: dict, rec: dict) -> None:
    """Every case of SP_CASES on 2 and then 4 Gloo ranks on cuda:0: each
    case's readings and its control's logged, then each rank's launches
    checked (no rank falls back to a plain version) and each case held
    to SP_LIMITS, its control outside them."""
    from rnr_tpu_torch.parallel import run_ranks
    from rnr_tpu_torch.parallel.distributed import free_port
    per_rank: dict = {}
    for n in (2, 4):
        t0 = time.perf_counter()
        rs = run_ranks(_sp_rank, n, free_port(), n)
        log(f"[sp] {n} Gloo ranks on cuda:0: {time.perf_counter() - t0:.1f} "
            "s with their start")
        for case, res in rs[0].items():
            per_rank[case] = [r[case] for r in rs]
    for case, ranks in per_rank.items():
        r0 = ranks[0]
        for run in SP_CASES[case][3]:
            a = r0[run]
            loss = (f"; loss {a['loss']:.8g} against one process's "
                    f"{a['ref_loss']:.8g}" if "loss" in a else "")
            log(f"[sp] {case} {run}: sound {a['sound']}, control without "
                f"the halo {a['control']}{loss}; the ranks' seconds "
                f"{[round(r[run]['s'], 3) for r in ranks]} (controls "
                f"{[round(r[run]['control_s'], 3) for r in ranks]}), one "
                f"process {a['ref_s']:.3f} s (host clock, synchronised, "
                "first call)")
        log(f"[sp] {case}: {r0['case_s']:.1f} s on rank 0")
    rec.update({case: {run: {k: ranks[0][run][k] for k in
                             ("sound", "control", "s", "ref_s")}
                       for run in SP_CASES[case][3]}
                for case, ranks in per_rank.items()})
    for case, ranks in per_rank.items():
        _, _, _, runs, net, dtype = SP_CASES[case]
        for run in runs:
            got = [r[run]["launches"] for r in ranks]
            if any(g != got[0] for g in got):
                raise AssertionError(f"sp {case} {run}: the ranks' launches "
                                     f"differ: {got}")
            for name, count in got[0].items():
                sp_launches.setdefault(name, {})[f"{case}_{run}"] = count
            sp_check_launches(case, run, got[0], (
                sp_frame_want(net, dtype) if run == "frame"
                else TRAIN_LAUNCHES if dtype == "bfloat16"
                else SP_F32_STEP_KERNELS))
    log("[sp] launches per rank, every rank alike: " + json.dumps(
        {run: {n: c[run] for n, c in sp_launches.items() if c.get(run)}
         for run in next(iter(sp_launches.values()))}))
    for case, ranks in per_rank.items():
        limits = SP_LIMITS[case]
        for run in SP_CASES[case][3]:
            a = ranks[0][run]
            held = {m: tol for m, tol in limits.items() if m in a["sound"]}
            for m, tol in held.items():
                check(f"sp {case} {run} {m}", a["sound"][m], tol)
            passed = [m for m, tol in held.items() if a["control"][m] <= tol]
            if passed:
                raise AssertionError(f"sp {case} {run}: the control without "
                                     f"the halo passes {passed}")


# ------------------------------------------------------------------ gate

# the albedo prior lifts the loss after the first step (the texture starts
# at ones); it falls below the first step's by iteration 140 where the
# prior's term decays fast, and only by 520 where it decays slowly, as in
# the runs that end in the gate's second basin (PERF.md, section 6)
GATE_ITERS = 700
# kernels the gate's ship arm must launch: precompute's G-buffers (K7),
# the training steps and the validation (K1, K1b, K2, K2b, K3, K3b, K4)
GATE_KERNELS = ("sh_shade_fan", "sh_shade_fan_bwd", "mipmap_gather",
                "mipmap_scatter", "conv3x3", "conv3x3_wgrad",
                "stratified_knn", "rasterize_tiles")
# the native OBJ parser's large mesh: 1,001,112 faces, 502,681 vertices
BIG_LAT_LON = (708, 708)


# relative to the plain f32 version's largest value: the bf16 output's one
# rounding (2^-8 of its value) twice; the f32 gradients as the kernels
# phase holds them
SLAB_PARITY_TOL = {"fwd": 2.0 ** -7, "dgrad": 1e-4, "wgrad": 1e-4}


def slab_conv_parity(step) -> dict:
    """K8a's forward and data gradient and K8b at the inputs one slab3
    train step gives them, captured from the step (as dnr_conv_parity
    captures K3's), beside K3 / K3b on the same inputs, each against the
    plain f32 version: the largest error over the plain version's
    largest value per kind, for both formulations; fails where K8's
    exceeds SLAB_PARITY_TOL."""
    from rnr_tpu_torch.ops import conv_cuda as cc
    real_fwd, real_vjp = cc.conv3x3s_fwd, cc._vjp
    seen = {"fwd": [], "dgrad": [], "wgrad": []}

    def fwd(x, w, b, pad_mode, out_dtype=None):
        seen["fwd"].append([x.detach().clone(), w.detach().clone(),
                            b.detach().clone(), pad_mode])
        return real_fwd(x, w, b, pad_mode, out_dtype)

    def vjp(ctx, g, dgrad, wgrad):
        x, w = ctx.saved_tensors
        if dgrad is cc.conv3x3s_dgrad:
            gx = g.to(x.dtype).detach().clone()
            seen["dgrad"].append([gx, w.detach().clone(), ctx.pad_mode])
            seen["wgrad"].append([x.detach().clone(), gx, ctx.pad_mode])
        return real_vjp(ctx, g, dgrad, wgrad)

    cc.conv3x3s_fwd, cc._vjp = fwd, vjp
    try:
        step()
        torch.cuda.synchronize()
    finally:
        cc.conv3x3s_fwd, cc._vjp = real_fwd, real_vjp
    runs = {  # (K8, K3, the plain f32 version)
        "fwd": lambda x, w, b, p: (
            real_fwd(x, w, b, p), cc.conv3x3_fwd(x, w, b, p),
            cc.conv3x3_torch(x.float(), w.to(x.dtype).float(), b, p)),
        "dgrad": lambda g, w, p: (
            cc.conv3x3s_dgrad(g, w, p), cc.conv3x3_dgrad(g, w, p),
            cc.conv3x3_dgrad_torch(g, w, p)),
        "wgrad": lambda x, g, p: (
            cc.conv3x3s_wgrad(x, g, p), cc.conv3x3_wgrad(x, g, p),
            cc.conv3x3_wgrad_torch(x, g, p))}
    out = {}
    for kind, calls in seen.items():
        if len(calls) != 14:
            raise AssertionError(f"slab parity: {len(calls)} {kind} calls "
                                 "captured, want 14")
        e8, e3 = [], []
        for a in calls:
            k8, k3, plain = runs[kind](*a)
            scale = float(plain.abs().max())
            e8.append(float((k8.float() - plain).abs().max()) / scale)
            e3.append(float((k3.float() - plain).abs().max()) / scale)
        out[kind] = dict(k8_max_rel=max(e8), k3_max_rel=max(e3),
                         k8_per_call=[float(f"{v:.3g}") for v in e8])
        del calls[:]
    log("[gate] slab3 step at its own conv inputs, error over the plain f32 "
        "version's largest value (K8a / K8b, then K3 / K3b on the same "
        "inputs): " + json.dumps(out))
    for kind, r in out.items():
        check(f"slab parity {kind}", r["k8_max_rel"], SLAB_PARITY_TOL[kind])
    return out


def slab_step_parity(root: str, run: str) -> dict:
    """The gate arm's trained model (`run`'s params.json and
    model_final.ckpt) on the slab3 route: one train step on the scene's
    view 1 (a training view) held by slab_conv_parity."""
    from rnr_tpu_torch.config import RNRConfig, load_config
    from rnr_tpu_torch.data import ViewDataset, load_obj
    from rnr_tpu_torch.drivers.common import load_sphere_samples
    from rnr_tpu_torch.drivers.train_rnr import make_rnr_batch
    from rnr_tpu_torch.models.rnr import RNRModel
    from rnr_tpu_torch.synthetic import build_statics
    from rnr_tpu_torch.train.checkpoint import load_checkpoint
    from rnr_tpu_torch.train.steps import (create_rnr_optimizer,
                                           make_generator,
                                           make_rnr_train_step)
    cfg = override(load_config(RNRConfig, os.path.join(run, "params.json")),
                   render_net=dict(conv_backend="slab3"))
    gcn_pos = load_obj(os.path.join(root, "mesh.obj")).v
    model = RNRModel(cfg, len(gcn_pos),
                     l_dir=load_sphere_samples("nonexistent.mat"))
    load_checkpoint(os.path.join(run, "model_final.ckpt"), model)
    pre = os.path.join(root, "precomp_mesh")
    ds = ViewDataset(root, os.path.join(root, "calib.mat"), (IMG, IMG),
                     sampling_pattern="only_1", load_precompute=True,
                     img_dir=os.path.join(root, "rgb0"),
                     precomp_high_dir=pre, precomp_low_dir=pre)
    ds.buffer_all()
    b = make_rnr_batch(ds.views_all, gcn_pos, DEV)
    step = make_rnr_train_step(model, create_rnr_optimizer(model, 1e-3))
    statics, gen = build_statics(model, 4096), make_generator(0)
    out = slab_conv_parity(lambda: step(b, statics, gen))
    del model, step, b
    return out


def phase_gate(gate_launches: dict, rec: dict, smi: str,
               iters: int = GATE_ITERS) -> None:
    """The quality gate's ship arm through its module
    (rnr_tpu_torch.tools.quality_gate, --one_arm in this process) at
    canonical width: the 24-view scene, precompute, stitch_lp, `iters`
    train_rnr iterations and one validation with relighting.  Checks the
    loss falls, every validation figure finite, the launches of
    GATE_KERNELS, and that every load_obj call ran the native parser;
    reports iterations/s, peak MiB and RSS.  Then the trained model's
    slab3 step at its own conv inputs (slab_step_parity) and the native
    parser against the Python one on BIG_LAT_LON's sphere."""
    import shutil
    from rnr_tpu_torch.data import obj
    from rnr_tpu_torch.tools import quality_gate as gate
    root = os.path.join(ROOT, "build", "gate_scene")
    shutil.rmtree(root, ignore_errors=True)
    argv = ["--canonical", "--img", str(IMG), "--iters", str(iters),
            "--root", root, "--one_arm", "ship"]
    reset_launches()
    obj.parser_counts.clear()
    t0 = time.perf_counter()
    gate.main(argv)
    t_gate = time.perf_counter() - t0
    torch.cuda.synchronize()
    gate_launches.update(read_launches())
    log(f"[gate] launches on the gate's path: {gate_launches}")
    missing = [k for k in GATE_KERNELS if not gate_launches[k]]
    if missing:
        raise AssertionError(f"gate: {missing} never launched")
    parsers = dict(obj.parser_counts)
    if not parsers.get("native") or parsers.get("python"):
        raise AssertionError(f"gate: load_obj's parsers {parsers}: the "
                             "native parser did not run every time")
    args = gate.build_argparser().parse_args(argv)
    log_root = gate._arm_log_root(root, "ship", gate.arm_cfg(args, "ship"))
    entry = gate.arm_entry(log_root)
    vals = [entry.get("first_loss"), entry.get("last_loss"),
            *entry.get("val", {}).values()]
    if (entry.get("iters") != iters or len(vals) < 10
            or not np.isfinite(np.asarray(vals, float)).all()
            or "final_relight_psnr" not in entry["val"]):
        raise AssertionError(f"gate: entry {entry}")
    if not entry["last_loss"] < entry["first_loss"]:
        raise AssertionError(f"gate: the loss did not fall: "
                             f"{entry['first_loss']} -> {entry['last_loss']}")
    rss = max(r[1] for r in entry["memory"]["samples"])
    log(f"[gate] ship arm at canonical width, {iters} iterations in "
        f"{t_gate:.1f} s (main(), scene and precompute included): "
        f"{entry['iters_per_s']:.3f} iterations/s (summary.json timing, "
        f"{entry['timing']['iters_timed']} after the first); peak device "
        f"{entry['peak_device_mib']:.1f} MiB; host RSS {rss:.1f} MiB at "
        f"most over the arm (this process's peak "
        f"{entry['peak_rss_mib']:.1f}); on {entry['device']}")
    log(f"[gate] loss {entry['first_loss']:.6g} -> {entry['last_loss']:.6g}; "
        + ", ".join(f"{k} {entry['val'][k]:.4f}" for k in (
            "final_psnr", "final_ssim", "final_relight_psnr",
            "final_relight_ssim")) + f"; load_obj parsers {parsers}")
    rec["gate"] = dict(entry={k: entry[k] for k in (
        "first_loss", "last_loss", "iters", "iters_per_s",
        "peak_device_mib", "peak_rss_mib", "device")}, parsers=parsers,
        slab_parity=slab_step_parity(root, gate._latest_run(log_root)[0]),
        big_mesh=native_parser(BIG_LAT_LON, "gate"), smi=smi)
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


# -------------------------------------------------------------- determinism
#
# Every training and eval path run four times from the same weights,
# batch and generator: twice under torch.use_deterministic_algorithms(True)
# (an aten op with no deterministic form raises there) and twice as the
# entry points leave it, the run a user makes (an op deterministic only
# under the flag would part those two).  Each pair's digests (parameters,
# buffers, Adam state, losses; frames; gradients) must be equal.  The two
# modes may take different, each fixed, algorithms: whether their digests
# agree is logged.
DETERMINISM_ROUTES = ("pallas3", "pallas", "p3s4", "slab3", "slab", "xla")
DETERMINISM_STEPS = 5
DETERMINISM_DNR_STEPS = 3


def _step_digest(model, opt, mets) -> str:
    """Parameters, buffers, Adam state (in parameter order) and every
    step's metrics, as one sha256; every metric finite."""
    for m in mets:
        if not all(bool(torch.isfinite(v).all()) for v in m.values()):
            raise AssertionError(f"determinism: a non-finite metric in "
                                 f"{sorted(m)}")
    ts = [p.detach() for _, p in model.named_parameters()]
    ts += [b for _, b in model.named_buffers()]
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state.get(p, {})
            ts += [st[k] for k in sorted(st) if torch.is_tensor(st[k])]
    ts += [m[k].detach().float().reshape(-1) for m in mets
           for k in sorted(m)]
    return digest(*ts)


def repeat_runs(tag: str, run, out: dict) -> None:
    """run() -> digest, four times (twice under the deterministic flag,
    twice without); each pair equal, else AssertionError."""
    was = torch.are_deterministic_algorithms_enabled()
    got = []
    t0 = time.perf_counter()
    try:
        for flag in (True, True, False, False):
            torch.use_deterministic_algorithms(flag)
            got.append(run())
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(was)
    out[tag] = dict(flag_on=got[0], flag_off=got[2])
    log(f"[determinism] {tag}: digests {[d[:16] for d in got]} (flag on "
        f"twice, off twice; the two modes {'agree' if got[0] == got[2] else 'differ'}) "
        f"({time.perf_counter() - t0:.1f} s)")
    if got[0] != got[1] or got[2] != got[3]:
        raise AssertionError(f"determinism {tag}: the runs differ "
                             f"(flag on, on, off, off): {got}")


def phase_determinism(out: dict) -> None:
    """The shipped b1 train step (DETERMINISM_STEPS steps) under every
    conv route, the unfused step, one probe step, DETERMINISM_DNR_STEPS
    DNR steps ("auto", f32), the shipped eval frame (v_feature included)
    and the DNR frame, the drivers' fresh weights (init_rnr_params, the
    global RNG seeded anew each time) and rasterize_opt forward and
    backward at 512^2,
    each run twice under the deterministic flag and twice without from
    the same start (repeat_runs): each pair bit-equal by digest.  CUBLAS_WORKSPACE_CONFIG is set in main() before the first
    CUDA call; the deterministic flag is restored after each run."""
    from rnr_tpu_torch.models.rnr import RNRModel
    from rnr_tpu_torch.ops import edge_grad as eg
    from rnr_tpu_torch.synthetic import build_statics, init_weights
    from rnr_tpu_torch.train import steps as st
    b = _gbuffer(IMG, 1)

    def restorer(model):
        """The model at its seeded start again at each call (the runs
        build it once)."""
        state = {k: v.clone() for k, v in model.state_dict().items()}

        def restore():
            model.load_state_dict(state)
            model.zero_grad(set_to_none=True)
            return model

        return restore

    def rnr_steps(sections: dict, n: int):
        model = init_weights(RNRModel(canonical_config(**sections), GCN_V),
                             seed=0)
        statics = build_statics(model, 4096)
        restore = restorer(model)

        def run():
            restore()
            opt = st.create_rnr_optimizer(model, 1e-3)
            step = st.make_rnr_train_step(model, opt)
            gen = st.make_generator(0)
            mets = [step(b, statics, gen) for _ in range(n)]
            return _step_digest(model, opt, mets)
        return run

    for route in DETERMINISM_ROUTES:
        sections = ({} if route == "pallas3"
                    else dict(render_net=dict(conv_backend=route)))
        repeat_runs(f"train step {route}, {DETERMINISM_STEPS} steps",
                    rnr_steps(sections, DETERMINISM_STEPS), out)
    repeat_runs(f"unfused train step, {DETERMINISM_STEPS} steps",
                rnr_steps(TRAIN_VARIANTS["unfused"][0], DETERMINISM_STEPS),
                out)
    repeat_runs("probe train step, 1 step",
                rnr_steps(TRAIN_VARIANTS["probe"][0], 1), out)

    restore = restorer(init_weights(RNRModel(canonical_config(), GCN_V),
                                    seed=0))

    def eval_frame():
        model = restore()
        with torch.inference_mode():
            vf = model.compute_v_feature(b["gcn_pos"])
        img = st.make_rnr_eval_step(model)(b, v_feature=vf)["img"]
        return digest(vf, img)

    repeat_runs("shipped eval frame (v_feature and image)", eval_frame, out)

    from rnr_tpu_torch.config import (DNRConfig, LossConfig,
                                      RenderNetConfig, TextureConfig,
                                      TrainConfig)
    dcfg = DNRConfig(
        texture=TextureConfig(texture_size=512, texture_num_ch=DNR_CH,
                              mipmap_level=4),
        render_net=RenderNetConfig(nf0=64, num_down_unet=5),
        loss=LossConfig(), train=TrainConfig(img_size=IMG))
    db = {k: v[:1] for k, v in dnr_batch(DEV).items()}

    restore = restorer(st.init_dnr_params(st.build_dnr_modules(dcfg), 0))

    def dnr_steps():
        mods = restore()
        opt = st.create_rnr_optimizer(mods, 1e-3)
        step = st.make_dnr_train_step(dcfg, mods, opt)
        gen = st.make_generator(0)
        mets = [step(db, gen) for _ in range(DETERMINISM_DNR_STEPS)]
        return _step_digest(mods, opt, mets) + digest(
            st.make_dnr_eval_step(dcfg, mods)(db))

    repeat_runs(f"DNR train step ({DETERMINISM_DNR_STEPS} steps) and frame",
                dnr_steps, out)

    global_seeds = iter(range(1, 5))

    def fresh_weights():
        # the drivers' fresh weights (init_rnr_params), the global RNG
        # seeded anew for each call as another process would have it
        torch.manual_seed(next(global_seeds))
        return digest(*st.init_rnr_params(
            RNRModel(canonical_config(), GCN_V), 0).state_dict().values())

    repeat_runs("init_rnr_params, the drivers' fresh weights", fresh_weights,
                out)

    faces = ring_faces(*MESH_LAT_LON, EDGE_ELEVATION, [0], IMG)
    rng = np.random.default_rng(22)
    w1 = torch.from_numpy(rng.uniform(0.2, 1, (1, IMG, IMG)).astype(
        np.float32)).to(DEV)
    w3 = torch.from_numpy(rng.uniform(0.2, 1, (1, 3, IMG, IMG)).astype(
        np.float32)).to(DEV)
    tex = torch.from_numpy(rng.uniform(0, 1, (1, faces.shape[1], 2, 2, 2, 3))
                           .astype(np.float32)).to(DEV)

    def raster_opt():
        f = faces.detach().clone().requires_grad_(True)
        t = tex.clone().requires_grad_(True)
        o = eg.rasterize_opt(f, t, IMG, near=0.0, far=100.0)
        ((o["rgb"] * w3).sum() + (o["alpha"] * w1).sum()
         + (o["depth"] * w1).sum() * 1e-3).backward()
        return digest(o["rgb"], o["alpha"], o["depth"], f.grad, t.grad)

    repeat_runs(f"rasterize_opt forward and backward at {IMG}^2",
                raster_opt, out)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="device,build,kernels,slice,"
                                        "gbuffer,relight,parity,train,"
                                        "train_parity,drivers,dnr,edge_grad,"
                                        "parallel,sp,gate,determinism")
    phases = ap.parse_args().phases.split(",")
    # cuBLAS's fixed workspace, which torch.use_deterministic_algorithms
    # asks for: set before the first CUDA call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    driver_launches: dict = {}
    dnr_launches: dict = {}
    edge_launches: dict = {}
    remat_launches: dict = {}
    sp_launches: dict = {}
    gate_launches: dict = {}
    gate_rec: dict = {}
    parallel: dict = {}
    sp: dict = {}
    determinism: dict = {}

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
        gcn_block_knn(state)
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
    train_out: dict = {}
    if "train" in phases:
        train_out = phase_train(train_launches, variant_launches)
        done("train")
    if "train_parity" in phases:
        phase_train_parity()
        done("train_parity")
    if "drivers" in phases:
        phase_drivers(driver_launches, train_out, smi)
        done("drivers")
    if "dnr" in phases:
        phase_dnr(dnr_launches, rec)
        done("dnr")
    if "edge_grad" in phases:
        phase_edge_grad(edge_launches, rec)
        done("edge_grad")
    if "parallel" in phases:
        phase_parallel(remat_launches, parallel)
        done("parallel")
        log(f"[parallel] {json.dumps(parallel)}")
    if "sp" in phases:
        phase_sp(sp_launches, sp)
        done("sp")
        log(f"[sp] {json.dumps(sp)}")
    if "gate" in phases:
        phase_gate(gate_launches, gate_rec, smi)
        done("gate")
        log(f"[gate] {json.dumps(gate_rec)}")
    if "determinism" in phases:
        phase_determinism(determinism)
        done("determinism")
        log(f"[determinism] {json.dumps(determinism)}")
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
                    drivers_launches=driver_launches.get(n),
                    dnr_launches={k: c.get(n) for k, c in
                                  dnr_launches.items()},
                    edge_grad_launches=(edge_launches or None)
                    if n == "rasterize_tiles" else None,
                    remat_launches={m: c.get(n) for m, c in
                                    remat_launches.items()},
                    sp_launches=sp_launches.get(n),
                    gate_launches=gate_launches.get(n),
                    **rec.get(n, {}))
               for n, s in KERNELS.items()]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
