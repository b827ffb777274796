"""Drive the PyTorch + CUDA port on one NVIDIA GPU: the serving path and
the training step.

    python3 chip_smoke.py            # every phase (one H100, a few minutes)
    python3 chip_smoke.py --phases device,build,kernels
    python3 chip_smoke.py --phases device,build,train

Phases (each failure raises, so the script exits non-zero):
  device   CUDA present, capability (9, 0), the card's name and power limit.
  build    nvcc builds the six sources of rnr_tpu_torch/csrc/ (the seven
           kernels), one nvcc per source, all started together.
  kernels  each kernel against its plain PyTorch version on the card, at
           the shapes of the canonical 512^2 step, with the stated
           tolerance; the median time of the kernel, of its plain version
           and, where one PyTorch call computes the same function, of that
           call; and the bound: the least time the card could take for the
           work.  K1b and K3b run twice and must agree bit for bit; K2b
           (f32 atomics) reports its run-to-run difference.
  slice    the canonical model (512^2, texture 512^2 x 24, lmax 10, 13+13
           rays, U-Net nf0 64 / 5 downs / dense fusion, GCN 20 blocks k=16
           on 7500 vertices; bf16 rays, fan-fused K1, K3 for every 3x3)
           with seeded weights: v_feature once, then eval frames.  Checks
           the image and the launch count of every kernel, then times the
           GCN and the eval frames/s; a torch.profiler pass prints device
           time by kernel.
  parity   the same model at 128^2 on the card (kernels) and on the CPU
           (plain versions) from the same v_feature; images compared.
  train    the canonical training step (the slice's model, dropout 0.1,
           stochastic GCN with epsilon 0.2, Adam lr 1e-3) at batch 1, then
           batch 2: two warm-up steps, one step whose launch counts,
           losses, gradients, parameter moves and SNDense vectors are
           checked, then timed steps (frames/s on the host clock, step ms
           by CUDA events, peak memory) and a torch.profiler pass.
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
from rnr_tpu_torch.ops.conv_cuda import (conv3x3, conv3x3_dgrad,  # noqa: E402
                                         conv3x3_dgrad_torch, conv3x3_torch,
                                         conv3x3_wgrad, conv3x3_wgrad_torch)
from rnr_tpu_torch.ops.interpolate import bilinear_taps  # noqa: E402
from rnr_tpu_torch.ops.knn_cuda import (stratified_knn,  # noqa: E402
                                        stratified_knn_torch)
from rnr_tpu_torch.ops.sh_cuda import (sh_shade_fan,  # noqa: E402
                                       sh_shade_fan_bwd,
                                       sh_shade_fan_bwd_torch,
                                       sh_shade_fan_torch)
from rnr_tpu_torch.ops.texture_cuda import (level_coords,  # noqa: E402
                                            mipmap_sample,
                                            mipmap_sample_torch,
                                            mipmap_scatter,
                                            mipmap_scatter_torch)

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
}
SOURCES = ("sh_fan", "mipmap_gather", "mipmap_scatter", "conv3x3",
           "conv3x3_wgrad", "stratified_knn")

# launches of each kernel in one canonical training step
TRAIN_LAUNCHES = {"stratified_knn": 17, "conv3x3": 28, "conv3x3_wgrad": 14,
                  "sh_shade_fan": 1, "sh_shade_fan_bwd": 1}
AT_LEAST_ONE = ("mipmap_gather", "mipmap_scatter")

# (C, O, H) of the 14 3x3 convs of one canonical 512^2 frame, in order
CONV_SHAPES = [(108, 64, 512), (64, 64, 512), (128, 640, 256),
               (640, 128, 256), (128, 128, 256), (256, 256, 128),
               (512, 512, 64), (512, 512, 32), (512, 512, 32),
               (512, 512, 64), (256, 256, 128), (128, 128, 256),
               (64, 64, 512), (128, 78, 512)]
TEX_SIZES = (512, 256, 128, 64)

# Published peaks of one H100 SXM (dense, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12

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
# product, two normalisations), then per basis value at least 3 for the
# recurrence and 6 for the radiance (3 FMAs); the backward recomputes both
# and adds 6 per value for d coeff (3 FMAs).  They run on the f32 pipes.


def sh_work(n_pix: int, r: int, lmax: int, lt_item: int, bwd: bool):
    nb = (lmax + 1) ** 2
    geo = 9 * 4 + 3 * 4 + 4                     # TBN, view dir, alpha
    lt = r * 3 * lt_item
    if bwd:   # + gs, gd in; d rays_lt, d coeff out
        nbytes = n_pix * (geo + lt + 6 * 4 + lt) + 2 * nb * 3 * 4 + r * 12
        flops = n_pix * r * (50 + 15 * nb + 12)
    else:     # spec, diff out
        nbytes = n_pix * (geo + lt + 6 * 4) + nb * 3 * 4 + r * 12
        flops = n_pix * r * (50 + 9 * nb + 6)
    return bound(nbytes, flops, F32_FLOPS)


def texture_work(n_pix: int, ch: int, sizes, taps: int):
    """Gather and scatter alike: uv and the per-pixel values [ch] on one
    side, every level once on the other; 2 ops per channel per tap."""
    nbytes = n_pix * (2 * 4 + ch * 4) + sum(s * s * ch * 4 for s in sizes)
    return bound(nbytes, taps * ch * 2, F32_FLOPS)


def conv_work(kind: str, n_pix: int, c: int, o: int):
    flops = 2 * 9 * c * o * n_pix
    if kind == "fwd":      # x, w bf16, bias f32 -> y bf16
        nbytes = n_pix * c * 2 + 9 * c * o * 2 + o * 4 + n_pix * o * 2
    elif kind == "dgrad":  # g, w bf16 -> dx f32
        nbytes = n_pix * o * 2 + 9 * c * o * 2 + n_pix * c * 4
    else:                  # x, g bf16 -> dW f32
        nbytes = n_pix * (c + o) * 2 + 9 * c * o * 4
    return bound(nbytes, flops, BF16_TENSOR_FLOPS)


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


def kernels_sh(rec: dict, b: dict, rng) -> None:
    """K1 and K1b: 512^2, lmax 10, 13 + 13 rays, bf16 rays_lt."""
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
    args = (b["TBN_map"], b["view_dir_map_tangent"], b["alpha_map"], lt, cf,
            piv, 10, 13)
    n_pix = IMG * IMG
    ks, kd = sh_shade_fan(*args)
    ts, td = sh_shade_fan_torch(*args)
    torch.cuda.synchronize()
    scale = max(float(ts.abs().max()), float(td.abs().max()))
    err = max(float((ks - ts).abs().max()), float((kd - td).abs().max()))
    tol = 1e-4 * scale + 1e-5   # f32 both sides; FMA and sum order differ
    log(f"[kernels] sh_shade_fan {IMG}^2 lmax10 R26 bf16: max abs err "
        f"{err:.3g}, rel {err / scale:.3g} (max |ref| {scale:.3g}, "
        f"tol {tol:.3g})")
    check("sh_shade_fan", err, tol)
    rec["sh_shade_fan"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: sh_shade_fan(*args)),
        plain_ms=cuda_ms(lambda: sh_shade_fan_torch(*args), iters=3,
                         warmup=1),
        library_ms=None, **sh_work(n_pix, 26, 10, 2, False))
    del ks, kd, ts, td

    # K1b: the output gradients of both means
    gs = torch.from_numpy(rng.standard_normal((1, IMG, IMG, 3)).astype(
        np.float32)).to(DEV)
    gd = torch.from_numpy(rng.standard_normal((1, IMG, IMG, 3)).astype(
        np.float32)).to(DEV)
    bargs = (*args[:6], gs, gd, 10, 13)
    kl, kc = sh_shade_fan_bwd(*bargs)
    kl2, kc2 = sh_shade_fan_bwd(*bargs)
    tl, tc = sh_shade_fan_bwd_torch(*bargs)
    torch.cuda.synchronize()
    if not (torch.equal(kc, kc2) and torch.equal(kl, kl2)):
        raise AssertionError("sh_shade_fan_bwd: two runs differ")
    err_c = float((kc - tc).abs().max())
    scale_c = float(tc.abs().max())
    # d coeff: f32 sums over 6.8M pixel-rays in another order
    check("sh_shade_fan_bwd d coeff", err_c, 1e-4 * scale_c)
    err_l = float((kl.float() - tl.float()).abs().max())
    scale_l = float(tl.float().abs().max())
    # d rays_lt: f32 radiance (FMA contraction), then one bf16 rounding,
    # which may land one step (2^-8 relative) the other way
    check("sh_shade_fan_bwd d rays_lt", err_l, 2 ** -7 * scale_l)
    log(f"[kernels] sh_shade_fan_bwd: d coeff max abs err {err_c:.3g} "
        f"(rel {err_c / scale_c:.3g}, tol 1e-4 x max), d rays_lt max abs "
        f"err {err_l:.3g} (rel {err_l / scale_l:.3g}, tol 2^-7 x max); "
        f"two runs bitwise equal")
    rec["sh_shade_fan_bwd"] = dict(
        max_abs_err=max(err_c, err_l), dcoeff_max_abs_err=err_c,
        dlt_max_abs_err=err_l, bitwise_reproducible=True,
        ms=cuda_ms(lambda: sh_shade_fan_bwd(*bargs)),
        plain_ms=cuda_ms(lambda: sh_shade_fan_bwd_torch(*bargs), iters=3,
                         warmup=1),
        library_ms=None, **sh_work(n_pix, 26, 10, 2, True))
    del kl, kc, kl2, kc2, tl, tc, lt
    torch.cuda.synchronize()


def kernels_texture(rec: dict, b: dict, rng) -> None:
    """K2 and K2b: the G-buffer's uv (about half the frame uncovered, at
    uv = 0) over 4 levels 512..64 x 24 channels."""
    texs = [torch.from_numpy((0.5 + 0.5 * rng.standard_normal(
        (s, s, 24))).astype(np.float32)).to(DEV) for s in TEX_SIZES]
    uv = b["uv_map"]
    n_pix = uv.shape[0] * uv.shape[1] * uv.shape[2]
    k = mipmap_sample(texs, uv)
    t = mipmap_sample_torch(texs, uv)
    torch.cuda.synchronize()
    scale = float(t.abs().max())
    err = float((k - t).abs().max())
    tol = 1e-5 * scale + 1e-6   # f32 both sides; FMA contraction only
    log(f"[kernels] mipmap_gather {IMG}^2 4 levels x 24: max abs err "
        f"{err:.3g}, rel {err / scale:.3g} (max |ref| {scale:.3g}, "
        f"tol {tol:.3g})")
    check("mipmap_gather", err, tol)
    rec["mipmap_gather"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: mipmap_sample(texs, uv)),
        plain_ms=cuda_ms(lambda: mipmap_sample_torch(texs, uv)),
        library_ms=None,
        **texture_work(n_pix, 24, TEX_SIZES, n_pix * 4 * len(TEX_SIZES)))

    g = torch.from_numpy(rng.standard_normal((1, IMG, IMG, 24)).astype(
        np.float32)).to(DEV)
    kg = mipmap_scatter(uv, g, TEX_SIZES)
    kg2 = mipmap_scatter(uv, g, TEX_SIZES)
    tg = mipmap_scatter_torch(uv, g, TEX_SIZES)
    mag = mipmap_scatter_torch(uv, g.abs(), TEX_SIZES)
    torch.cuda.synchronize()
    err = rerun = 0.0
    for a, a2, r, m, s in zip(kg, kg2, tg, mag, TEX_SIZES):
        # f32 atomics on both sides: the same products added in another
        # order, so each texel may differ by a rounding of its partial
        # sums; held per texel to 1e-5 x the sum of its terms' magnitudes
        # (the corner texel of the uncovered pixels sums 131,072 terms)
        excess = float(((a - r).abs() - 1e-5 * m).max())
        check(f"mipmap_scatter level {s}", excess, 0.0)
        err = max(err, float((a - r).abs().max()))
        rerun = max(rerun, float((a - a2).abs().max()))
    # the kernel skips taps of weight exactly 0: count this uv's others
    taps = 0
    for s in TEX_SIZES:
        x, y = level_coords(uv, s)
        taps += sum(int((w != 0).sum()) for _, w in bilinear_taps(x, y, s, s))
    log(f"[kernels] mipmap_scatter {IMG}^2 -> 4 levels x 24: max abs err "
        f"{err:.3g} (tol 1e-5 x max per level); run-to-run max difference "
        f"{rerun:.3g} (f32 atomics); {taps} nonzero taps of "
        f"{n_pix * 4 * len(TEX_SIZES)}")
    rec["mipmap_scatter"] = dict(
        max_abs_err=err, rerun_max_diff=rerun,
        ms=cuda_ms(lambda: mipmap_scatter(uv, g, TEX_SIZES)),
        plain_ms=cuda_ms(lambda: mipmap_scatter_torch(uv, g, TEX_SIZES),
                         iters=3, warmup=1),
        library_ms=None, **texture_work(n_pix, 24, TEX_SIZES, taps))
    torch.cuda.synchronize()


def kernels_conv(rec: dict, rng) -> None:
    """K3 (forward, and its f32-output data gradient) and K3b over the 14
    convs of a frame, reflect padding, bf16 activations and gradients."""
    errs = {"fwd": [], "dgrad": [], "wgrad": []}
    tot = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
           for k in errs}
    works = {k: [] for k in errs}
    aten_bwd = torch.ops.aten.convolution_backward
    for c, o, h in CONV_SHAPES:
        x = torch.from_numpy(rng.standard_normal((1, h, h, c)).astype(
            np.float32)).to(DEV, torch.bfloat16)
        g = torch.from_numpy(rng.standard_normal((1, h, h, o)).astype(
            np.float32)).to(DEV, torch.bfloat16)
        w = torch.from_numpy((rng.standard_normal((3, 3, c, o))
                              / np.sqrt(9 * c)).astype(np.float32)).to(DEV)
        bias = torch.from_numpy(rng.standard_normal(o).astype(
            np.float32)).to(DEV)
        ky = conv3x3(x, w, bias, "reflect")
        ty = conv3x3_torch(x, w, bias, "reflect")
        kd = conv3x3_dgrad(g, w, "reflect")
        td = conv3x3_dgrad_torch(g, w, "reflect")
        kw = conv3x3_wgrad(x, g, "reflect")
        kw2 = conv3x3_wgrad(x, g, "reflect")
        tw = conv3x3_wgrad_torch(x, g, "reflect")
        torch.cuda.synchronize()
        if not torch.equal(kw, kw2):
            raise AssertionError(f"conv3x3_wgrad {c}->{o} @{h}: two runs "
                                 "differ")
        tag = f"{c}->{o} @{h}"
        # fwd: bf16 output, one rounding step of the largest values (2^-8
        # relative) from f32 sums in another order; dgrad and wgrad: bf16
        # operands multiply exactly, f32 sums in another order
        for kind, k, t, rel in (("fwd", ky.float(), ty.float(), 2 ** -7),
                                ("dgrad", kd, td, 1e-4),
                                ("wgrad", kw, tw, 1e-4)):
            scale = float(t.abs().max())
            e = float((k - t).abs().max())
            check(f"conv3x3 {kind} {tag}", e, rel * scale)
            errs[kind].append(e)
        # the library yardsticks: cuDNN on the NCHW channels-last views,
        # zero padding (the same FLOPs; reflect needs a second call)
        xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        wn = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bn = bias.to(torch.bfloat16)
        fns = {
            "fwd": (lambda: conv3x3(x, w, bias, "reflect"),
                    lambda: conv3x3_torch(x, w, bias, "reflect"),
                    lambda: F.conv2d(xn, wn, bn, padding=1)),
            "dgrad": (lambda: conv3x3_dgrad(g, w, "reflect"),
                      lambda: conv3x3_dgrad_torch(g, w, "reflect"),
                      lambda: aten_bwd(gn, xn, wn, None, [1, 1], [1, 1],
                                       [1, 1], False, [0, 0], 1,
                                       [True, False, False])),
            "wgrad": (lambda: conv3x3_wgrad(x, g, "reflect"),
                      lambda: conv3x3_wgrad_torch(x, g, "reflect"),
                      lambda: aten_bwd(gn, xn, wn, None, [1, 1], [1, 1],
                                       [1, 1], False, [0, 0], 1,
                                       [False, True, False])),
        }
        line = []
        for kind, (kf, pf, lf) in fns.items():
            ms = cuda_ms(kf)
            pms = cuda_ms(pf, iters=3, warmup=1)
            lms = cuda_ms(lf)
            wk = conv_work(kind, h * h, c, o)
            works[kind].append(wk)
            tot[kind]["ms"] += ms
            tot[kind]["plain_ms"] += pms
            tot[kind]["library_ms"] += lms
            tflops = 2 * 9 * c * o * h * h / ms / 1e9
            line.append(f"{kind} {ms:.3f} ms ({tflops:.1f} TFLOP/s, bound "
                        f"{wk['bound_ms']:.3f}, cuDNN {lms:.3f}, plain "
                        f"{pms:.3f})")
        log(f"[kernels] conv3x3 {tag}: errs fwd {errs['fwd'][-1]:.3g} "
            f"dgrad {errs['dgrad'][-1]:.3g} wgrad {errs['wgrad'][-1]:.3g}; "
            + "; ".join(line))
        del x, g, ky, ty, kd, td, kw, kw2, tw
    for kind in errs:
        b = add_bounds(works[kind])
        log(f"[kernels] conv3x3 {kind}, 14 convs of a frame: kernel "
            f"{tot[kind]['ms']:.3f} ms, bound {b['bound_ms']:.3f} ms, "
            f"cuDNN {tot[kind]['library_ms']:.3f} ms, plain "
            f"{tot[kind]['plain_ms']:.3f} ms")
    fd = add_bounds(works["fwd"] + works["dgrad"])
    rec["conv3x3"] = dict(
        max_abs_err=max(errs["fwd"] + errs["dgrad"]),
        ms=tot["fwd"]["ms"] + tot["dgrad"]["ms"],
        plain_ms=tot["fwd"]["plain_ms"] + tot["dgrad"]["plain_ms"],
        library_ms=tot["fwd"]["library_ms"] + tot["dgrad"]["library_ms"],
        fwd_ms=tot["fwd"]["ms"], dgrad_ms=tot["dgrad"]["ms"],
        fwd_bound_ms=add_bounds(works["fwd"])["bound_ms"],
        dgrad_bound_ms=add_bounds(works["dgrad"])["bound_ms"], **fd)
    rec["conv3x3_wgrad"] = dict(
        max_abs_err=max(errs["wgrad"]), bitwise_reproducible=True,
        **tot["wgrad"], **add_bounds(works["wgrad"]))
    torch.cuda.synchronize()


def kernels_knn(rec: dict, rng) -> None:
    """K4: V 7500, C 64; indices must agree except at exact score ties."""
    x = torch.from_numpy(rng.standard_normal((7500, 64)).astype(
        np.float32)).to(DEV)
    ki = stratified_knn(x, 16)
    ti = stratified_knn_torch(x, 16)
    torch.cuda.synchronize()
    mism = (ki != ti).nonzero()
    xd = x.to(torch.bfloat16).double()
    sq = (xd * xd).sum(1)
    n_tie = 0
    for i, s in mism.tolist():
        a, c_ = int(ki[i, s]), int(ti[i, s])
        sa = 2 * float(xd[i] @ xd[a]) - float(sq[a])
        sc = 2 * float(xd[i] @ xd[c_]) - float(sq[c_])
        if sa != sc:
            raise AssertionError(f"stratified_knn: row {i} stratum {s}: "
                                 f"kernel {a} (score {sa}) vs twin {c_} "
                                 f"(score {sc})")
        n_tie += 1
    log(f"[kernels] stratified_knn V7500 C64: {ki.numel()} indices, "
        f"{len(mism)} differ, all at exact score ties ({n_tie})")
    v, c, ns = 7500, 64, ki.shape[1]
    rec["stratified_knn"] = dict(
        max_abs_err=float(len(mism) - n_tie),
        ms=cuda_ms(lambda: stratified_knn(x, 16)),
        plain_ms=cuda_ms(lambda: stratified_knn_torch(x, 16)),
        library_ms=None,
        # the kernel reads x in bf16 and writes int32 indices; its 2 V^2 C
        # score operations are bf16 products (exact in f32) with f32 sums,
        # the work of a bf16 tensor-core GEMM, so bound at that unit's peak
        **bound(v * c * 2 + v * ns * 4, 2 * v * v * c, BF16_TENSOR_FLOPS))
    torch.cuda.synchronize()


def phase_kernels(rec: dict) -> None:
    rng = np.random.default_rng(0)
    b = _gbuffer(IMG)
    kernels_sh(rec, b, rng)
    kernels_texture(rec, b, rng)
    kernels_conv(rec, rng)
    kernels_knn(rec, rng)
    for name, r in rec.items():
        log(f"[kernels] {name}: kernel {r['ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
            f"{r['plain_ms']:.3f} ms, library "
            + ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.3f} ms"))


def canonical_config(img: int = IMG, **gcn):
    from rnr_tpu_torch.synthetic import build_config
    cfg = build_config(img_size=img, tex_size=512, lmax=10, nf0=64,
                       num_down=5, gcn_blocks=20, num_azi=6, num_polar=2,
                       num_sample=4096)
    if gcn:
        cfg = dataclasses.replace(cfg, gcn=dataclasses.replace(cfg.gcn,
                                                               **gcn))
    return cfg


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
    log(f"[slice] GCN forward (v_feature, V 7500, 20 blocks): {gcn_ms:.3f} ms")
    log(f"[slice] eval frames/s at {IMG}^2 (cached v_feature): {fps:.3f}; "
        f"frame {frame_ms:.3f} ms by CUDA events")
    return {"model": model, "v_feature": vf}


def profile_window(name: str, fn, n: int, top: int = 12) -> None:
    """torch.profiler over n runs of fn: device time by kernel, and the
    share of the traced window the device was busy (sum of kernel times
    over first kernel start to last kernel end)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
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


def phase_parity(state: dict) -> None:
    """The slice's model at 128^2: card (kernels) vs CPU (plain versions),
    both from the card's v_feature."""
    model, vf = state["model"], state["v_feature"]
    from rnr_tpu_torch.models.rnr import RNRModel
    from rnr_tpu_torch.synthetic import build_batch, to_torch
    from rnr_tpu_torch.train.steps import make_rnr_eval_step
    nb = build_batch(128, GCN_V)
    bc, bh = to_torch(nb, DEV), to_torch(nb, "cpu")
    cpu = RNRModel(model.cfg, GCN_V, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    torch.set_num_threads(os.cpu_count() or 1)
    a = make_rnr_eval_step(model)(bc, v_feature=vf)["img"].float().cpu()
    t0 = time.perf_counter()
    r = make_rnr_eval_step(cpu)(bh, v_feature=vf.cpu())["img"].float()
    log(f"[parity] CPU frame at 128^2: {time.perf_counter() - t0:.1f} s")
    scale = float(r.abs().max())
    d = (a - r).abs()
    err, mean = float(d.max()), float(d.mean())
    # bf16 U-Net (14 convs, 5 levels of batch statistics): a flipped bf16
    # rounding (2^-8 relative) in one layer moves the next layers' inputs
    tol_max, tol_mean = 5e-2 * scale, 5e-3 * scale
    log(f"[parity] card vs CPU image 128^2: max abs err {err:.4g} "
        f"(rel {err / scale:.3g}, tol {tol_max:.4g}), mean abs err "
        f"{mean:.4g} (rel {mean / scale:.3g}, tol {tol_mean:.4g}), "
        f"max |ref| {scale:.4g}")
    check("parity max", err, tol_max)
    check("parity mean", mean, tol_mean)


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


def phase_train(train_launches: dict) -> dict:
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
            before = {n: p.detach().clone()
                      for n, p in model.named_parameters()}
            u_before = {n: u.clone() for n, u in model.named_buffers()
                        if n.endswith(".u")}
            reset_launches()
            met = step(b, statics, gen)
            torch.cuda.synchronize()
            train_launches.update(read_launches())
            log(f"[train] launches in one step at batch 1: {train_launches}")
            for name, want in TRAIN_LAUNCHES.items():
                if train_launches[name] != want:
                    raise AssertionError(f"{name} launched "
                                         f"{train_launches[name]} times in a "
                                         f"step, expected {want}")
            for name in AT_LEAST_ONE:
                if train_launches[name] < 1:
                    raise AssertionError(f"{name} not launched in a step")
            check_step(model, before, u_before, met)
            del before
        n = 5
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(n):
            met = step(b, statics, gen)
        torch.cuda.synchronize()
        fps = bsz * n / (time.perf_counter() - t0)
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        step_ms = cuda_ms(lambda: step(b, statics, gen), iters=5, warmup=0)
        loss = float(met["loss"])
        if not np.isfinite(loss):
            raise AssertionError(f"loss {loss} at batch {bsz}")
        log(f"[train] batch {bsz} at {IMG}^2: {fps:.3f} train frames/s "
            f"(host clock, {n} steps after synchronize); step "
            f"{step_ms:.3f} ms by CUDA events; peak memory "
            f"{mem:.3f} GiB; loss {loss:.6g}")
        out[bsz] = dict(fps=fps, step_ms=step_ms, peak_gib=mem)
        if bsz == 1:
            profile_window("train step b1", lambda: step(b, statics, gen), 1,
                           top=20)
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
    ap.add_argument("--phases", default="device,build,kernels,slice,parity,"
                                        "train,train_parity")
    phases = ap.parse_args().phases.split(",")
    t_start = time.perf_counter()
    smi = phase_device()
    rec: dict = {}
    eval_launches: dict = {}
    train_launches: dict = {}

    def done(name):
        torch.cuda.synchronize()
        log(f"[time] {name} done at {time.perf_counter() - t_start:.1f} s")

    if "build" in phases:
        phase_build()
        done("build")
    if "kernels" in phases:
        phase_kernels(rec)
        done("kernels")
    if "slice" in phases or "parity" in phases:   # parity reuses the model
        state = phase_slice(eval_launches)
        profile_slice(state)
        done("slice")
        if "parity" in phases:
            phase_parity(state)
            done("parity")
        del state
        torch.cuda.empty_cache()
    if "train" in phases:
        phase_train(train_launches)
        done("train")
    if "train_parity" in phases:
        phase_train_parity()
        done("train_parity")
    kernels = [dict(name=n, route="cuda", source=s["source"],
                    replaces=s["replaces"], launches=train_launches.get(n),
                    eval_launches=eval_launches.get(n), **rec.get(n, {}))
               for n, s in KERNELS.items()]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
