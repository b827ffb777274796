"""Drive the PyTorch + CUDA port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase (one H100, ~a few min)
    python3 chip_smoke.py --phases device,build,kernels

Phases (each failure raises, so the script exits non-zero):
  device   CUDA present, capability (9, 0), the card's name and power limit.
  build    nvcc builds the four kernels of rnr_tpu_torch/csrc/.
  kernels  each kernel against its plain PyTorch twin on the card, at the
           shapes of the canonical 512^2 frame, with the stated tolerance
           and the median time of both.
  slice    the canonical model (512^2, texture 512^2 x 24, lmax 10, 13+13
           rays, U-Net nf0 64 / 5 downs / dense fusion, GCN 20 blocks k=16
           on 7500 vertices; bf16 rays, fan-fused K1, K3 for every 3x3)
           with seeded weights: v_feature once, then eval frames.  Checks
           the image and the launch count of every kernel, then times the
           GCN and the frames/s.
           A torch.profiler pass then prints device time by kernel.
  parity   the same model at 128^2 on the card (kernels) and on the CPU
           (twins) from the same v_feature; images compared.
The last line is {"ok": true, "device": {...}}; the line before it is the
per-kernel JSON record.  Nothing is printed as a result without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from rnr_tpu_torch.ops import _build  # noqa: E402
from rnr_tpu_torch.ops.conv_cuda import conv3x3, conv3x3_torch  # noqa: E402
from rnr_tpu_torch.ops.knn_cuda import (stratified_knn,  # noqa: E402
                                        stratified_knn_torch)
from rnr_tpu_torch.ops.sh_cuda import (sh_shade_fan,  # noqa: E402
                                       sh_shade_fan_torch)
from rnr_tpu_torch.ops.texture_cuda import (mipmap_sample,  # noqa: E402
                                            mipmap_sample_torch)

KERNELS = {
    "sh_shade_fan": dict(
        wrapper=sh_shade_fan, source="rnr_tpu_torch/csrc/sh_fan.cu",
        replaces="rnr_tpu/ops/sh_pallas.py:692"),
    "mipmap_gather": dict(
        wrapper=mipmap_sample, source="rnr_tpu_torch/csrc/mipmap_gather.cu",
        replaces="rnr_tpu/ops/texture_pallas.py:372"),
    "conv3x3": dict(
        wrapper=conv3x3, source="rnr_tpu_torch/csrc/conv3x3.cu",
        replaces="rnr_tpu/ops/conv_pallas.py:379"),
    "stratified_knn": dict(
        wrapper=stratified_knn, source="rnr_tpu_torch/csrc/stratified_knn.cu",
        replaces="rnr_tpu/ops/knn_pallas.py:81"),
}

# (C, O, H) of the 14 3x3 convs of one canonical 512^2 frame, in order
CONV_SHAPES = [(108, 64, 512), (64, 64, 512), (128, 640, 256),
               (640, 128, 256), (128, 128, 256), (256, 256, 128),
               (512, 512, 64), (512, 512, 32), (512, 512, 32),
               (512, 512, 64), (256, 256, 128), (128, 128, 256),
               (64, 64, 512), (128, 78, 512)]

DEV = torch.device("cuda", 0)


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
    for lib in ("sh_fan", "mipmap_gather", "conv3x3", "stratified_knn"):
        t0 = time.perf_counter()
        _build.load(lib)
        info = _build.build_info[lib]
        regs = [ln.strip() for ln in info["ptxas"].splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"[build] {lib}: {time.perf_counter() - t0:.2f} s "
            f"(nvcc {info['seconds']:.2f} s)")
        for ln in regs:
            log(f"[build]   {ln}")


def _gbuffer(img: int):
    from rnr_tpu_torch.synthetic import build_batch, to_torch
    return to_torch(build_batch(img, 7500), DEV)


def phase_kernels(rec: dict) -> None:
    rng = np.random.default_rng(0)
    b = _gbuffer(512)

    # K1: 512^2, lmax 10, 13 + 13 rays, bf16 rays_lt
    from rnr_tpu_torch.models.rays import RaySampler
    spec, diff = RaySampler(6, 2, 5.0, "reflect"), RaySampler(6, 2, 10.0,
                                                              "diffuse")
    piv = torch.from_numpy(np.concatenate([spec.pivots_dir.T,
                                           diff.pivots_dir.T]).astype(
        np.float32)).to(DEV)
    lt = torch.from_numpy(rng.uniform(0, 2, (1, 512, 512, 26, 3)).astype(
        np.float32)).to(DEV, torch.bfloat16)
    cf = torch.from_numpy((0.3 * rng.standard_normal((121, 3))).astype(
        np.float32)).to(DEV)
    args = (b["TBN_map"], b["view_dir_map_tangent"], b["alpha_map"], lt, cf,
            piv, 10, 13)
    ks, kd = sh_shade_fan(*args)
    ts, td = sh_shade_fan_torch(*args)
    torch.cuda.synchronize()
    scale = max(float(ts.abs().max()), float(td.abs().max()))
    err = max(float((ks - ts).abs().max()), float((kd - td).abs().max()))
    tol = 1e-4 * scale + 1e-5   # f32 both sides; FMA and sum order differ
    log(f"[kernels] sh_shade_fan 512^2 lmax10 R26 bf16: max abs err "
        f"{err:.3g}, rel {err / scale:.3g} (max |ref| {scale:.3g}, "
        f"tol {tol:.3g})")
    check("sh_shade_fan", err, tol)
    ms = cuda_ms(lambda: sh_shade_fan(*args))
    pms = cuda_ms(lambda: sh_shade_fan_torch(*args), iters=3, warmup=1)
    rec["sh_shade_fan"] = dict(max_abs_err=err, ms=ms, plain_ms=pms)
    log(f"[kernels] sh_shade_fan: kernel {ms:.3f} ms, twin {pms:.3f} ms")
    del lt, ks, kd, ts, td
    torch.cuda.synchronize()

    # K2: 512^2 uv over 4 levels 512..64 x 24 ch
    texs = [torch.from_numpy((0.5 + 0.5 * rng.standard_normal(
        (s, s, 24))).astype(np.float32)).to(DEV) for s in (512, 256, 128, 64)]
    uv = b["uv_map"]
    k = mipmap_sample(texs, uv)
    t = mipmap_sample_torch(texs, uv)
    torch.cuda.synchronize()
    scale = float(t.abs().max())
    err = float((k - t).abs().max())
    tol = 1e-5 * scale + 1e-6   # f32 both sides; FMA contraction only
    log(f"[kernels] mipmap_gather 512^2 4 levels x 24: max abs err "
        f"{err:.3g}, rel {err / scale:.3g} (max |ref| {scale:.3g}, "
        f"tol {tol:.3g})")
    check("mipmap_gather", err, tol)
    ms = cuda_ms(lambda: mipmap_sample(texs, uv))
    pms = cuda_ms(lambda: mipmap_sample_torch(texs, uv))
    rec["mipmap_gather"] = dict(max_abs_err=err, ms=ms, plain_ms=pms)
    log(f"[kernels] mipmap_gather: kernel {ms:.3f} ms, twin {pms:.3f} ms")
    torch.cuda.synchronize()

    # K3: the 14 convs of a frame, reflect padding
    errs, tot_ms, tot_pms = [], 0.0, 0.0
    for c, o, h in CONV_SHAPES:
        x = torch.from_numpy(rng.standard_normal((1, h, h, c)).astype(
            np.float32)).to(DEV, torch.bfloat16)
        w = torch.from_numpy((rng.standard_normal((3, 3, c, o))
                              / np.sqrt(9 * c)).astype(np.float32)).to(DEV)
        bias = torch.from_numpy(rng.standard_normal(o).astype(
            np.float32)).to(DEV)
        ky = conv3x3(x, w, bias, "reflect")
        ty = conv3x3_torch(x, w, bias, "reflect")
        torch.cuda.synchronize()
        d = (ky.float() - ty.float()).abs()
        scale = float(ty.float().abs().max())
        err = float(d.max())
        # bf16 output: one rounding step of the largest values (2^-8
        # relative), from f32 sums taken in another order
        tol = 2 ** -7 * scale
        check(f"conv3x3 {c}->{o} @{h}", err, tol)
        ms = cuda_ms(lambda: conv3x3(x, w, bias, "reflect"))
        pms = cuda_ms(lambda: conv3x3_torch(x, w, bias, "reflect"))
        tflops = 2 * 9 * c * o * h * h / ms / 1e9
        log(f"[kernels] conv3x3 {c}->{o} @{h}: max abs err {err:.3g}, rel "
            f"{err / scale:.3g} (max |ref| {scale:.3g}, tol {tol:.3g}); "
            f"kernel {ms:.3f} ms "
            f"({tflops:.1f} TFLOP/s), twin {pms:.3f} ms")
        errs.append(err)
        tot_ms += ms
        tot_pms += pms
    rec["conv3x3"] = dict(max_abs_err=max(errs), ms=tot_ms, plain_ms=tot_pms)
    log(f"[kernels] conv3x3 14 convs of a frame: kernel {tot_ms:.3f} ms, "
        f"twin {tot_pms:.3f} ms")
    torch.cuda.synchronize()

    # K4: V 7500, C 64; indices must agree except at exact score ties
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
    ms = cuda_ms(lambda: stratified_knn(x, 16))
    pms = cuda_ms(lambda: stratified_knn_torch(x, 16))
    rec["stratified_knn"] = dict(max_abs_err=float(len(mism) - n_tie),
                                 ms=ms, plain_ms=pms)
    log(f"[kernels] stratified_knn: kernel {ms:.3f} ms, twin {pms:.3f} ms")
    torch.cuda.synchronize()


def phase_slice(launches: dict) -> dict:
    from rnr_tpu_torch.models.rnr import RNRModel
    from rnr_tpu_torch.synthetic import build_config, init_weights
    from rnr_tpu_torch.train.steps import make_rnr_eval_step
    cfg = build_config(img_size=512, tex_size=512, lmax=10, nf0=64,
                       num_down=5, gcn_blocks=20, num_azi=6, num_polar=2)
    model = init_weights(RNRModel(cfg, 7500), seed=0).to(DEV)
    b = _gbuffer(512)
    step = make_rnr_eval_step(model)
    frames = 3
    for spec in KERNELS.values():
        spec["wrapper"].launches = 0
    with torch.inference_mode():
        vf = model.compute_v_feature(b["gcn_pos"])
    k4_gcn = stratified_knn.launches
    outs = [step(b, v_feature=vf)["img"] for _ in range(frames)]
    torch.cuda.synchronize()
    for name, spec in KERNELS.items():
        launches[name] = spec["wrapper"].launches
    log(f"[slice] launches in v_feature + {frames} frames: {launches}")
    if k4_gcn != 17:
        raise AssertionError(f"K4 launched {k4_gcn} times per GCN forward, "
                             "expected 17")
    if launches["conv3x3"] != 14 * frames:
        raise AssertionError(f"K3 launched {launches['conv3x3']} times in "
                             f"{frames} frames, expected {14 * frames}")
    for name in ("sh_shade_fan", "mipmap_gather"):
        if launches[name] < frames:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"in {frames} frames")
    img = outs[-1].float()
    if img.shape != (1, 512, 512, 3) or not bool(torch.isfinite(img).all()):
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
    log(f"[slice] eval frames/s at 512^2 (cached v_feature): {fps:.3f}; "
        f"frame {frame_ms:.3f} ms by CUDA events")
    return {"model": model, "v_feature": vf}


def profile_slice(state: dict) -> None:
    """torch.profiler over one GCN forward and over 5 frames: device time
    by kernel, and the share of the traced window the device was busy
    (sum of kernel times over first kernel start to last kernel end)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rnr_tpu_torch.train.steps import make_rnr_eval_step
    model, vf = state["model"], state["v_feature"]
    b = _gbuffer(512)
    step = make_rnr_eval_step(model)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):   # the first trace pays CUPTI set-up
        torch.zeros(1, device=DEV).add_(1)
        torch.cuda.synchronize()
    for name, fn, n in (
            ("gcn", lambda: model.compute_v_feature(b["gcn_pos"]), 1),
            ("frame", lambda: step(b, v_feature=vf), 5)):
        with torch.inference_mode():
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
        ka = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
        for e in sorted(ka, key=lambda e: -e.self_device_time_total)[:12]:
            log(f"[profile]   {e.self_device_time_total / 1e3 / n:8.3f} "
                f"ms/run  x{e.count // n:<4d} {e.key[:100]}")


def phase_parity(state: dict) -> None:
    """The slice's model at 128^2: card (kernels) vs CPU (twins), both
    from the card's v_feature."""
    model, vf = state["model"], state["v_feature"]
    from rnr_tpu_torch.models.rnr import RNRModel
    from rnr_tpu_torch.synthetic import build_batch, to_torch
    from rnr_tpu_torch.train.steps import make_rnr_eval_step
    nb = build_batch(128, 7500)
    bc, bh = to_torch(nb, DEV), to_torch(nb, "cpu")
    cpu = RNRModel(model.cfg, 7500)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    torch.set_num_threads(os.cpu_count() or 1)
    a = make_rnr_eval_step(model)(bc, v_feature=vf)["img"].float().cpu()
    t0 = time.perf_counter()
    r = make_rnr_eval_step(cpu)(bh, v_feature=vf.cpu())["img"].float()
    log(f"[parity] CPU twin frame at 128^2: {time.perf_counter() - t0:.1f} s")
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="device,build,kernels,slice,parity")
    phases = ap.parse_args().phases.split(",")
    smi = phase_device()
    rec: dict = {}
    launches: dict = {}
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        phase_kernels(rec)
        torch.cuda.synchronize()
    if "slice" in phases or "parity" in phases:   # parity reuses the model
        state = phase_slice(launches)
        profile_slice(state)
        torch.cuda.synchronize()
    if "parity" in phases:
        phase_parity(state)
        torch.cuda.synchronize()
    kernels = [dict(name=n, route="cuda", source=s["source"],
                    replaces=s["replaces"], launches=launches.get(n),
                    **rec.get(n, {})) for n, s in KERNELS.items()]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
