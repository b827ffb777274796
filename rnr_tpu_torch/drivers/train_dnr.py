"""Deferred Neural Rendering training driver (port of
rnr_tpu/drivers/train_dnr.py).

A neural texture and a U-Net trained with the alpha-masked,
border-cropped L1 on precomputed uv / SH / alpha maps, with rnr_tpu's
log, validation and checkpoint cadence, its output directories,
`params.json`, `model_final.ckpt` and `summary.json`.  One training step
and one Adam over both (`train/steps.py`), on the card unless
`--platform cpu`.  `--synthetic` trains on random G-buffers, with no
data; `--tex_fp` starts the texture's level 0 from an image
(`drivers/common.read_texture_init`: cv2's colour read of PNG, JPEG, BMP
or HDR, resized with INTER_AREA's rule).

Randomness: the initial weights come from `init_dnr_params(--seed)` (a
CPU generator, so the card and the CPU start alike), dropout from one
`make_generator(--seed)` on the run's device, the view order from
NumPy's default_rng(--seed), as rnr_tpu's.

Usage:
  python -m rnr_tpu_torch.drivers.train_dnr --data_root DATA \\
      [--img_dir _/rgb0] [--max_iter N] [--texture_num_ch 30] ...
  python -m rnr_tpu_torch.drivers.train_dnr --synthetic --max_iter 20 \\
      [--platform cpu]
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import time

import numpy as np
import torch

from rnr_tpu_torch.config import (DNRConfig, LossConfig, RenderNetConfig,
                                  TextureConfig, TrainConfig, save_config)
from rnr_tpu_torch.data import ViewDataset
from rnr_tpu_torch.drivers.common import (cond_mkdir, loop_time,
                                          read_texture_init, resolve,
                                          save_png, setup_device, str2bool,
                                          sync)
from rnr_tpu_torch.ops.metrics import masked_err_metrics
from rnr_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from rnr_tpu_torch.train.steps import (create_dnr_state, make_dnr_eval_step,
                                       make_dnr_train_step, make_generator)

VIEW_KEYS = ("uv_map", "sh_basis_map", "img_gt")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--logging_root", type=str, default=None)
    p.add_argument("--obj_fp", type=str, default="_/mesh.obj")
    p.add_argument("--calib_fp", type=str, default="_/calib.mat")
    p.add_argument("--img_dir", type=str, default="_/rgb0")
    p.add_argument("--img_size", type=int, default=512)
    p.add_argument("--img_gamma", type=float, default=1.0)
    p.add_argument("--texture_size", type=int, default=512)
    p.add_argument("--texture_num_ch", type=int, default=30)
    p.add_argument("--mipmap_level", type=int, default=4)
    p.add_argument("--tex_fp", type=str, default=None)
    p.add_argument("--start_epoch", type=int, default=0)
    p.add_argument("--apply_sh", default=True, type=str2bool)
    p.add_argument("--nf0", type=int, default=64)
    p.add_argument("--unet_conv_backend", default="auto",
                   choices=["auto", "xla", "pallas", "pallas3",
                            "pallas_interpret"])
    p.add_argument("--unet_pad_mode", default="reflect",
                   choices=["reflect", "same"])
    p.add_argument("--max_epoch", type=int, default=2000)
    p.add_argument("--max_iter", type=int, default=None)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--sampling_pattern", type=str, default="all")
    p.add_argument("--sampling_pattern_val", type=str, default="skip_10")
    p.add_argument("--val_freq", type=int, default=1000)
    p.add_argument("--log_freq", type=int, default=100)
    p.add_argument("--ckp_freq", type=int, default=5000)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--exp_name", type=str, default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--platform", type=str, default="cuda",
                   help="cuda (the default) or cpu")
    # reference-script compatibility: accepted and ignored
    p.add_argument("--gpu_id", type=str, default=None)
    p.add_argument("--calib_format", type=str, default="convert",
                   choices=["convert"])
    p.add_argument("--synthetic", action="store_true",
                   help="train on random G-buffers (smoke test)")
    return p


def _synthetic_views(rng, n, s):
    views = []
    for _ in range(n):
        views.append({
            "uv_map": rng.uniform(0, 1, (s, s, 2)).astype(np.float32),
            "sh_basis_map": rng.uniform(-1, 1, (s, s, 9)).astype(np.float32),
            "alpha_map": np.ones((s, s), np.float32),
            "img_gt": rng.uniform(0, 1, (s, s, 3)).astype(np.float32),
        })
    return views


def make_batch(views: list[dict], device) -> dict:
    """The DNR step's batch from host views, on `device`: uv_map,
    sh_basis_map, img_gt [N, H, W, C] and alpha_map [N, H, W, 1]."""
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    batch = {k: dev(np.stack([np.asarray(v[k]) for v in views]))
             for k in VIEW_KEYS}
    batch["alpha_map"] = dev(np.stack([np.asarray(v["alpha_map"])
                                       for v in views]))[..., None]
    return batch


def main(argv=None):
    """Train; returns (log_dir, modules) of the run."""
    opt = build_argparser().parse_args(argv)
    dev = setup_device(opt.platform)

    cfg = DNRConfig(
        texture=TextureConfig(
            texture_size=opt.texture_size, texture_num_ch=opt.texture_num_ch,
            mipmap_level=opt.mipmap_level, apply_sh=opt.apply_sh),
        render_net=RenderNetConfig(nf0=opt.nf0,
                                   conv_backend=opt.unet_conv_backend,
                                   pad_mode=opt.unet_pad_mode),
        loss=LossConfig(),
        train=TrainConfig(
            lr=opt.lr, batch_size=opt.batch_size, max_epoch=opt.max_epoch,
            max_iter=opt.max_iter, sampling_pattern=opt.sampling_pattern,
            sampling_pattern_val=opt.sampling_pattern_val,
            val_freq=opt.val_freq, log_freq=opt.log_freq,
            ckp_freq=opt.ckp_freq, img_size=opt.img_size,
            img_gamma=opt.img_gamma))

    # ---------------- data ----------------
    if opt.synthetic:
        rng_np = np.random.default_rng(opt.seed)
        train_views = _synthetic_views(rng_np, 8, opt.img_size)
        val_views = _synthetic_views(rng_np, 2, opt.img_size)
        log_root = opt.logging_root or "rnr_logs/dnr_synth"
    else:
        opt.calib_fp = resolve(opt.calib_fp, opt.data_root)
        opt.img_dir = resolve(opt.img_dir, opt.data_root)
        obj_name = os.path.basename(
            resolve(opt.obj_fp, opt.data_root)).split(".")[0]
        precomp = os.path.join(opt.data_root, f"precomp_{obj_name}")

        def views_of(pattern):
            ds = ViewDataset(
                root_dir=opt.data_root, calib_path=opt.calib_fp,
                img_dir=opt.img_dir, img_size=(opt.img_size, opt.img_size),
                sampling_pattern=pattern, load_precompute=True,
                precomp_high_dir=precomp, precomp_low_dir=precomp,
                img_gamma=opt.img_gamma)
            ds.buffer_all()
            return ds.views_all

        print("buffering train views...")
        train_views = views_of(opt.sampling_pattern)
        print("buffering val views...")
        val_views = views_of(opt.sampling_pattern_val)
        log_root = opt.logging_root or os.path.join(opt.data_root, "logs",
                                                    "dnr")

    dir_name = (datetime.datetime.now().strftime("%m-%d_%H-%M-%S")
                + "_" + opt.sampling_pattern
                + (("_" + opt.exp_name) if opt.exp_name else ""))
    log_dir = os.path.join(log_root, dir_name)
    cond_mkdir(log_dir)
    for sub in ("val_out", "val_gt", "val_err"):
        cond_mkdir(os.path.join(log_dir, sub))
    save_config(cfg, os.path.join(log_dir, "params.json"))

    # ---------------- state ----------------
    texture_init = None
    if opt.tex_fp:
        tex_fp = (resolve(opt.tex_fp, opt.data_root) if opt.data_root
                  else opt.tex_fp)
        texture_init = read_texture_init(tex_fp, opt.texture_size)
    mods, optimizer = create_dnr_state(cfg, opt.seed, cfg.train.lr,
                                       texture_init=texture_init, device=dev)
    if opt.checkpoint:
        load_checkpoint(opt.checkpoint, mods, optimizer)
        print("restored checkpoint", opt.checkpoint)
    train_step = make_dnr_train_step(cfg, mods, optimizer)
    eval_step = make_dnr_eval_step(cfg, mods)
    generator = make_generator(opt.seed, dev)
    print(f"DNR parameters: {sum(p.numel() for p in mods.parameters()):,}")

    try:
        from tensorboardX import SummaryWriter
        writer = SummaryWriter(log_dir)
    except Exception:
        writer = None

    bs = opt.batch_size
    # the training views stacked on the device once (16 MB a view at 512^2),
    # each batch gathered there
    views_dev = make_batch(train_views, dev)

    order_rng = np.random.default_rng(opt.seed)
    # resuming at --start_epoch also advances the iteration counter, so
    # checkpoints and logs continue instead of overwriting the first run's
    it = opt.start_epoch * len(train_views)
    history = []
    last_val = None
    timing = {"loop_s": 0.0, "iters_timed": 0, "validate_s": 0.0,
              "checkpoint_s": 0.0}
    t_loop = None
    for epoch in range(opt.start_epoch, opt.max_epoch):
        order = order_rng.permutation(len(train_views))
        # the epoch's order reaches the card in one copy from pinned
        # memory, so the host can queue steps while the card runs
        order_t = torch.from_numpy(order)
        if dev.type == "cuda":
            order_t = order_t.pin_memory()
        order_dev = order_t.to(dev, non_blocking=True)
        batches = ({k: a[order_dev[s:s + bs]] for k, a in views_dev.items()}
                   for s in range(0, len(order) - bs + 1, bs))
        for batch in batches:
            if opt.max_iter is not None and it >= opt.max_iter:
                _final(log_dir, mods, optimizer, history, it, last_val,
                       writer, loop_time(timing, t_loop, dev))
                return log_dir, mods
            t0 = time.time()
            metrics = train_step(batch, generator)
            if t_loop is None:
                sync(dev)
                t_loop = time.perf_counter()
            else:
                timing["iters_timed"] += 1
            # metrics reach the host only at log boundaries, so the steps
            # queue back to back on the card
            if it % max(opt.log_freq // 10, 1) == 0 or (
                    opt.max_iter is not None and it == opt.max_iter - 1):
                loss = float(metrics["loss"])
                history.append(loss)
                if writer:
                    writer.add_scalar("loss_g", loss, it)
                    writer.add_scalar("final_mae_valid",
                                      float(metrics["mae_valid"]), it)
                    writer.add_scalar("final_psnr_valid",
                                      float(metrics["psnr_valid"]), it)
                print(f"Iter {it:07d} Epoch {epoch:03d} loss {loss:.4f} "
                      f"mae_valid {float(metrics['mae_valid']):.4f} "
                      f"psnr_valid {float(metrics['psnr_valid']):.4f} "
                      f"t {time.time() - t0:.3f}s")

            if it and it % opt.val_freq == 0:
                sync(dev)
                t0 = time.perf_counter()
                last_val = _validate(eval_step, val_views, bs, log_dir, it,
                                     writer, dev)
                timing["validate_s"] += time.perf_counter() - t0
            it += 1
            if it % opt.ckp_freq == 0:
                sync(dev)
                t0 = time.perf_counter()
                save_checkpoint(os.path.join(log_dir,
                                             f"model_iter-{it}.ckpt"),
                                mods, optimizer, it)
                timing["checkpoint_s"] += time.perf_counter() - t0
    _final(log_dir, mods, optimizer, history, it, last_val, writer,
           loop_time(timing, t_loop, dev))
    return log_dir, mods



def _validate(eval_step, val_views, bs, log_dir, it, writer, dev) -> dict:
    """rnr_tpu's validation: masked MAE and PSNR per batch and the
    val_out PNGs."""
    maes, psnrs = [], []
    for start in range(0, len(val_views) - bs + 1, bs):
        batch = make_batch(val_views[start:start + bs], dev)
        out = eval_step(batch)
        alpha = batch["alpha_map"]
        m = masked_err_metrics(out * alpha * 255.0,
                               batch["img_gt"] * alpha * 255.0, alpha)
        maes.append(float(m["mae_valid"]))
        psnrs.append(float(m["psnr_valid"]))
        for i in range(bs):
            save_png(os.path.join(log_dir, "val_out",
                                  f"{it:08d}_{start + i:05d}.png"), out[i])
    if writer and maes:
        writer.add_scalar("final_mae_valid_val", np.mean(maes), it)
        writer.add_scalar("final_psnr_valid_val", np.mean(psnrs), it)
    print(f"Val @ {it}: mae {np.mean(maes):.4f} psnr {np.mean(psnrs):.4f}")
    return {"mae_valid": float(np.mean(maes)),
            "psnr_valid": float(np.mean(psnrs))}


def _final(log_dir, mods, optimizer, history, total_iters, val_metrics,
           writer, timing):
    save_checkpoint(os.path.join(log_dir, "model_final.ckpt"), mods,
                    optimizer, total_iters)
    summary = {"first_loss": history[0] if history else None,
               "last_loss": history[-1] if history else None,
               "iters": total_iters, "timing": timing}
    if val_metrics:
        summary["val"] = val_metrics
    with open(os.path.join(log_dir, "summary.json"), "w") as f:
        json.dump(summary, f)
    if writer:
        writer.close()
    print("final:", json.dumps(summary))


if __name__ == "__main__":
    main()
