"""Relightable neural renderer training driver (port of
rnr_tpu/drivers/train_rnr.py).

Full RNR training from a precomputed dataset: SH lighting started from
the light probes and the stitched probe, the GCN light-transport prior,
13 + 13 ray fans and the four-loss objective, with rnr_tpu's log,
validation and checkpoint cadence, its PNG directories and metrics, and
`model_final.ckpt` and `summary.json` at the end.  One training step and
one Adam over everything (`train/steps.py`), on the card unless
`--platform cpu`.  `--synthetic` trains on random G-buffers, with no data.

Randomness: the initial weights come from `init_rnr_params(--seed)` (a
CPU generator, so the card and the CPU start alike), dropout and the
stochastic GCN from one `make_generator(--seed)` on the run's device, the
view order from NumPy's default_rng(--seed), as rnr_tpu's.

Data and row parallelism (parallel/): `--mesh_devices N --mesh_dp D`
spawns N ranks on this host, one a device (cuda:{rank}, NCCL; Gloo with
`--platform cpu`), with a rendezvous on a free local port, laid out as
a (D, N / D) mesh: the batch (`--batch_size`, global) is split over D,
each frame's rows over N / D (rnr_tpu's sp; D defaults to 1, as
rnr_tpu's).  The rows must split: --img_size % (sp · 2**num_down) == 0,
at least 2 innermost rows a rank, checked before any rank starts.
`--coordinator_address HOST:PORT --num_processes P --process_id I` joins
P hosts, each starting `--local_device_count` ranks (one when not
given).  Every rank computes the same parameters; only rank 0 writes
logs, params.json, validation images and checkpoints, and the view
buffer stays on the host.  The GCN runs whole on every rank, its picks
from make_generator(--seed); dropout draws from a generator per rank.

Usage:
  python -m rnr_tpu_torch.drivers.train_rnr --data_root DATA \\
      --lighting_idx 0 --lighting_relight_idx 1 [--sampling_pattern ...]
  python -m rnr_tpu_torch.drivers.train_rnr --synthetic --max_iter 10 \\
      [--platform cpu] [--mesh_devices 2 --mesh_dp 2 --batch_size 2]
      [--mesh_devices 2 --img_size 128]     # rows over 2 ranks
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import time

import numpy as np
import torch

from rnr_tpu_torch.config import (GCNTrainConfig, LightingConfig, LossConfig,
                                  RaysConfig, RenderNetConfig, RNRConfig,
                                  TextureConfig, TrainConfig, save_config)
from rnr_tpu_torch.data import LightProbeDataset, ViewDataset, load_obj
from rnr_tpu_torch.data.imageio import read_image, resize
from rnr_tpu_torch.data.prefetch import prefetch
from rnr_tpu_torch.drivers.common import (cond_mkdir, load_sphere_samples,
                                          loop_time, read_texture_init,
                                          resolve, save_png, setup_device,
                                          str2bool, sync)
from rnr_tpu_torch.models.lighting import LightingLP
from rnr_tpu_torch.models.rnr import RNRModel
from rnr_tpu_torch.ops.interpolate import interpolate_bilinear
from rnr_tpu_torch.ops.sh import evaluate_sh_basis, fit_sh_coeff
from rnr_tpu_torch.ops.spherical import spherical_mapping
from rnr_tpu_torch.parallel.distributed import (fetch_global, free_port,
                                                init_distributed,
                                                is_main_process, rank_device,
                                                run_ranks)
from rnr_tpu_torch.parallel.sharding import check_rows, make_mesh, mesh_shape
from rnr_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from rnr_tpu_torch.train.steps import (create_rnr_optimizer, init_rnr_params,
                                       make_generator, make_rnr_eval_step,
                                       make_rnr_train_step,
                                       rnr_texture_flatten_init)
from rnr_tpu_torch.utils.eval_metrics import compute_err_metrics_batch, psnr_np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    # general / paths
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--logging_root", type=str, default=None)
    p.add_argument("--calib_fp", type=str, default="_/calib.mat")
    p.add_argument("--obj_high_fp", type=str, default="_/mesh.obj")
    p.add_argument("--obj_low_fp", type=str, default="_/mesh_7500v.obj")
    p.add_argument("--obj_gcn_fp", type=str, default="_/mesh_7500v.obj")
    p.add_argument("--tex_fp", type=str, default="_/tex.png")
    # view data
    p.add_argument("--img_size", type=int, default=512)
    p.add_argument("--img_gamma", type=float, default=1.0)
    # texture
    p.add_argument("--texture_size", type=int, default=512)
    p.add_argument("--texture_num_ch", type=int, default=24)
    p.add_argument("--mipmap_level", type=int, default=4)
    p.add_argument("--init_tex", default=False, type=str2bool)
    p.add_argument("--fix_tex", default=False, type=str2bool)
    p.add_argument("--apply_sh", default=True, type=str2bool)
    # lighting
    p.add_argument("--lp_dir", type=str, default=None)
    p.add_argument("--sphere_samples_fp", type=str,
                   default="./sphere_samples_4096.mat")
    p.add_argument("--sh_lmax", type=int, default=10)
    p.add_argument("--fix_lighting", default=False, type=str2bool)
    p.add_argument("--init_lighting", default=True, type=str2bool)
    p.add_argument("--lighting_idx", default=None, type=int)
    p.add_argument("--lighting_relight_idx", default=None, type=int)
    # render net
    p.add_argument("--nf0", type=int, default=64)
    p.add_argument("--gcn_compute_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--rays_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--sh_fan_fuse", default=True, type=str2bool)

    def _remat_arg(x):
        v = str(x).lower()
        if v in ("wide", "all", "none"):
            return False if v == "none" else v
        if v in ("true", "1", "false", "0"):
            return v in ("true", "1")
        raise argparse.ArgumentTypeError(
            f"--unet_remat must be false|true|all|wide|none, got {x!r}")

    p.add_argument("--unet_remat", default=False, type=_remat_arg)
    p.add_argument("--unet_fuse_mode", default="dense",
                   choices=["concat", "dense"])
    p.add_argument("--unet_compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--unet_conv_backend", default="auto",
                   choices=["auto", "xla", "pallas", "pallas3", "slab3",
                            "slab", "p3s4", "pallas_interpret"])
    p.add_argument("--unet_pad_mode", default="reflect",
                   choices=["reflect", "same"])
    # gcn
    p.add_argument("--in_channels", default=6, type=int)
    p.add_argument("--kernel_size", default=16, type=int)
    p.add_argument("--n_filters", default=64, type=int)
    p.add_argument("--n_blocks", default=20, type=int)
    p.add_argument("--epsilon", default=0.2, type=float)
    p.add_argument("--stochastic", default=True, type=str2bool)
    p.add_argument("--out_channels_gcn", default=512, type=int)
    p.add_argument("--block_type", default="res", type=str,
                   choices=["res", "dense"])
    p.add_argument("--conv_type", default="edge", type=str,
                   choices=["edge", "mr"])
    p.add_argument("--act_type", default="relu", type=str,
                   choices=["relu", "leakyrelu", "prelu"])
    p.add_argument("--norm_type", default="none", type=str,
                   choices=["none", "batch", "instance"])
    p.add_argument("--bias", default=True, type=str2bool)
    p.add_argument("--use_gcn", default=True, type=str2bool)
    p.add_argument("--knn_approx", default=True, type=str2bool)
    p.add_argument("--knn_recall", default=0.9, type=float)
    p.add_argument("--graph_refresh_every", default=1, type=int)
    p.add_argument("--strat_min_dilation", default=3, type=int)
    p.add_argument("--stratum_width", default=16, type=int)
    # losses
    p.add_argument("--loss_lighting_weight", type=float, default=1.0)
    p.add_argument("--loss_lighting_uncovered_weight", type=float,
                   default=0.1)
    p.add_argument("--loss_rays_lt_chrom_weight", type=float, default=1.0)
    p.add_argument("--loss_alb_weight", type=float, default=1.0)
    # training
    p.add_argument("--max_epoch", type=int, default=2000)
    p.add_argument("--max_iter", type=int, default=None)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--sampling_pattern", type=str, default="all")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--sampling_pattern_val", type=str, default="all")
    p.add_argument("--val_freq", type=int, default=1000)
    p.add_argument("--exp_name", type=str, default="")
    p.add_argument("--start_epoch", type=int, default=0)
    p.add_argument("--log_freq", type=int, default=100)
    p.add_argument("--ckp_freq", type=int, default=5000)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--platform", type=str, default="cuda",
                   help="cuda (the default) or cpu")
    # reference-script compatibility: accepted and ignored
    p.add_argument("--gpu_id", type=str, default=None)
    p.add_argument("--calib_format", type=str, default="convert",
                   choices=["convert"])
    p.add_argument("--synthetic", action="store_true")
    # stack the training views on the device once ("auto": when they fit
    # in 4 GB) and gather batches there, else assemble them on the host
    p.add_argument("--device_view_buffer", type=str, default="auto",
                   choices=["auto", "on", "off"])
    # data parallelism over ranks (parallel/)
    p.add_argument("--mesh_devices", type=int, default=None)
    p.add_argument("--mesh_dp", type=int, default=1)
    p.add_argument("--coordinator_address", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--local_device_count", type=int, default=None)
    return p


VIEW_KEYS = ("uv_map", "sh_basis_map", "normal_map", "view_dir_map",
             "view_dir_map_tangent", "TBN_map")


def make_rnr_batch(views: list[dict], gcn_pos: np.ndarray, device) -> dict:
    """The training step's batch from host views, on `device`."""
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    batch = {k: dev(np.stack([np.asarray(v[k]) for v in views]))
             for k in VIEW_KEYS}
    batch["alpha_map"] = dev(np.stack([np.asarray(v["alpha_map"])
                                       for v in views]))[..., None]
    batch["img_gt"] = dev(np.stack([np.asarray(v["img_gt"]) for v in views]))
    batch["gcn_pos"] = dev(np.asarray(gcn_pos, np.float32))
    return batch


def _synthetic_views(rng, n, s):
    views = []
    for _ in range(n):
        normal = rng.standard_normal((s, s, 3)).astype(np.float32)
        normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
        views.append({
            "uv_map": rng.uniform(0, 1, (s, s, 2)).astype(np.float32),
            "sh_basis_map": rng.uniform(-1, 1, (s, s, 9)).astype(np.float32),
            "normal_map": normal,
            "view_dir_map": normal.copy(),
            "view_dir_map_tangent": np.broadcast_to(
                np.asarray([0, 0, 1], np.float32), (s, s, 3)).copy(),
            "TBN_map": np.broadcast_to(np.eye(3, dtype=np.float32),
                                       (s, s, 3, 3)).copy(),
            "alpha_map": np.ones((s, s), np.float32),
            "img_gt": rng.uniform(0, 1, (s, s, 3)).astype(np.float32),
        })
    return views


def _read_stitch(lp_stitch_dir: str, lighting_idx: int, img_gamma: float):
    """The stitched probe (RGB float: .exr, else .hdr, else the 8-bit
    .png) and its coverage mask, as rnr_tpu's train_rnr reads them."""
    exr = os.path.join(lp_stitch_dir, f"{lighting_idx}.exr")
    hdr = os.path.join(lp_stitch_dir, f"{lighting_idx}.hdr")
    png = os.path.join(lp_stitch_dir, f"{lighting_idx}.png")
    if os.path.isfile(exr) or os.path.isfile(hdr):
        lp_stitch = read_image(exr if os.path.isfile(exr) else hdr)[:, :, :3]
    else:
        lp_stitch = read_image(png)[:, :, :3].astype(np.float32) / 255.0
    lp_stitch = np.nan_to_num(lp_stitch) ** img_gamma
    lp_mask = read_image(os.path.join(lp_stitch_dir, "mask",
                                      f"{lighting_idx}.png"))
    lp_mask = lp_mask[:, :, :3].astype(np.float32) / 255.0
    for c in range(3):
        covered = lp_mask[:, :, c] == 1
        if covered.any():
            lp_stitch[~covered, c] = lp_stitch[covered, c].mean()
    return lp_stitch.astype(np.float32), lp_mask


def _sample_probe(img: np.ndarray, l_dir: np.ndarray) -> np.ndarray:
    """The probe's bilinear values at the sphere sample directions."""
    uv = spherical_mapping(torch.from_numpy(l_dir)).numpy()
    x = np.clip(uv[0] * img.shape[1], None, img.shape[1] - 1)
    y = np.clip(uv[1] * img.shape[0], None, img.shape[0] - 1)
    return interpolate_bilinear(torch.from_numpy(img), torch.from_numpy(x),
                                torch.from_numpy(y)).numpy()


def main(argv=None):
    """Train; returns (log_dir, model) of the run: rank 0's log_dir and
    None for the model where the ranks ran in spawned processes."""
    opt = build_argparser().parse_args(argv)
    ranks = _ranks(opt)
    if ranks is None:
        return _train(opt, setup_device(opt.platform), None)
    if ranks[3] == 1:
        return _rank(0, opt, ranks)
    return run_ranks(_spawned_rank, ranks[3], opt, ranks)[0], None


def _ranks(opt) -> tuple | None:
    """(coordinator, processes, process id, ranks a process) of a run over
    ranks, None for one device; checks the mesh before any rank starts."""
    if opt.coordinator_address is None:
        if (opt.mesh_devices or 1) == 1:
            return None
        ranks = (f"127.0.0.1:{free_port()}", 1, 0, opt.mesh_devices)
    else:
        if opt.num_processes is None or opt.process_id is None:
            raise ValueError("--coordinator_address requires "
                             "--num_processes and --process_id")
        ranks = (opt.coordinator_address, opt.num_processes, opt.process_id,
                 opt.local_device_count or 1)
    world = ranks[1] * ranks[3]
    if (opt.mesh_devices or world) != world:
        raise ValueError(f"--mesh_devices {opt.mesh_devices}: the run has "
                         f"{world} ranks")
    dp, sp = mesh_shape(world, opt.mesh_dp)
    check_rows(opt.img_size, sp, RenderNetConfig.num_down_unet)
    if opt.batch_size % dp:
        raise ValueError(f"--batch_size {opt.batch_size} does not split "
                         f"over {dp} ranks")
    if opt.platform != "cpu":
        setup_device(opt.platform)      # raises without a card
    return ranks


def _rank(local_rank: int, opt, ranks: tuple):
    """One rank of a run: join the group, train, leave the group."""
    coord, nproc, pid, per = ranks
    if opt.platform == "cpu" and per > 1:   # the host's cores shared
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // per))
    init_distributed(coord, nproc, pid, per, local_rank=local_rank,
                     platform=opt.platform)
    try:
        mesh = make_mesh(nproc * per, dp=opt.mesh_dp)
        return _train(opt, rank_device(local_rank, opt.platform), mesh)
    finally:
        torch.distributed.destroy_process_group()


def _spawned_rank(local_rank: int, opt, ranks: tuple) -> str:
    return _rank(local_rank, opt, ranks)[0]


def _train(opt, dev: torch.device, mesh):
    """The training run on `dev`; over the ranks of `mesh` where one is
    given (parallel.sharding.make_mesh)."""
    main_proc = is_main_process()
    synthetic = opt.synthetic
    lighting_idx = opt.lighting_idx if opt.lighting_idx is not None else 0
    has_relight = opt.lighting_relight_idx is not None

    sphere_fp = resolve(opt.sphere_samples_fp, opt.data_root or ".")
    l_dir = load_sphere_samples(sphere_fp)  # [3, S]
    num_sample = l_dir.shape[1]

    # ------------- data -------------
    if synthetic:
        s = opt.img_size
        rng_np = np.random.default_rng(opt.seed)
        train_views = _synthetic_views(rng_np, 6, s)
        val_views = _synthetic_views(rng_np, 2, s)
        gcn_pos = rng_np.standard_normal((512, 3)).astype(np.float32)
        num_lighting = 2
        l_samples_init = rng_np.uniform(0, 1, (num_sample, 3)).astype(
            np.float32)
        l_samples_mask = (rng_np.uniform(size=num_sample) > 0.3).astype(
            np.float32)
        init_coeff = lp_fit_coeff = texture_init = relight_views = None
        log_root = opt.logging_root or "rnr_logs/rnr_synth"
    else:
        opt.calib_fp = resolve(opt.calib_fp, opt.data_root)
        opt.obj_high_fp = resolve(opt.obj_high_fp, opt.data_root)
        opt.obj_low_fp = resolve(opt.obj_low_fp, opt.data_root)
        opt.obj_gcn_fp = resolve(opt.obj_gcn_fp, opt.data_root)
        opt.tex_fp = resolve(opt.tex_fp, opt.data_root)
        opt.lp_dir = resolve(opt.lp_dir, opt.data_root)
        high_name = os.path.basename(opt.obj_high_fp).split(".")[0]
        low_name = os.path.basename(opt.obj_low_fp).split(".")[0]
        precomp_high = os.path.join(opt.data_root, f"precomp_{high_name}")
        precomp_low = os.path.join(opt.data_root, f"precomp_{low_name}")

        img_dir = os.path.join(opt.data_root, f"rgb{lighting_idx}")

        def views_of(pattern, img_dir, precompute=True):
            ds = ViewDataset(
                root_dir=opt.data_root, calib_path=opt.calib_fp,
                img_dir=img_dir, img_size=(opt.img_size, opt.img_size),
                sampling_pattern=pattern, load_precompute=precompute,
                precomp_high_dir=precomp_high, precomp_low_dir=precomp_low,
                img_gamma=opt.img_gamma)
            ds.buffer_all()
            return ds.views_all

        print("buffering train views...")
        train_views = views_of(opt.sampling_pattern, img_dir)
        print("buffering val views...")
        val_views = views_of(opt.sampling_pattern_val, img_dir)

        relight_views = None
        img_relight_dir = os.path.join(opt.data_root,
                                       f"rgb{opt.lighting_relight_idx}")
        if has_relight and os.path.isdir(img_relight_dir):
            relight_views = views_of(opt.sampling_pattern_val,
                                     img_relight_dir, precompute=False)

        gcn_pos = load_obj(opt.obj_gcn_fp).v

        # light probes -> LightingLP -> SH initialisation
        init_coeff = lp_fit_coeff = None
        num_lighting = 1
        if opt.lp_dir is not None and os.path.isdir(opt.lp_dir):
            lp_ds = LightProbeDataset(opt.lp_dir, img_gamma=opt.img_gamma)
            lp_ds.buffer_all()
            lps = np.stack([resize(lp_ds[i]["lp_img"], (3200, 1600), "area")
                            for i in range(len(lp_ds))])
            with torch.no_grad():
                init_coeff = LightingLP(l_dir, lps=lps, device="cpu").fit_sh(
                    opt.sh_lmax).numpy()
            lp_fit_coeff = init_coeff.copy()
            num_lighting = lps.shape[0]

        # stitched probe -> lighting loss anchors
        lp_stitch_dir = os.path.join(
            opt.data_root, f"light_probe_stitch_{opt.sampling_pattern}")
        if not os.path.isdir(lp_stitch_dir):
            raise FileNotFoundError(
                f"stitched light probe dir {lp_stitch_dir} not found -- run "
                f"drivers.stitch_lp with --sampling_pattern "
                f"{opt.sampling_pattern} first (see scripts/preproc.sh)")
        lp_stitch, lp_mask = _read_stitch(lp_stitch_dir, lighting_idx,
                                          opt.img_gamma)
        l_samples_init = _sample_probe(lp_stitch, l_dir)
        l_samples_mask = (_sample_probe(lp_mask, l_dir)[:, 0] == 1).astype(
            np.float32)

        num_lighting = max(num_lighting, lighting_idx + 1,
                           (opt.lighting_relight_idx + 1) if has_relight
                           else 0)
        if opt.init_lighting:
            basis = evaluate_sh_basis(opt.sh_lmax, torch.from_numpy(l_dir.T))
            stitch_coeff = fit_sh_coeff(torch.from_numpy(l_samples_init),
                                        basis).numpy()
            if init_coeff is None:
                init_coeff = np.tile(stitch_coeff[None].astype(np.float32),
                                     (num_lighting, 1, 1))
            elif init_coeff.shape[0] < num_lighting:
                pad = np.tile(stitch_coeff[None].astype(np.float32),
                              (num_lighting - init_coeff.shape[0], 1, 1))
                init_coeff = np.concatenate([init_coeff, pad], axis=0)
            init_coeff[lighting_idx] = stitch_coeff
            num_lighting = init_coeff.shape[0]

        texture_init = None
        if opt.init_tex and os.path.isfile(opt.tex_fp):
            texture_init = read_texture_init(opt.tex_fp, opt.texture_size)
        log_root = opt.logging_root or os.path.join(opt.data_root, "logs",
                                                    "rnr")

    # ------------- model -------------
    cfg = RNRConfig(
        texture=TextureConfig(
            texture_size=opt.texture_size, texture_num_ch=opt.texture_num_ch,
            mipmap_level=opt.mipmap_level, init_tex=opt.init_tex,
            fix_tex=opt.fix_tex, apply_sh=opt.apply_sh),
        lighting=LightingConfig(
            sh_lmax=opt.sh_lmax, num_sample=num_sample,
            num_lighting=max(num_lighting, 2 if has_relight else 1),
            lighting_idx=opt.lighting_idx,
            lighting_relight_idx=opt.lighting_relight_idx,
            fix_lighting=opt.fix_lighting, init_lighting=opt.init_lighting),
        rays=RaysConfig(rays_dtype=opt.rays_dtype,
                        sh_fan_fuse=opt.sh_fan_fuse),
        gcn=GCNTrainConfig(
            kernel_size=opt.kernel_size, n_filters=opt.n_filters,
            n_blocks=opt.n_blocks, epsilon=opt.epsilon,
            in_channels=opt.in_channels, block_type=opt.block_type,
            conv_type=opt.conv_type, act_type=opt.act_type,
            norm_type=None if opt.norm_type == "none" else opt.norm_type,
            use_bias=opt.bias, stochastic=opt.stochastic,
            out_channels=opt.out_channels_gcn, knn_approx=opt.knn_approx,
            knn_recall=opt.knn_recall,
            graph_refresh_every=opt.graph_refresh_every,
            compute_dtype=opt.gcn_compute_dtype,
            strat_min_dilation=opt.strat_min_dilation,
            stratum_width=opt.stratum_width),
        render_net=RenderNetConfig(nf0=opt.nf0, remat=opt.unet_remat,
                                   compute_dtype=opt.unet_compute_dtype,
                                   conv_backend=opt.unet_conv_backend,
                                   fuse_mode=opt.unet_fuse_mode,
                                   pad_mode=opt.unet_pad_mode),
        loss=LossConfig(
            loss_lighting_weight=opt.loss_lighting_weight,
            loss_lighting_uncovered_weight=opt.loss_lighting_uncovered_weight,
            loss_rays_lt_chrom_weight=opt.loss_rays_lt_chrom_weight,
            loss_alb_weight=opt.loss_alb_weight),
        train=TrainConfig(
            lr=opt.lr, batch_size=opt.batch_size, max_epoch=opt.max_epoch,
            max_iter=opt.max_iter, sampling_pattern=opt.sampling_pattern,
            sampling_pattern_val=opt.sampling_pattern_val,
            val_freq=opt.val_freq, log_freq=opt.log_freq,
            ckp_freq=opt.ckp_freq, img_size=opt.img_size,
            img_gamma=opt.img_gamma),
        use_gcn=opt.use_gcn)
    model = init_rnr_params(RNRModel(
        cfg, len(gcn_pos), l_dir=l_dir, device=dev,
        init_lighting_coeff=init_coeff, texture_init=texture_init), opt.seed)

    dir_name = (datetime.datetime.now().strftime("%m-%d_%H-%M-%S")
                + "_" + opt.sampling_pattern
                + (("_" + opt.exp_name) if opt.exp_name else ""))
    log_dir = os.path.join(log_root, dir_name)
    if main_proc:
        cond_mkdir(log_dir)
        for sub in ("val_out", "val_gt", "val_err", "val_relight_out",
                    "val_relight_err", "val_relight_gt"):
            cond_mkdir(os.path.join(log_dir, sub))
        save_config(cfg, os.path.join(log_dir, "params.json"))

    bs = opt.batch_size
    optimizer = create_rnr_optimizer(model, cfg.train.lr)
    if opt.checkpoint:
        load_checkpoint(opt.checkpoint, model, optimizer)
        print("restored", opt.checkpoint)

    statics = {
        "l_samples_init": torch.from_numpy(l_samples_init).to(dev),
        "l_samples_mask": torch.from_numpy(l_samples_mask).to(dev),
        "tex_flatten_init": rnr_texture_flatten_init(model),
    }
    train_step = make_rnr_train_step(model, optimizer, lighting_idx, mesh,
                                     opt.seed)
    eval_step = make_rnr_eval_step(model, lighting_idx, mesh=mesh)
    sp = 1
    if mesh is not None:
        sp = mesh.sp
        print(f"rank {mesh.rank} of {mesh.world} on {dev}: mesh "
              f"{mesh.shape} {mesh.axis_names}", flush=True)
    generator = make_generator(opt.seed, dev)

    n_params = {part: sum(p.numel() for n, p in model.named_parameters()
                          if n.split(".", 1)[0] == part)
                for part in ("texture_mapper", "render_net", "gcn",
                             "lighting")}
    if main_proc:
        print("parameters:", json.dumps(n_params))

    lp_relight = None
    if has_relight:
        with torch.no_grad():
            lp_relight = model.lighting(opt.lighting_relight_idx, is_lp=True)

    @torch.no_grad()
    def recon_probe(coeff) -> np.ndarray:
        c = torch.as_tensor(np.asarray(coeff), device=dev)
        return model.lighting.reconstruct_lp(c).cpu().numpy()

    has_lighting_gt = lp_fit_coeff is not None and lighting_idx < len(
        lp_fit_coeff)
    lighting_coeff_gt = lp_gt = lp_init = None
    if has_lighting_gt:
        lighting_coeff_gt = lp_fit_coeff[lighting_idx]
        lp_gt = recon_probe(lighting_coeff_gt)
    if init_coeff is not None and lighting_idx < len(init_coeff):
        lp_init = recon_probe(init_coeff[lighting_idx])

    writer = None
    if main_proc:
        try:
            from tensorboardX import SummaryWriter
            writer = SummaryWriter(log_dir)
        except Exception:
            writer = None

    # the training views stacked on the device once, batches gathered
    # there; else assembled on a host thread while the card runs
    views_dev = None
    if opt.device_view_buffer != "off" and mesh is None:
        keys = VIEW_KEYS + ("alpha_map", "img_gt")
        view_bytes = sum(np.asarray(train_views[0][k]).nbytes
                         for k in keys) * len(train_views)
        if opt.device_view_buffer == "on" or view_bytes <= (4 << 30):
            views_dev = make_rnr_batch(train_views, gcn_pos, dev)
            print(f"device view buffer: {len(train_views)} views, "
                  f"{view_bytes / 1e9:.2f} GB", flush=True)

    order_rng = np.random.default_rng(opt.seed)
    it = opt.start_epoch * len(train_views)
    history = []
    ran_val = False
    last_val = None
    # the loop's wall time from the end of its first iteration (which
    # warms up) to the end of its last, validation and checkpoints taken
    # out: summary.json's "timing"
    timing = {"loop_s": 0.0, "iters_timed": 0, "validate_s": 0.0,
              "checkpoint_s": 0.0}
    t_loop = None
    for epoch in range(opt.start_epoch, opt.max_epoch):
        order = order_rng.permutation(len(train_views))
        if views_dev is not None:
            # the epoch's order reaches the card in one copy from pinned
            # memory: a pageable copy of each batch's indices would
            # synchronise the stream every iteration, and the host could
            # no longer queue a step while the card runs the last one
            order_t = torch.from_numpy(order)
            if dev.type == "cuda":
                order_t = order_t.pin_memory()
            order_dev = order_t.to(dev, non_blocking=True)

            def epoch_batches(order=order_dev):
                for start in range(0, len(order) - bs + 1, bs):
                    idx = order[start:start + bs]
                    b = {k: (a if k == "gcn_pos" else a[idx])
                         for k, a in views_dev.items()}
                    yield b

            batches = epoch_batches()
        else:
            def epoch_batches(order=order):
                for start in range(0, len(order) - bs + 1, bs):
                    yield make_rnr_batch(
                        [train_views[j] for j in order[start:start + bs]],
                        gcn_pos, dev)

            batches = prefetch(epoch_batches(), depth=2)

        for batch in batches:
            if opt.max_iter is not None and it >= opt.max_iter:
                _final(log_dir, model, optimizer, history, it, last_val,
                       writer, loop_time(timing, t_loop, dev), main_proc)
                return log_dir, model
            t0 = time.time()
            metrics = train_step(batch, statics, generator)
            if t_loop is None:
                sync(dev)
                t_loop = time.perf_counter()
            else:
                timing["iters_timed"] += 1
            # fetch metrics to the host only at log boundaries, so the
            # steps queue back to back on the card
            sync_now = (it % max(opt.log_freq // 10, 1) == 0
                        or (opt.max_iter is not None
                            and it == opt.max_iter - 1))
            if sync_now:
                loss = float(metrics["loss"])
                history.append(loss)
                if writer:
                    for k in ("loss", "loss_rn", "loss_lighting",
                              "loss_rays_lt_chrom", "loss_alb"):
                        writer.add_scalar(k, float(metrics[k]), it)
                    writer.add_scalar("final_mae_valid",
                                      float(metrics["mae_valid"]), it)
                    writer.add_scalar("final_psnr_valid",
                                      float(metrics["psnr_valid"]), it)
                    if has_lighting_gt:
                        est = model.lighting.coeff[lighting_idx].detach()
                        est = est.cpu().numpy()
                        writer.add_scalar(
                            "lighting_sh_coeff_mae",
                            float(np.abs(lighting_coeff_gt - est).sum()), it)
                        lp_est = recon_probe(est)
                        writer.add_scalar(
                            "lp_mae_valid",
                            float(np.abs(lp_est - lp_gt).mean() * 255.0), it)
                        writer.add_scalar(
                            "lp_psnr_valid",
                            psnr_np(lp_est * 255.0, lp_gt * 255.0), it)
                print(f"Iter {it:07d} Epoch {epoch:03d} loss {loss:.4f} "
                      f"rn {float(metrics['loss_rn']):.4f} "
                      f"light {float(metrics['loss_lighting']):.4f} "
                      f"chrom {float(metrics['loss_rays_lt_chrom']):.4f} "
                      f"alb {float(metrics['loss_alb']):.4f} "
                      f"psnr {float(metrics['psnr_valid']):.4f} "
                      f"t {time.time() - t0:.3f}s")

            # fetch_global is a collective: every rank enters with rank 0
            if (writer or mesh) and it % opt.log_freq == 0:
                img = np.clip(fetch_global(metrics["img"], sp), 0, 1)
            if writer and it % opt.log_freq == 0:
                gt = np.clip(batch["img_gt"].cpu().numpy(), 0, 1)
                err = np.clip(np.abs(img - gt), 0, 1)
                grid = np.concatenate(
                    [np.concatenate([img[i], gt[i], err[i]], axis=1)
                     for i in range(img.shape[0])], axis=0)
                writer.add_image("output_final_vs_gt", grid, it,
                                 dataformats="HWC")
                rows = []
                if lp_init is not None:
                    rows.append(np.clip(lp_init, 0, 1))
                est = model.lighting.coeff[lighting_idx].detach()
                lp_est_img = recon_probe(est.cpu().numpy())
                rows.append(np.clip(lp_est_img, 0, 1))
                if lp_gt is not None:
                    rows.append(np.clip(lp_gt, 0, 1))
                    rows.append(np.clip(np.abs(lp_est_img - lp_gt), 0, 1))
                writer.add_image("lp_init_est_gt",
                                 np.concatenate(rows, axis=0), it,
                                 dataformats="HWC")

            if it and it % opt.val_freq == 0:
                # the queued steps finish inside the loop's time, not
                # inside the validation's
                sync(dev)
                t0 = time.perf_counter()
                last_val = _validate(eval_step, val_views, relight_views,
                                     gcn_pos, bs, log_dir, it, writer,
                                     lp_relight, dev, first_val=not ran_val,
                                     write=main_proc, sp=sp)
                ran_val = True
                timing["validate_s"] += time.perf_counter() - t0
            it += 1
            if it % opt.ckp_freq == 0 and main_proc:
                sync(dev)
                t0 = time.perf_counter()
                save_checkpoint(os.path.join(log_dir,
                                             f"model_iter-{it}.ckpt"),
                                model, optimizer, it)
                timing["checkpoint_s"] += time.perf_counter() - t0
    _final(log_dir, model, optimizer, history, it, last_val, writer,
           loop_time(timing, t_loop, dev), main_proc)
    return log_dir, model



def _validate(eval_step, val_views, relight_views, gcn_pos, bs, log_dir, it,
              writer, lp_relight, dev, first_val=False, write=True, sp=1):
    """Validation with the reference's outputs: masked MAE / MSE / PSNR /
    SSIM (full, bounding box and valid), val_out / val_err PNGs every
    pass, val_gt once, and the relight outputs, errors and ground truth
    where a relight lighting exists; the PNGs only with `write` (rank 0).
    Over ranks every rank computes the metrics of the whole batch, its
    frames gathered from the (dp, sp) ranks (sp: the mesh's)."""
    agg: dict = {}
    agg_rel: dict = {}

    def accumulate(dst, m):
        for k, v in m.items():
            if not k.endswith("_mean"):
                dst.setdefault(k, []).extend(np.ravel(v).tolist())

    relight_grid = None
    for start in range(0, len(val_views) - bs + 1, bs):
        views = val_views[start:start + bs]
        batch = make_rnr_batch(views, gcn_pos, dev)
        img = fetch_global(eval_step(batch)["img"], sp)
        gt = batch["img_gt"].cpu().numpy()
        alpha = batch["alpha_map"].cpu().numpy()
        accumulate(agg, compute_err_metrics_batch(
            img * alpha * 255.0, gt * alpha * 255.0, alpha,
            compute_ssim=True))
        err = np.clip(np.abs(img - gt), 0.0, 1.0)
        for i in range(bs) if write else ():
            stem = f"{it:08d}_{start + i:05d}.png"
            save_png(os.path.join(log_dir, "val_out", stem), img[i])
            save_png(os.path.join(log_dir, "val_err", stem), err[i])
            if first_val:
                save_png(os.path.join(log_dir, "val_gt",
                                      f"{start + i:05d}.png"), gt[i])
        if lp_relight is None:
            continue
        img_r = fetch_global(eval_step(batch, lp_override=lp_relight,
                                       relight=True)["img"], sp)
        for i in range(bs) if write else ():
            save_png(os.path.join(log_dir, "val_relight_out",
                                  f"{it:08d}_{start + i:05d}.png"), img_r[i])
        if relight_views is not None:
            gt_r = np.stack([np.asarray(v["img_gt"])
                             for v in relight_views[start:start + bs]])
            accumulate(agg_rel, compute_err_metrics_batch(
                img_r * alpha * 255.0, gt_r * alpha * 255.0, alpha,
                compute_ssim=True))
            err_r = np.clip(np.abs(img_r - gt_r), 0.0, 1.0)
            for i in range(bs) if write else ():
                stem = f"{it:08d}_{start + i:05d}.png"
                save_png(os.path.join(log_dir, "val_relight_err", stem),
                         err_r[i])
                if first_val:
                    save_png(os.path.join(log_dir, "val_relight_gt",
                                          f"{start + i:05d}.png"), gt_r[i])
            if relight_grid is None:
                relight_grid = np.concatenate(
                    [np.concatenate([np.clip(img_r[i], 0, 1),
                                     np.clip(gt_r[i], 0, 1), err_r[i]],
                                    axis=1) for i in range(bs)], axis=0)
        elif relight_grid is None:
            relight_grid = np.concatenate(
                [np.clip(img_r[i], 0, 1) for i in range(bs)], axis=0)

    summary = {}

    def report(tag, acc, prefix):
        if not acc:
            return
        means = {k: float(np.mean(v)) for k, v in acc.items()}
        print(f"Val{tag} @ {it}: mae {means['mae_valid']:.4f} "
              f"psnr {means['psnr_valid']:.4f} ssim "
              f"{means['ssim_valid']:.4f}")
        summary.update({prefix + k: v for k, v in means.items()})
        if writer:
            for k in ("mae_valid", "psnr_valid", "ssim_valid", "mae_bb",
                      "psnr_bb", "ssim_bb", "mse_valid"):
                if k in means:
                    writer.add_scalar(f"{prefix}{k}_val", means[k], it)

    report("", agg, "final_")
    report(" relight", agg_rel, "final_relight_")
    if writer and relight_grid is not None:
        writer.add_image("relight_final_est_gt", relight_grid, it,
                         dataformats="HWC")
    return summary


def _final(log_dir, model, optimizer, history, total_iters, val_metrics,
           writer, timing, write=True):
    if not write:
        return
    summary = {"first_loss": history[0] if history else None,
               "last_loss": history[-1] if history else None,
               "iters": total_iters, "timing": timing}
    if val_metrics:
        summary["val"] = val_metrics
    save_checkpoint(os.path.join(log_dir, "model_final.ckpt"), model,
                    optimizer, total_iters)
    with open(os.path.join(log_dir, "summary.json"), "w") as f:
        json.dump(summary, f)
    if writer:
        writer.close()
    print("final:", json.dumps(summary))


if __name__ == "__main__":
    main()
