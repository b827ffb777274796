"""DNR inference driver (port of rnr_tpu/drivers/test_dnr.py).

Loads a DNR checkpoint (the port's format or rnr_tpu's msgpack) and its
`params.json`, rasterizes each test view from the mesh (the G-buffer's
uv, SH basis and alpha maps; K7 on the card), runs the texture and the
U-Net (the eval step) and writes one PNG per view.

Usage:
  python -m rnr_tpu_torch.drivers.test_dnr --data_root DATA \\
      --checkpoint_dir LOG [--calib_dir _/test_seq/spiral_step720]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import scipy.io
import torch

from rnr_tpu_torch.config import DNRConfig, load_config
from rnr_tpu_torch.data import Mesh, ViewDataset
from rnr_tpu_torch.drivers.common import (cond_mkdir, resolve, save_png,
                                          setup_device, str2bool)
from rnr_tpu_torch.drivers.test_rnr import _gbuffer
from rnr_tpu_torch.ops.gbuffer import make_mesh_buffers, render_gbuffer
from rnr_tpu_torch.train.checkpoint import load_checkpoint
from rnr_tpu_torch.train.steps import build_dnr_modules, make_dnr_eval_step


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_root", required=True)
    p.add_argument("--checkpoint_dir", required=True)
    p.add_argument("--checkpoint_name", type=str, default="model_final.ckpt")
    p.add_argument("--calib_fp", type=str, default="_/calib.mat")
    # reference-compat: a calib directory override, and the recompute
    # switch (nothing is cached, so it changes nothing)
    p.add_argument("--calib_dir", type=str, default=None)
    p.add_argument("--force_recompute", default=False, type=str2bool)
    p.add_argument("--obj_fp", type=str, default="_/mesh.obj")
    p.add_argument("--img_size", type=int, default=512)
    p.add_argument("--sampling_pattern", type=str, default="all")
    p.add_argument("--out_dir", type=str, default=None)
    p.add_argument("--platform", type=str, default="cuda",
                   help="cuda (the default) or cpu")
    # reference-script compatibility: accepted and ignored
    p.add_argument("--gpu_id", type=str, default=None)
    p.add_argument("--calib_format", type=str, default="convert",
                   choices=["convert"])
    return p


def gbuffer_batch(gb: dict) -> dict:
    """The DNR eval step's batch from one view's G-buffer: uv_map, the
    first 9 SH basis values, alpha_map [N, H, W, 1] and a zero img_gt."""
    return {"uv_map": gb["uv_map"],
            "sh_basis_map": gb["sh_basis_map"][..., :9],
            "alpha_map": gb["alpha_map"][..., None],
            "img_gt": torch.zeros_like(gb["normal_map"])}


def main(argv=None, keep_frames: bool = False) -> dict:
    """Render the test views.  Returns {"views", "render_s" (the views'
    wall time, PNG writes included), "frames"}: with `keep_frames` the
    masked frames {image stem: [H, W, 3] tensor}, else empty."""
    opt = build_argparser().parse_args(argv)
    dev = setup_device(opt.platform)
    if opt.calib_dir:
        opt.calib_fp = os.path.join(resolve(opt.calib_dir, opt.data_root),
                                    "calib.mat")
    opt.calib_fp = resolve(opt.calib_fp, opt.data_root)
    opt.obj_fp = resolve(opt.obj_fp, opt.data_root)

    cfg = load_config(DNRConfig,
                      os.path.join(opt.checkpoint_dir, "params.json"))
    calib = scipy.io.loadmat(opt.calib_fp)
    mesh = Mesh(opt.obj_fp, global_RT=calib["global_RT"].astype(np.float32))
    mesh_buf = make_mesh_buffers(mesh, dev)
    ds = ViewDataset(root_dir=opt.data_root, calib_path=opt.calib_fp,
                     img_dir=None, load_img=False,
                     img_size=(opt.img_size, opt.img_size),
                     sampling_pattern=opt.sampling_pattern)

    mods = build_dnr_modules(cfg, device=dev)
    load_checkpoint(os.path.join(opt.checkpoint_dir, opt.checkpoint_name),
                    mods)
    eval_step = make_dnr_eval_step(cfg, mods)

    out_dir = opt.out_dir or os.path.join(
        opt.checkpoint_dir, f"test_seq_{opt.sampling_pattern}")
    cond_mkdir(out_dir)
    frames = {}
    t_views = time.perf_counter()
    for i in range(len(ds)):
        t0 = time.time()
        view = ds.read_view(i)
        gb = _gbuffer(render_gbuffer, mesh_buf, view, opt.img_size)
        if "raster_overflow" in gb and int(gb["raster_overflow"].sum()):
            print(f"WARNING view {i}: raster tile-binning overflow -- "
                  "render incomplete, raise max_faces_per_tile")
        batch = gbuffer_batch(gb)
        img = eval_step(batch)[0] * batch["alpha_map"][0]
        stem = view["img_fn"].split(".")[0]
        if keep_frames:
            frames[stem] = img
        save_png(os.path.join(out_dir, stem + ".png"), img)
        print(f"view {i:04d}  t_total {time.time() - t0:.3f}")
    render_s = time.perf_counter() - t_views
    print("wrote", out_dir)
    return {"views": len(ds), "render_s": render_s, "frames": frames}


if __name__ == "__main__":
    main()
