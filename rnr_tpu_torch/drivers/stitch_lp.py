"""Stitch an initial environment map from the views' backgrounds (port of
rnr_tpu/drivers/stitch_lp.py).

For each sampled view: mask out the projected object (its faces filled,
dilated by 17 pixels at 512^2, resized back), map every background
pixel's camera ray to equirect coordinates and average the pixels'
colours into a light probe.  Writes
`light_probe_stitch_<pattern>/{idx}.png`, `{idx}.exr` (the float probe,
FLOAT and ZIP, as rnr_tpu writes it where its cv2 has OpenEXR),
`mask/{idx}.png` (coverage) and `count/{idx}.png|.mat`, the inputs of
train_rnr.  The views are `rgb<idx>/%03d.exr` at the default suffix,
else `rgb<idx>/%06d<suffix>` over 255.  Host NumPy throughout
(`data/imageio.py` for the image files and operations).

Usage:
  python -m rnr_tpu_torch.drivers.stitch_lp --data_root DATA
      [--lighting_idx 0] [--sampling_pattern skipinv_10] [--img_suffix .png]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import scipy.io

from rnr_tpu_torch.data import load_obj
from rnr_tpu_torch.data.dataset import apply_sampling_pattern
from rnr_tpu_torch.data.imageio import (IMREAD_UNCHANGED, dilate,
                                        fill_poly, read_image, resize,
                                        write_exr, write_png)
from rnr_tpu_torch.drivers.common import cond_mkdir, resolve


def spherical_mapping_np(d: np.ndarray) -> np.ndarray:
    """[3, ...] directions -> [2, ...] equirect uv."""
    u = np.arctan2(d[2], d[0]) * 0.5 / np.pi + 0.5
    v = np.arccos(np.clip(d[1], -1.0, 1.0)) / np.pi
    return np.stack((u, v))


def camera_rays_np(pose: np.ndarray, proj: np.ndarray, w: int, h: int
                   ) -> np.ndarray:
    """World-space ray per pixel, [3, H, W]."""
    y, x = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
    p = np.stack((x, y, np.ones_like(x))).reshape(3, -1)
    p = np.linalg.inv(proj) @ p
    p = np.linalg.inv(pose[:3, :3]) @ p
    p /= np.maximum(np.linalg.norm(p, axis=0, keepdims=True), 1e-12)
    return p.reshape(3, h, w)


def object_mask(v_px: np.ndarray, faces: np.ndarray, img_h: int,
                img_w: int) -> np.ndarray:
    """The object's faces filled (pixel vertices v_px [2, V] int32), dilated
    by a 17 x 17 square at 512^2 and resized back: uint8 [H, W]."""
    mask = np.zeros((img_h, img_w), np.uint8)
    fill_poly(mask, v_px[:2].T[faces], 255)
    return resize(dilate(resize(mask, (512, 512)), 17), (img_w, img_h))


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_root", required=True)
    p.add_argument("--calib_fp", type=str, default="_/calib.mat")
    p.add_argument("--obj_fp", type=str, default="_/mesh.obj")
    p.add_argument("--lighting_idx", type=int, default=0)
    p.add_argument("--sampling_pattern", type=str, default="skipinv_10")
    p.add_argument("--img_suffix", type=str, default=".exr")
    p.add_argument("--lp_h", type=int, default=1600)
    p.add_argument("--lp_w", type=int, default=3200)
    return p


def main(argv=None) -> None:
    opt = build_argparser().parse_args(argv)
    opt.calib_fp = resolve(opt.calib_fp, opt.data_root)
    opt.obj_fp = resolve(opt.obj_fp, opt.data_root)
    img_dir = os.path.join(opt.data_root, f"rgb{opt.lighting_idx}")

    save_dir = os.path.join(opt.data_root,
                            f"light_probe_stitch_{opt.sampling_pattern}")
    save_mask = os.path.join(save_dir, "mask")
    save_count = os.path.join(save_dir, "count")
    for d in (save_dir, save_mask, save_count):
        cond_mkdir(d)

    calib = scipy.io.loadmat(opt.calib_fp)
    poses, projs, img_hws = calib["poses"], calib["projs"], calib["img_hws"]
    num_view = poses.shape[0]

    mesh = load_obj(opt.obj_fp)
    global_RT = calib["global_RT"]
    verts_h = np.concatenate(
        [mesh.v, np.ones((mesh.v.shape[0], 1), np.float32)], axis=1)
    vertices = global_RT @ verts_h.T   # [4, V] world

    keep = set(apply_sampling_pattern(num_view, opt.sampling_pattern))
    env = np.zeros((opt.lp_h, opt.lp_w, 3), np.float64)
    count = np.zeros((opt.lp_h, opt.lp_w, 3), np.float32)
    used_views = 0

    for i in range(num_view):
        if i not in keep:
            continue
        img_h, img_w = int(img_hws[i, 0]), int(img_hws[i, 1])
        pose = poses[i] @ np.linalg.inv(global_RT)
        proj = projs[i]

        name = "%03d%s" if opt.img_suffix == ".exr" else "%06d%s"
        fp = os.path.join(img_dir, name % (i, opt.img_suffix))
        if not os.path.isfile(fp):
            print(f"view {i}: missing image {fp}, skipped")
            continue
        img = read_image(fp, IMREAD_UNCHANGED)
        if opt.img_suffix != ".exr":
            img = img.astype(np.float32)[:, :, :3] / 255.0

        # project the vertices and clamp them into the frame
        v_cam = pose @ vertices
        v_px = proj @ v_cam[:3]
        v_px[0] /= v_px[2]
        v_px[1] /= v_px[2]
        v_px = v_px.astype(np.int32)
        v_px[v_px < 0] = 0
        v_px[0, v_px[0] > img_w - 1] = img_w - 1
        v_px[1, v_px[1] > img_h - 1] = img_h - 1
        bg = object_mask(v_px, mesh.f_v_idx, img_h, img_w) == 0

        rays = camera_rays_np(pose, proj, img_w, img_h)
        uv = spherical_mapping_np(rays[:, bg])
        ui = np.round(np.clip(uv[0] * opt.lp_w, None, opt.lp_w - 1)).astype(int)
        vi = np.round(np.clip(uv[1] * opt.lp_h, None, opt.lp_h - 1)).astype(int)
        np.add.at(env, (vi, ui), img[bg][:, :3])
        np.add.at(count, (vi, ui), 1.0)
        used_views += 1
        if used_views % 10 == 0:
            print(f"view {i} stitched")

    covered = count.sum(axis=2) > 0
    env[covered] /= count[covered]

    idx = str(opt.lighting_idx)
    write_png(os.path.join(save_dir, idx + ".png"),
              (np.clip(env, 0, 1) * 255).astype(np.uint8))
    write_exr(os.path.join(save_dir, idx + ".exr"), env.astype(np.float32))
    write_png(os.path.join(save_mask, idx + ".png"),
              (covered[:, :, None].repeat(3, 2) * 255).astype(np.uint8))
    write_png(os.path.join(save_count, idx + ".png"),
              (count / max(used_views, 1) * 255.0).astype(np.uint8))
    scipy.io.savemat(os.path.join(save_count, idx + ".mat"),
                     {"count": count[:, :, 0].astype(np.int64),
                      "num_view": used_views})
    print(f"stitched {used_views} views -> {save_dir}")


if __name__ == "__main__":
    main()
