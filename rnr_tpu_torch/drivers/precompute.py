"""Offline G-buffer precomputation (port of rnr_tpu/drivers/precompute.py).

Renders every calibrated view of a mesh through `render_gbuffer` (the
projection, K7's tile z-buffer and every per-pixel map, on the card) and
writes the maps to `data_root/precomp_<obj>/resol_<S>/...`, the layout
and files of rnr_tpu's precompute, so either package's training reads
them.  A view whose rasterizer tile binning overflowed raises.

Usage:
  python -m rnr_tpu_torch.drivers.precompute --data_root DATA
      [--obj_fp _/mesh.obj] [--img_size 512] [--sampling_pattern all]
      [--only_mesh_related false] [--platform cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import scipy.io

from rnr_tpu_torch.data import Mesh, ViewDataset
from rnr_tpu_torch.drivers.common import (cond_mkdir, resolve, save_png,
                                          setup_device, str2bool)
from rnr_tpu_torch.drivers.test_rnr import _gbuffer
from rnr_tpu_torch.ops.gbuffer import make_mesh_buffers, render_gbuffer

HIGH_KEYS = ("normal_map", "normal_map_cam", "position_map",
             "position_map_cam", "view_dir_map", "view_dir_map_cam",
             "view_dir_map_tangent", "sh_basis_map", "reflect_dir_map",
             "TBN_map")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_root", required=True)
    p.add_argument("--obj_fp", type=str, default="_/mesh.obj")
    p.add_argument("--calib_fp", type=str, default="_/calib.mat")
    p.add_argument("--img_dir", type=str, default="_/rgb0")
    p.add_argument("--sampling_pattern", type=str, default="all")
    p.add_argument("--img_size", type=int, default=512)
    p.add_argument("--only_mesh_related", default=False, type=str2bool)
    p.add_argument("--platform", type=str, default="cuda",
                   help="cuda (the default) or cpu")
    # reference-script compatibility: accepted and ignored
    p.add_argument("--gpu_id", type=str, default=None)
    p.add_argument("--calib_format", type=str, default="convert",
                   choices=["convert"])
    return p


def main(argv=None) -> None:
    opt = build_argparser().parse_args(argv)
    opt.obj_fp = resolve(opt.obj_fp, opt.data_root)
    opt.calib_fp = resolve(opt.calib_fp, opt.data_root)
    opt.img_dir = resolve(opt.img_dir, opt.data_root)
    obj_name = os.path.basename(opt.obj_fp).split(".")[0]
    dev = setup_device(opt.platform)

    calib = scipy.io.loadmat(opt.calib_fp)
    mesh = Mesh(opt.obj_fp, global_RT=calib["global_RT"].astype(np.float32))
    mesh_buf = make_mesh_buffers(mesh, dev)
    print(f"mesh: {mesh.num_vertex} vertices, {mesh.num_face} faces")

    dataset = ViewDataset(
        root_dir=opt.data_root, calib_path=opt.calib_fp, img_dir=opt.img_dir,
        img_size=(opt.img_size, opt.img_size),
        sampling_pattern=opt.sampling_pattern, ignore_dist_coeffs=True)
    dataset.buffer_all()

    base = os.path.join(opt.data_root, f"precomp_{obj_name}")
    res = os.path.join(base, f"resol_{opt.img_size}")
    dirs = {"raster": os.path.join(res, "raster")}
    if not opt.only_mesh_related:
        for key in ("uv_map", "alpha_map", *HIGH_KEYS, "img_gt", "proj"):
            dirs[key] = os.path.join(res, key)
        dirs["pose"] = os.path.join(base, "pose")
    for d in dirs.values():
        cond_mkdir(d)

    for i in range(len(dataset)):
        view = dataset[i]
        stem = view["img_fn"].split(".")[0]
        gb = _gbuffer(render_gbuffer, mesh_buf, view, opt.img_size,
                      with_high_maps=not opt.only_mesh_related)
        gb = {k: v.cpu().numpy() for k, v in gb.items()}
        if int(gb.pop("raster_overflow", np.int32(0)).sum()):
            raise RuntimeError(
                f"view {stem}: rasterizer tile binning overflowed -- "
                "raise max_faces_per_tile (render would be incomplete)")

        scipy.io.savemat(os.path.join(dirs["raster"], stem + ".mat"), {
            "face_index_map": gb["face_index_map"][0],
            "weight_map": gb["weight_map"][0],
            "faces_v_idx": mesh.f_v_idx,
            "v_uvz": gb["v_uvz"][0],
            "v_front_mask": gb["v_front_mask"][0][None, :],
        })
        if not opt.only_mesh_related:
            alpha = gb["alpha_map"][0]
            scipy.io.savemat(os.path.join(dirs["uv_map"], stem + ".mat"),
                             {"uv_map": gb["uv_map"][0]})
            save_png(os.path.join(dirs["alpha_map"], stem + ".png"),
                     alpha[..., None].repeat(3, -1))
            # camera-space directions flipped to z-out space on disk, the
            # reference's saved-file convention
            zout = np.asarray([1.0, -1.0, -1.0], np.float32)
            gb["normal_map_cam"] = gb["normal_map_cam"] * zout
            gb["view_dir_map_cam"] = gb["view_dir_map_cam"] * zout
            for key in HIGH_KEYS:
                scipy.io.savemat(os.path.join(dirs[key], stem + ".mat"),
                                 {key: gb[key][0]})
            save_png(os.path.join(dirs["img_gt"], stem + ".png"),
                     view["img_gt"])
            scipy.io.savemat(os.path.join(dirs["pose"], stem + ".mat"),
                             {"pose": view["pose"],
                              "proj_orig": view["proj_orig"]})
            scipy.io.savemat(os.path.join(dirs["proj"], stem + ".mat"),
                             {"proj": view["proj"]})
        if i % 10 == 0:
            print(f"view {i}/{len(dataset)}")
    print("precompute done:", res)


if __name__ == "__main__":
    main()
