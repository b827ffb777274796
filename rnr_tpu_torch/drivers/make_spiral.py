"""Generate a spiral camera-path test sequence (calib.mat); port of
rnr_tpu/drivers/make_spiral.py (host NumPy, no device).

The reference's headline inference sequence `test_seq/spiral_step720`
(test_rnr.sh:2,8) is a precomputed spiral of camera poses around the
object.  This driver generates an equivalent sequence from any training
calib: cameras orbit the mesh center on a spiral (azimuth step -2 deg,
elevation sweep 0..90 over 720 steps by default — camera.py:72-76),
at the mean training-camera distance, sharing the training intrinsics.

Usage:
  python -m rnr_tpu_torch.drivers.make_spiral --data_root DATA \
      [--out_dir _/test_seq/spiral_step720] [--num_step 720]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import scipy.io

from rnr_tpu_torch.data.obj import load_obj
from rnr_tpu_torch.drivers.common import cond_mkdir, resolve
from rnr_tpu_torch.ops.cameras import rt_from_pos_lookat


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_root", required=True)
    p.add_argument("--calib_fp", type=str, default="_/calib.mat")
    p.add_argument("--obj_fp", type=str, default="_/mesh.obj")
    p.add_argument("--out_dir", type=str,
                   default="_/test_seq/spiral_step720")
    p.add_argument("--step_azi", type=float, default=-2.0)
    p.add_argument("--num_step", type=int, default=720)
    p.add_argument("--max_ele", type=float, default=90.0)
    return p


def main(argv=None) -> str:
    """Write the spiral's calib.mat; returns its path."""
    opt = build_argparser().parse_args(argv)
    opt.calib_fp = resolve(opt.calib_fp, opt.data_root)
    opt.obj_fp = resolve(opt.obj_fp, opt.data_root)
    opt.out_dir = resolve(opt.out_dir, opt.data_root)
    cond_mkdir(opt.out_dir)

    calib = scipy.io.loadmat(opt.calib_fp)
    global_RT = calib["global_RT"]
    mesh = load_obj(opt.obj_fp)
    hom = np.concatenate([mesh.v, np.ones((len(mesh.v), 1))], 1)
    v_world = (global_RT @ hom.T).T[:, :3]
    center = v_world.mean(0)

    # mean training-camera distance to the mesh center
    cams = []
    for i in range(calib["poses"].shape[0]):
        pose = calib["poses"][i] @ np.linalg.inv(global_RT)
        R = pose[:3, :3]
        t = pose[:3, 3]
        cams.append(-R.T @ t)
    dist = float(np.linalg.norm(np.stack(cams) - center, axis=1).mean())

    step_ele = opt.max_ele / opt.num_step
    poses = []
    projs = []
    proj0 = calib["projs"][0]
    hw0 = calib["img_hws"][0]
    for i in range(opt.num_step):
        azi = np.radians(opt.step_azi * i)
        ele = np.radians(step_ele * i)
        pos = center + dist * np.array(
            [
                np.cos(ele) * np.cos(azi),
                np.sin(ele),
                np.cos(ele) * np.sin(azi),
            ]
        )
        RT = rt_from_pos_lookat(pos, center)
        # store in the calib convention: pose rows are cam-from-world of
        # the *pre-global_RT* frame
        poses.append(RT @ global_RT)
        projs.append(proj0)

    path = os.path.join(opt.out_dir, "calib.mat")
    scipy.io.savemat(
        path,
        {
            "poses": np.stack(poses),
            "projs": np.stack(projs),
            "dist_coeffs": np.zeros((opt.num_step, 5)),
            "img_hws": np.tile(hw0, (opt.num_step, 1)),
            "global_RT": global_RT,
        },
    )
    print(f"wrote {opt.num_step}-step spiral to {opt.out_dir}/calib.mat "
          f"(radius {dist:.3f})")
    return path


if __name__ == "__main__":
    main()
