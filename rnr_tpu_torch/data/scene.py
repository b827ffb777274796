"""A synthetic scene on disk for the offline drivers (the port's copy of
tests/test_pipeline_e2e.py's make_scene): a UV-sphere OBJ, `calib.mat`
of a camera ring, a shaded disc per view under two lightings (`rgb0/`,
`rgb1/`) and one light probe per lighting (`lp/`), all 8-bit PNG.

precompute -> stitch_lp -> train_rnr run on it with no captured data;
the quality gate (`rnr_tpu_torch/tools/quality_gate.py`) trains on it.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.io

from rnr_tpu_torch.data.imageio import write_png
from rnr_tpu_torch.ops.cameras import rt_from_pos_lookat


def make_uv_sphere(path: str, n_lat: int = 8, n_lon: int = 12,
                   radius: float = 0.5) -> None:
    """Write a UV-sphere OBJ with positions, normals and texcoords: an
    (n_lat + 1) x (n_lon + 1) vertex grid (poles and seam repeated), one
    triangle a cap quad and two a band quad."""
    vs, vts, vns, faces = [], [], [], []
    for i in range(n_lat + 1):
        theta = np.pi * i / n_lat
        for j in range(n_lon + 1):
            phi = 2 * np.pi * j / n_lon
            x = radius * np.sin(theta) * np.cos(phi)
            y = radius * np.cos(theta)
            z = radius * np.sin(theta) * np.sin(phi)
            vs.append((x, y, z))
            vns.append((x / radius, y / radius, z / radius))
            vts.append((j / n_lon, 1 - i / n_lat))

    def vid(i, j):
        return i * (n_lon + 1) + j
    for i in range(n_lat):
        for j in range(n_lon):
            a, b, c, d = vid(i, j), vid(i, j + 1), vid(i + 1, j + 1), vid(
                i + 1, j)
            if i > 0:
                faces.append((a, b, c))
            if i < n_lat - 1:
                faces.append((a, c, d))
    with open(path, "w") as f:
        for v in vs:
            f.write("v %f %f %f\n" % v)
        for vt in vts:
            f.write("vt %f %f\n" % vt)
        for vn in vns:
            f.write("vn %f %f %f\n" % vn)
        for tri in faces:
            f.write("f " + " ".join(f"{i+1}/{i+1}/{i+1}" for i in tri)
                    + "\n")


def make_scene(root: str, num_view: int = 6, hw: int = 64, n_lat: int = 8,
               n_lon: int = 12) -> str:
    """Write the scene under `root` and return it: mesh.obj (make_uv_sphere
    of n_lat x n_lon), num_view cameras on a ring 2 away and 0.4 up
    looking at the origin (focal 1.2 hw), rgb0/ and rgb1/ %06d.png of
    hw x hw (a disc shaded left to right under lighting 0, top to bottom
    under 1), lp/0.png and lp/1.png (32 x 64 gray ramps)."""
    for d in ("rgb0", "rgb1", "lp"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for li in range(2):
        yy = np.linspace(0, 1, 32)[:, None, None]
        probe = (np.stack([yy * (li + 1) % 1.0] * 3, -1)[..., 0, :]
                 * np.ones((32, 64, 3)))
        write_png(os.path.join(root, "lp", f"{li}.png"),
                  (probe * 255).astype(np.uint8))
    make_uv_sphere(os.path.join(root, "mesh.obj"), n_lat=n_lat, n_lon=n_lon)
    poses = np.zeros((num_view, 4, 4))
    projs = np.zeros((num_view, 3, 3))
    yy, xx = np.mgrid[0:hw, 0:hw]
    disc = (np.hypot(yy - hw / 2, xx - hw / 2) < hw * 0.3).astype(np.float32)
    for i in range(num_view):
        ang = 2 * np.pi * i / num_view
        pos = np.array([2.0 * np.cos(ang), 0.4, 2.0 * np.sin(ang)])
        poses[i] = rt_from_pos_lookat(pos)
        projs[i] = np.array([[hw * 1.2, 0, hw / 2], [0, hw * 1.2, hw / 2],
                             [0, 0, 1]])
        for lighting in (0, 1):
            img = np.zeros((hw, hw, 3), np.uint8)
            shade = (0.4 + 0.6 * (xx / hw) if lighting == 0
                     else 1.0 - 0.5 * (yy / hw))
            img[..., 0] = np.uint8(200 * disc * shade)
            img[..., 1] = np.uint8(150 * disc * shade)
            img[..., 2] = np.uint8(100 * disc)
            # channels 0, 1, 2 are blue, green, red in the file, as the
            # reference's cv2 writes of these arrays
            write_png(os.path.join(root, f"rgb{lighting}", "%06d.png" % i),
                      img[..., ::-1].copy())
    scipy.io.savemat(os.path.join(root, "calib.mat"), {
        "poses": poses, "projs": projs,
        "dist_coeffs": np.zeros((num_view, 5)),
        "img_hws": np.tile([hw, hw], (num_view, 1)),
        "global_RT": np.eye(4)})
    return root
