"""Per-pixel view rays and reflections, and host-side camera helpers
(port of rnr_tpu/ops/cameras.py: `get_view_dir_map`, `get_reflect_dir`,
`rt_from_pos_lookat`, `euler_to_rot`)."""

from __future__ import annotations

import numpy as np
import torch

from rnr_tpu_torch.ops.projection import rows_dot
from rnr_tpu_torch.ops.tbn import normalize


def get_view_dir_map(img_size: tuple[int, int], proj_inv: torch.Tensor,
                     R_inv: torch.Tensor):
    """Per-pixel unit view directions (from the surface towards the
    camera: the negated un-projection of the pixel centre).

    img_size (H, W); proj_inv, R_inv [N, 3, 3] (inverse intrinsics,
    world-from-camera rotation).  Returns (view_dir_map [N, H, W, 3]
    world, view_dir_map_cam [N, H, W, 3]).
    """
    h, w = int(img_size[0]), int(img_size[1])
    n, dev = proj_inv.shape[0], proj_inv.device
    v, u = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(w, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij")
    uv1 = torch.stack((u, v, torch.ones_like(u)), dim=-1)     # [H, W, 3]
    xyz_cam = normalize(-rows_dot(uv1.expand(n, h, w, 3), proj_inv))
    xyz_world = rows_dot(xyz_cam, R_inv)
    return normalize(xyz_world), xyz_cam


def get_reflect_dir(orig_dir: torch.Tensor, pivot_dir: torch.Tensor,
                    axis: int = -1) -> torch.Tensor:
    """Reflect `orig_dir` about `pivot_dir`: 2 (p.o) p - o, normalized;
    `axis` is the xyz dimension."""
    dot = torch.sum(pivot_dir * orig_dir, dim=axis, keepdim=True)
    return normalize(dot * 2.0 * pivot_dir - orig_dir, dim=axis)


def rt_from_pos_lookat(cam_pos: np.ndarray,
                       cam_lookat: np.ndarray | None = None,
                       cam_up: np.ndarray | None = None) -> np.ndarray:
    """4x4 camera-from-world extrinsic (float64) of a camera at `cam_pos`
    looking at `cam_lookat` (the origin) with `cam_up` (+y): rows right,
    -up, forward."""
    cam_lookat = np.zeros(3) if cam_lookat is None else cam_lookat
    cam_up = np.array([0.0, 1.0, 0.0]) if cam_up is None else cam_up
    fwd = cam_lookat - cam_pos
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, cam_up)
    right = right / np.linalg.norm(right)
    up = np.cross(right, fwd)
    R = np.stack([right, -up, fwd], axis=0).astype(np.float64)
    T = -R.dot(cam_pos[:, None])
    return np.concatenate([np.concatenate([R, T], axis=1),
                           np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0)


def euler_to_rot(theta: np.ndarray) -> np.ndarray:
    """Rz @ Ry @ Rx rotation from xyz Euler angles."""
    cx, sx = np.cos(theta[0]), np.sin(theta[0])
    cy, sy = np.cos(theta[1]), np.sin(theta[1])
    cz, sz = np.cos(theta[2]), np.sin(theta[2])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx
