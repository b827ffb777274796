"""Per-pixel view rays and reflections, and host-side camera helpers
(port of rnr_tpu/ops/cameras.py: `get_view_dir_map`, `get_reflect_dir`,
`rt_from_pos_lookat`, `euler_to_rot`, and the NumPy spiral, view and
rotation helpers that no driver calls: `get_spiral`,
`get_archimedean_spiral`, `interpolate_views`, `get_nn_ranking`,
`az_el_to_rot`, `rand_euler_rotation_matrix`, `rot_mag`, `quat2rot`,
`rot2quat`)."""

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


def get_spiral(step_azi: float = -2.0, step_ele: float = 90.0 / 720):
    """Azimuth/elevation arrays for the spiral test path (camera.py:72-76)."""
    num_step = int(np.floor(90.0 / step_ele))
    cam_pos_azi = np.arange(0, step_azi * num_step, step=step_azi)
    cam_pos_ele = np.arange(0, step_ele * num_step, step=step_ele)
    return cam_pos_azi, cam_pos_ele


def get_archimedean_spiral(
    sphere_radius: float,
    origin: np.ndarray | None = None,
    num_step: int = 1000,
) -> list[np.ndarray]:
    """Camera positions along an Archimedean spiral on a sphere
    (data_util.py:64-82).

    Walks the parameter i from a/2 down to 0 in steps of a/(2*num_step)
    (a=300), producing ~num_step xyz positions spiralling from the south
    pole to the equatorial plane at the given radius around `origin`.
    """
    a = 300.0
    r = float(sphere_radius)
    o = np.zeros(3) if origin is None else np.asarray(origin, np.float64)
    translations = []
    i = a / 2
    while i > 0.0:
        el = (-np.pi / 2) + i / a * np.pi
        xyz = np.array([
            r * np.cos(i) * np.cos(el),
            r * np.sin(i) * np.cos(el),
            -r * np.sin(el),
        ])
        translations.append(xyz + o)
        i -= a / (2.0 * num_step)
    return translations


def interpolate_views(
    pose_1: np.ndarray, pose_2: np.ndarray, num_steps: int = 100
) -> list[np.ndarray]:
    """Linear pose interpolation with per-column rotation renormalization
    (data_util.py:85-98)."""
    poses = []
    for t in np.linspace(0.0, 1.0, num_steps):
        pose = (1.0 - t) * np.asarray(pose_1, np.float64) + t * np.asarray(
            pose_2, np.float64
        )
        pose[:3, :3] /= np.linalg.norm(pose[:3, :3], axis=0, keepdims=True)
        poses.append(pose)
    return poses


def get_nn_ranking(poses: list[np.ndarray]):
    """Rank views by optical-axis cosine similarity (data_util.py:106-115).

    Returns (nn_idcs, cos_sim_mat): per-view neighbor indices sorted by
    increasing similarity (self forced to -1 on the diagonal) and the
    row-sorted similarity matrix, matching the reference's in-place sort.
    """
    axes = np.stack([np.asarray(p, np.float64)[:3, 2] for p in poses], axis=0)
    axes /= np.linalg.norm(axes, axis=1, ord=2, keepdims=True)
    cos_sim_mat = axes.dot(axes.T)
    np.fill_diagonal(cos_sim_mat, -1.0)
    nn_idcs = cos_sim_mat.argsort(axis=1).astype(int)
    cos_sim_mat.sort(axis=1)
    return nn_idcs, cos_sim_mat


def az_el_to_rot(az: float, el: float) -> np.ndarray:
    """Azimuth/elevation (degrees) to rotation matrix with the lsm-style
    axis-correction matrix (data_util.py:194-214)."""
    corr_mat = np.array([[0.0, 0.0, -1.0], [1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    inv_corr_mat = np.linalg.inv(corr_mat)
    ta, te = -float(az) * np.pi / 180.0, -float(el) * np.pi / 180.0
    # Note: the reference's local R_x/R_y here are TRANSPOSED relative to
    # euler_to_rot's (sin signs flipped) — reproduce that exactly.
    r_x = np.array([
        [1.0, 0.0, 0.0],
        [0.0, np.cos(te), np.sin(te)],
        [0.0, -np.sin(te), np.cos(te)],
    ])
    r_y = np.array([
        [np.cos(ta), 0.0, -np.sin(ta)],
        [0.0, 1.0, 0.0],
        [np.sin(ta), 0.0, np.cos(ta)],
    ])
    return (r_x @ r_y) @ inv_corr_mat


def rand_euler_rotation_matrix(nmax: float = 10, rng: np.random.Generator | None = None):
    """Random small-angle Euler rotation (data_util.py:217-220).

    Angles are uniform in [-nmax, nmax] degrees per axis. Accepts an
    optional numpy Generator for determinism (the reference uses the
    global numpy RNG).
    """
    uniform = (rng.uniform(size=(3,)) if rng is not None
               else np.random.uniform(size=(3,)))
    euler = (uniform - 0.5) * nmax * 2 * np.pi / 360.0
    return euler_to_rot(euler), euler * 180.0 / np.pi


def rot_mag(R: np.ndarray) -> float:
    """Rotation magnitude in degrees (data_util.py:223-226).

    The reference computes ||logm(R)||_F / sqrt(2) * 180/pi; for a proper
    rotation that equals the rotation angle arccos((tr(R)-1)/2), which we
    use directly (no scipy.linalg.logm dependency, no complex round-trip).
    """
    c = (float(np.trace(np.asarray(R, np.float64))) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def quat2rot(q: np.ndarray) -> np.ndarray:
    """Rotation matrix from quaternion [w, x, y, z] (data_util.py:123-143).

    Degenerate (near-zero-norm) quaternions map to the identity, like the
    reference's eps guard.
    """
    eps = 1e-5
    w, x, y, z = float(q[0]), float(q[1]), float(q[2]), float(q[3])
    n = float(np.linalg.norm(np.asarray(q, np.float64)))
    s = 0.0 if n < eps else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1 - (xx + yy)],
    ])


def rot2quat(M: np.ndarray) -> np.ndarray:
    """Quaternion [w, x, y, z] from a rotation matrix (data_util.py:146-172).

    Accepts 3x3 or 4x4 (homogeneous) matrices; uses the trace-vs-diagonal
    branch structure of the reference (Shepperd's method).
    """
    import math

    M = np.asarray(M, np.float64)
    if M.shape[0] < 4 or M.shape[1] < 4:
        newM = np.zeros((4, 4))
        newM[:3, :3] = M[:3, :3]
        newM[3, 3] = 1.0
        M = newM
    q = np.empty((4,))
    t = np.trace(M)
    if t > M[3, 3]:
        q[0] = t
        q[3] = M[1, 0] - M[0, 1]
        q[2] = M[0, 2] - M[2, 0]
        q[1] = M[2, 1] - M[1, 2]
    else:
        i, j, k = 0, 1, 2
        if M[1, 1] > M[0, 0]:
            i, j, k = 1, 2, 0
        if M[2, 2] > M[i, i]:
            i, j, k = 2, 0, 1
        t = M[i, i] - (M[j, j] + M[k, k]) + M[3, 3]
        q[i] = t
        q[j] = M[i, j] + M[j, i]
        q[k] = M[k, i] + M[i, k]
        q[3] = M[k, j] - M[j, k]
        q = q[[3, 0, 1, 2]]
    q *= 0.5 / math.sqrt(t * M[3, 3])
    return q
