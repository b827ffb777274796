"""Host-side camera helpers (port of the NumPy part of rnr_tpu/ops/cameras.py)."""

from __future__ import annotations

import numpy as np


def euler_to_rot(theta: np.ndarray) -> np.ndarray:
    """Rz @ Ry @ Rx rotation from xyz Euler angles."""
    cx, sx = np.cos(theta[0]), np.sin(theta[0])
    cy, sy = np.cos(theta[1]), np.sin(theta[1])
    cz, sz = np.cos(theta[2]), np.sin(theta[2])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx
