"""Equirectangular (light-probe) direction <-> UV mappings (port of
rnr_tpu/ops/spherical.py).

    u = atan2(z, x) / (2 pi) + 0.5
    v = acos(y) / pi

so +y is the probe's "up" and u wraps around the x/z great circle, with
the seam (u = 0 and 1) on the -x axis.
"""

from __future__ import annotations

import math

import torch

_PI = math.pi


def spherical_mapping(l_dir: torch.Tensor) -> torch.Tensor:
    """Directions -> equirect UV: l_dir [3, ...] -> [2, ...]."""
    u = torch.atan2(l_dir[2], l_dir[0]) * (0.5 / _PI) + 0.5
    v = torch.acos(torch.clamp(l_dir[1], -1.0, 1.0)) / _PI
    return torch.stack((u, v), dim=0)


def spherical_mapping_batch(l_dir: torch.Tensor) -> torch.Tensor:
    """Batched directions -> UV: l_dir [N, 3, ...] -> [N, 2, ...]."""
    u = torch.atan2(l_dir[:, 2], l_dir[:, 0]) * (0.5 / _PI) + 0.5
    v = torch.acos(torch.clamp(l_dir[:, 1], -1.0, 1.0)) / _PI
    return torch.stack((u, v), dim=1)


def spherical_mapping_inv(uv: torch.Tensor) -> torch.Tensor:
    """Equirect UV -> unit directions: uv [2, ...] -> [3, ...].

    At u = 0 and u = 1 (t = -1, +1) sin(t pi) is not exactly zero in
    floating point; its sign is flipped there, as rnr_tpu does."""
    y = torch.cos(uv[1] * _PI)
    r = torch.sqrt(torch.clamp(1.0 - y * y, min=0.0))
    t = uv[0] * 2.0 - 1.0
    x = r * torch.cos(t * _PI)
    z = r * torch.sin(t * _PI)
    z = z * torch.where(t == 1.0, -1.0, 1.0)
    z = z * torch.where(t == -1.0, -1.0, 1.0)
    d = torch.stack((x, y, z), dim=0)
    n = torch.linalg.vector_norm(d, dim=0, keepdim=True)
    return d / torch.clamp(n, min=1e-12)


def cart2sph(x, y, z):
    """Cartesian -> (azimuth, elevation, radius)."""
    azimuth = torch.atan2(y, x)
    elevation = torch.atan2(z, torch.sqrt(x * x + y * y))
    r = torch.sqrt(x * x + y * y + z * z)
    return azimuth, elevation, r


def sph2cart(azimuth, elevation, r):
    """(azimuth, elevation, radius) -> Cartesian."""
    x = r * torch.cos(elevation) * torch.cos(azimuth)
    y = r * torch.cos(elevation) * torch.sin(azimuth)
    z = r * torch.sin(elevation)
    return x, y, z


def sample_light_dir(azi_deg: torch.Tensor, pol_deg: torch.Tensor):
    """Light directions on the azimuth x polar grid (degrees): returns
    (world "z-out" directions, z-up directions), each [3, S]."""
    azi, pol = torch.meshgrid(azi_deg, pol_deg, indexing="ij")
    azi = azi * (_PI / 180.0)
    ele = _PI / 2.0 - pol * (_PI / 180.0)
    x, y, z = sph2cart(azi, ele, 1.0)
    d = torch.stack((x, y, z), dim=0)
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=0, keepdim=True),
                        min=1e-12)
    d_zup = d.reshape(3, -1)
    # z-up -> world (z-out): y_world = z_zup, z_world = -y_zup
    d_world = torch.stack((d[0], d[2], -d[1]), dim=0).reshape(3, -1)
    return d_world, d_zup
