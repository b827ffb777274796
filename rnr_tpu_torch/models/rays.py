"""Ray fans and SH-direct ray composition (port of rnr_tpu/models/rays.py).

Channels-last throughout: per-pixel rays are [..., 3, R] (xyz by ray),
light transport [N, H, W, R, C].
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rnr_tpu_torch.ops.cameras import euler_to_rot
from rnr_tpu_torch.ops.sh_cuda import sh_shade_fan


@dataclasses.dataclass
class RaySampler:
    """Fixed fan of ray pivots around the tangent-space normal.

    num_ray = num_azi * num_polar + 1 (the +1 is the identity pivot);
    `pivots_dir` is [3, num_ray].  Only the pivot table is ported: the
    serving path builds the rays with `build_fan_channels`.
    """

    num_azi: int
    num_polar: int
    interval_polar: float = 5.0
    mode: str = "reflect"

    def __post_init__(self):
        roty = (np.arange(1, self.num_polar + 1) * self.interval_polar
                * np.pi / 180.0)
        rotz = np.arange(self.num_azi) * 2.0 * np.pi / self.num_azi
        roty, rotz = np.meshgrid(roty, rotz, sparse=False)
        rot = np.stack([np.zeros(roty.size), roty.flatten(), rotz.flatten()],
                       axis=0)
        self.num_ray = rot.shape[1] + 1
        rs = np.zeros((self.num_ray, 3, 3), np.float32)
        rs[0] = np.eye(3)
        for i in range(self.num_ray - 1):
            rs[i + 1] = euler_to_rot(rot[:, i])
        self.pivots_dir = np.einsum("rij,j->ir", rs, np.array([0.0, 0.0, 1.0]))


def build_fan_channels(tbn, vdt, alpha, pivots, r_spec: int):
    """Spec + diffuse fans as [N,H,W,R] broadcasts.

    tbn [N,H,W,3,3], vdt [N,H,W,3], alpha [N,H,W,1], pivots [R,3] (spec
    pivots first).  Returns (net_rays [N,H,W,R*3] with per-ray xyz
    grouping, rays_dir [N,H,W,3,R]).
    """
    r_total = pivots.shape[0]
    px, py, pz = pivots[:, 0], pivots[:, 1], pivots[:, 2]
    vx, vy, vz = vdt[..., 0:1], vdt[..., 1:2], vdt[..., 2:3]
    dot = vx * px + vy * py + vz * pz
    rx = 2.0 * dot * px - vx
    ry = 2.0 * dot * py - vy
    rz = 2.0 * dot * pz - vz
    inv = alpha / torch.clamp(torch.sqrt(rx * rx + ry * ry + rz * rz),
                              min=1e-12)
    spec = torch.arange(r_total, device=pivots.device) < r_spec
    tx = torch.where(spec, rx * inv, px)
    ty = torch.where(spec, ry * inv, py)
    tz = torch.where(spec, rz * inv, pz)
    wx = tbn[..., 0, 0:1] * tx + tbn[..., 0, 1:2] * ty + tbn[..., 0, 2:3] * tz
    wy = tbn[..., 1, 0:1] * tx + tbn[..., 1, 1:2] * ty + tbn[..., 1, 2:3] * tz
    wz = tbn[..., 2, 0:1] * tx + tbn[..., 2, 1:2] * ty + tbn[..., 2, 2:3] * tz
    inv_w = 1.0 / torch.clamp(torch.sqrt(wx * wx + wy * wy + wz * wz),
                              min=1e-12)
    wx, wy, wz = wx * inv_w, wy * inv_w, wz * inv_w
    n, h, w = vdt.shape[:3]
    net_rays = torch.stack([wx, wy, wz], dim=-1).reshape(n, h, w, r_total * 3)
    rays_dir = torch.stack([wx, wy, wz], dim=-2)
    return net_rays, rays_dir


def rays_lt_chrom_loss(rays_lt: torch.Tensor, alpha_map: torch.Tensor,
                       img: torch.Tensor | None = None):
    """White-light-transport chromaticity prior (rnr_tpu/models/rays.py:199).

    rays_lt [N, H, W, R, C] (f32 math even when stored bf16), alpha_map
    [N, H, W, 1], img optional [N, H, W, C] intensity weighting.  Both
    normalisations use rsqrt(sq + 1e-20), finite with a finite gradient at
    rays_lt = 0 (where a norm's gradient is NaN).
    Returns (loss, chrom, chrom_mean, diff).
    """
    rays_lt = rays_lt.to(torch.float32)
    sq = torch.sum(rays_lt * rays_lt, dim=-1, keepdim=True)
    chrom = rays_lt * torch.rsqrt(sq + 1e-20)
    chrom_mean = torch.mean(chrom, dim=-2, keepdim=True)
    sq_m = torch.sum(chrom_mean * chrom_mean, dim=-1, keepdim=True)
    chrom_mean = chrom_mean * torch.rsqrt(sq_m + 1e-20)
    diff = (1.0 - torch.sum(chrom * chrom_mean, dim=-1)) * alpha_map
    if img is not None:
        weight = torch.clamp(torch.linalg.vector_norm(img, dim=-1,
                                                      keepdim=True) * 20.0,
                             max=1.0)
        diff = diff * weight
    loss = (torch.sum(diff) / torch.clamp(torch.sum(alpha_map), min=1.0)
            / rays_lt.shape[-2])
    return loss, chrom, chrom_mean, diff


def ray_render_sh(albedo_specular, alpha_map, rays_lt, sh_coeff, sh_lmax: int,
                  fan_inputs, num_ray_diffuse: int, albedo_diffuse):
    """SH-direct composition, fan-fused branch (K1), separate albedos.

    fan_inputs = (tbn [N,H,W,3,3], view_dir_tangent [N,H,W,3],
    pivots [R,3]).  Returns the dict of rnr_tpu's ray_render_sh (with
    rays_color None: it is never materialised on this path).
    """
    tbn, vdt, pivots = fan_inputs
    r_spec = pivots.shape[0] - num_ray_diffuse
    ltt_specular, ltt_diffuse = sh_shade_fan(
        tbn, vdt, alpha_map, rays_lt, sh_coeff, pivots, sh_lmax, r_spec)
    out_specular = albedo_specular * ltt_specular
    out_diffuse = albedo_diffuse * ltt_diffuse
    return {
        "out": out_specular + out_diffuse,
        "out_specular": out_specular,
        "out_diffuse": out_diffuse,
        "ltt_specular_map": ltt_specular,
        "ltt_diffuse_map": ltt_diffuse,
        "rays_color": None,
        "lp": sh_coeff,
    }
