"""Ray fans and ray composition (port of rnr_tpu/models/rays.py).

Channels-last throughout: per-pixel rays are [..., 3, R] (xyz by ray),
light transport [N, H, W, R, C].  Two compositions: `ray_render` gathers
each ray's colour from an equirect light probe, `ray_render_sh` shades
each ray from SH coefficients (K1 with the fan built in the kernel, K5 on
a materialised rays_dir).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rnr_tpu_torch.ops.cameras import euler_to_rot, get_reflect_dir
from rnr_tpu_torch.ops.interpolate import interpolate_bilinear_batch
from rnr_tpu_torch.ops.sh_cuda import sh_shade, sh_shade_fan
from rnr_tpu_torch.ops.spherical import spherical_mapping_batch


@dataclasses.dataclass
class RaySampler:
    """Fixed fan of ray pivots around the tangent-space normal.

    num_ray = num_azi * num_polar + 1 (the +1 is the identity pivot);
    `pivots_dir` is [3, num_ray].  mode "reflect" reflects each pixel's
    tangent-space view direction about each pivot (the specular fan),
    "diffuse" uses the pivots as they are.
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
        self._pivots: dict = {}     # device -> pivots_dir as f32

    def __call__(self, tbn_matrices: torch.Tensor,
                 view_dir_tangent: torch.Tensor, alpha_map: torch.Tensor,
                 with_uv: bool = True):
        """tbn_matrices [N, ..., 3, 3], view_dir_tangent [N, ..., 3],
        alpha_map [N, ..., 1] -> (rays_dir [N, ..., 3, R] world-space
        unit rays; rays_uv [N, ..., 2, R] equirect probe UVs, -1 at masked
        pixels, or None without `with_uv`; rays_dir_tangent, [N, ..., 3, R]
        or, diffuse, [3, R])."""
        dev = tbn_matrices.device
        pivots = self._pivots.get(dev)
        if pivots is None:
            pivots = self._pivots[dev] = torch.as_tensor(
                self.pivots_dir, dtype=torch.float32, device=dev)
        if self.mode == "reflect":
            rays_dir_tangent = (get_reflect_dir(view_dir_tangent[..., None],
                                                pivots, axis=-2)
                                * alpha_map[..., None])
            rays_dir = torch.einsum("...ij,...jr->...ir", tbn_matrices,
                                    rays_dir_tangent)
        else:
            rays_dir_tangent = pivots
            rays_dir = torch.einsum("...ij,jr->...ir", tbn_matrices, pivots)
        rays_dir = rays_dir / torch.clamp(torch.linalg.vector_norm(
            rays_dir, dim=-2, keepdim=True), min=1e-12)
        if not with_uv:
            return rays_dir, None, rays_dir_tangent
        # the batch mapping takes xyz on axis 1
        uv = spherical_mapping_batch(torch.movedim(rays_dir, -2, 1))
        rays_uv = torch.movedim(uv, 1, -2)                  # [N, ..., 2, R]
        masked = (alpha_map[..., None] == 0).to(rays_uv.dtype)
        rays_uv = rays_uv * alpha_map[..., None] - masked
        return rays_dir, rays_uv, rays_dir_tangent


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
                       img: torch.Tensor | None = None,
                       n_alpha: torch.Tensor | None = None):
    """White-light-transport chromaticity prior (rnr_tpu/models/rays.py:199).

    rays_lt [N, H, W, R, C] (f32 math even when stored bf16), alpha_map
    [N, H, W, 1], img optional [N, H, W, C] intensity weighting.  Both
    normalisations use rsqrt(sq + 1e-20), finite with a finite gradient at
    rays_lt = 0 (where a norm's gradient is NaN).  The masked sum is
    divided by `n_alpha` (the global batch's alpha sum under data
    parallelism), else by alpha_map's sum.
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
    if n_alpha is None:
        n_alpha = torch.sum(alpha_map)
    loss = torch.sum(diff) / torch.clamp(n_alpha, min=1.0) / rays_lt.shape[-2]
    return loss, chrom, chrom_mean, diff


def _compose(albedo_specular, albedo_diffuse, ltt_specular, ltt_diffuse,
             num_ray_diffuse: int, no_albedo: bool, separate_albedo: bool):
    """(out_specular, out_diffuse) of rnr_tpu's compositions."""
    out_specular = ltt_specular if no_albedo else albedo_specular * ltt_specular
    if num_ray_diffuse == 0:
        return out_specular, torch.zeros_like(out_specular)
    if no_albedo:
        return out_specular, ltt_diffuse
    if separate_albedo:
        if albedo_diffuse is None:
            raise ValueError("separate_albedo requires albedo_diffuse")
        return out_specular, albedo_diffuse * ltt_diffuse
    return out_specular, albedo_specular * ltt_diffuse


def ray_render(albedo_specular, rays_uv, rays_lt, lp, num_ray_diffuse: int = 0,
               albedo_diffuse=None, no_albedo: bool = False,
               separate_albedo: bool = False, lp_scale_factor: float = 1.0):
    """Compose the image from per-ray light transport and a light probe.

    albedo_specular [N, H, W, C], rays_uv [N, H, W, 2, R] (-1 at masked
    pixels), rays_lt [N, H, W, R, C], lp [N or 1, Hl, Wl, C] (equirect);
    the last `num_ray_diffuse` rays are the diffuse fan.  Each ray's
    colour is the probe's bilinear value at its uv (masked rays give 0;
    u and v clipped from above only), and rays_lt * colour is averaged
    over each fan.  Its backward is a scatter-add into the probe.
    Returns dict(out, out_specular, out_diffuse, ltt_specular_map,
    ltt_diffuse_map, rays_color, lp).
    """
    r_total = rays_uv.shape[-1]
    r_spec = r_total - num_ray_diffuse
    lp = lp * lp_scale_factor
    hl, wl = lp.shape[1], lp.shape[2]
    x = torch.clamp(rays_uv[..., 0, :] * wl, max=wl - 1)
    y = torch.clamp(rays_uv[..., 1, :] * hl, max=hl - 1)
    rays_color = interpolate_bilinear_batch(lp, x, y)     # [N, H, W, R, C]
    ltt_specular = torch.sum(rays_lt[..., :r_spec, :]
                             * rays_color[..., :r_spec, :], dim=-2) / r_spec
    if num_ray_diffuse > 0:
        ltt_diffuse = torch.sum(rays_lt[..., r_spec:, :]
                                * rays_color[..., r_spec:, :],
                                dim=-2) / num_ray_diffuse
    else:
        ltt_diffuse = torch.zeros_like(ltt_specular)
    out_specular, out_diffuse = _compose(
        albedo_specular, albedo_diffuse, ltt_specular, ltt_diffuse,
        num_ray_diffuse, no_albedo, separate_albedo)
    return {
        "out": out_specular + out_diffuse,
        "out_specular": out_specular,
        "out_diffuse": out_diffuse,
        "ltt_specular_map": ltt_specular,
        "ltt_diffuse_map": ltt_diffuse,
        "rays_color": rays_color,
        "lp": lp,
    }


class RayRenderer:
    """`ray_render` with a lighting model that supplies the probe when
    `lp` is not given: lighting_apply(lighting_idx, is_lp=True) ->
    [1, H, W, C]."""

    def __init__(self, lighting_apply):
        self.lighting_apply = lighting_apply

    def __call__(self, albedo_specular, rays_uv, rays_lt, lighting_idx=None,
                 lp=None, **kw):
        if lp is None:
            lp = self.lighting_apply(lighting_idx, is_lp=True)
        return ray_render(albedo_specular, rays_uv, rays_lt, lp, **kw)


def ray_render_sh(albedo_specular, rays_dir, alpha_map, rays_lt, sh_coeff,
                  sh_lmax: int, num_ray_diffuse: int, albedo_diffuse,
                  fan_inputs=None):
    """SH-direct composition with separate albedos: each ray shaded as
    coeff^T basis(dir) * alpha.

    With fan_inputs = (tbn [N,H,W,3,3], view_dir_tangent [N,H,W,3],
    pivots [R,3]) the kernel builds the ray fan itself and never reads
    rays_dir (K1, the fan-fused configuration); without, it shades the
    materialised rays_dir [N,H,W,3,R] (K5, sh_fan_fuse=False).  Returns
    the dict of rnr_tpu's ray_render_sh, with rays_color None: neither
    kernel materialises it.
    """
    r_spec = rays_dir.shape[-1] - num_ray_diffuse
    if fan_inputs is not None:
        tbn, vdt, pivots = fan_inputs
        ltt_specular, ltt_diffuse = sh_shade_fan(
            tbn, vdt, alpha_map, rays_lt, sh_coeff, pivots, sh_lmax, r_spec)
    else:
        ltt_specular, ltt_diffuse = sh_shade(
            rays_dir, rays_lt, alpha_map, sh_coeff, sh_lmax, r_spec)
    out_specular, out_diffuse = _compose(
        albedo_specular, albedo_diffuse, ltt_specular, ltt_diffuse,
        num_ray_diffuse, False, True)
    return {
        "out": out_specular + out_diffuse,
        "out_specular": out_specular,
        "out_diffuse": out_diffuse,
        "ltt_specular_map": ltt_specular,
        "ltt_diffuse_map": ltt_diffuse,
        "rays_color": None,
        "lp": sh_coeff,
    }
