"""K1: fan-fused SH shading forward (csrc/sh_fan.cu) and its twin.

Replaces rnr_tpu/ops/sh_pallas.py::sh_shade_fan (forward): the ray fan is
built per pixel from TBN + tangent view direction + pivots in f32, each
ray is shaded as coeff^T basis(dir) * alpha, and rays_lt * radiance is
averaged over the specular and the diffuse fan.
"""

from __future__ import annotations

import torch

from rnr_tpu_torch.ops import _build
from rnr_tpu_torch.ops.backend import (check_launch, require, stream_of,
                                       use_kernel)
from rnr_tpu_torch.ops.sh import evaluate_sh_basis, ladder_constants

MAX_LMAX = 10   # csrc/sh_fan.cu instantiates lmax 1..10
MAX_RAYS = 64
_LADDER: dict = {}   # (lmax, device) -> the kernel's ladder constants


def sh_shade_fan_torch(tbn, view_dir_tangent, alpha_map, rays_lt, coeff,
                       pivots, lmax: int, r_spec: int):
    """Plain twin: build_fan_channels + evaluate_sh_basis + the per-ray
    radiance and the two means (rnr_tpu/models/rays.py:353-421), in f32."""
    from rnr_tpu_torch.models.rays import build_fan_channels

    f32 = torch.float32
    _, rays_dir = build_fan_channels(
        tbn.to(f32), view_dir_tangent.to(f32), alpha_map.to(f32),
        pivots.to(f32), r_spec)                       # [N, H, W, 3, R]
    r_total = rays_dir.shape[-1]
    cf = coeff.to(f32)
    alpha = alpha_map.to(f32)
    spec = diff = None
    for r in range(r_total):
        basis = evaluate_sh_basis(lmax, rays_dir[..., r])
        color = torch.einsum("nhwb,bc->nhwc", basis, cf) * alpha
        contrib = rays_lt[..., r, :].to(f32) * color
        if r < r_spec:
            spec = contrib if spec is None else spec + contrib
        else:
            diff = contrib if diff is None else diff + contrib
    spec = spec / r_spec
    diff = (diff / (r_total - r_spec) if diff is not None
            else torch.zeros_like(spec))
    return spec, diff


def sh_shade_fan(tbn, view_dir_tangent, alpha_map, rays_lt, coeff, pivots,
                 lmax: int, r_spec: int):
    """tbn [N,H,W,3,3], view_dir_tangent [N,H,W,3], alpha_map [N,H,W,1],
    rays_lt [N,H,W,R,C] (bf16 or f32), coeff [B,C], pivots [R,3]
    -> (ltt_specular, ltt_diffuse) [N,H,W,C] f32."""
    if not use_kernel(tbn, view_dir_tangent, alpha_map, rays_lt, coeff,
                      pivots):
        return sh_shade_fan_torch(tbn, view_dir_tangent, alpha_map, rays_lt,
                                  coeff, pivots, lmax, r_spec)
    n, h, w, r_total, c = rays_lt.shape
    if not 1 <= lmax <= MAX_LMAX:
        raise ValueError(f"sh_shade_fan kernel: lmax {lmax} not in 1..{MAX_LMAX}")
    if c != 3 or r_total > MAX_RAYS or not 1 <= r_spec <= r_total:
        raise ValueError(f"sh_shade_fan kernel: C={c}, R={r_total}, "
                         f"r_spec={r_spec} unsupported")
    f32 = torch.float32
    tb = tbn.to(f32).contiguous()
    vd = view_dir_tangent.to(f32).contiguous()
    al = alpha_map.to(f32).contiguous()
    cf = coeff.to(f32).contiguous()
    pv = pivots.to(f32).contiguous()
    lt = rays_lt.contiguous()
    require(tb, "tbn", f32, (n, h, w, 3, 3))
    require(vd, "view_dir_tangent", f32, (n, h, w, 3))
    require(al, "alpha_map", f32, (n, h, w, 1))
    require(cf, "coeff", f32, ((lmax + 1) ** 2, 3))
    require(pv, "pivots", f32, (r_total, 3))
    if lt.dtype not in (torch.bfloat16, f32):
        raise TypeError(f"rays_lt: dtype {lt.dtype}, kernel takes bf16 or f32")
    key = (lmax, lt.device)
    ladder = _LADDER.get(key)
    if ladder is None:
        ladder = _LADDER[key] = torch.tensor(
            ladder_constants(lmax), dtype=f32, device=lt.device)
    spec = torch.empty((n, h, w, 3), dtype=f32, device=lt.device)
    diff = torch.empty_like(spec)
    fn = _build.fn("sh_fan", "rnr_sh_shade_fan", 9, 6)
    sh_shade_fan.launches += 1
    check_launch(fn(tb.data_ptr(), vd.data_ptr(), al.data_ptr(),
                    lt.data_ptr(), cf.data_ptr(), pv.data_ptr(),
                    ladder.data_ptr(), spec.data_ptr(), diff.data_ptr(),
                    lmax, ladder.numel(), n * h * w, r_total, r_spec,
                    int(lt.dtype == torch.bfloat16), stream_of(lt)),
                 "sh_shade_fan")
    return spec, diff


sh_shade_fan.launches = 0
