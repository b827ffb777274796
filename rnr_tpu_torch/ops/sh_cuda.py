"""SH shading kernels, their plain versions, and the autograd.Functions
that bind them.

K1 / K1b (csrc/sh_fan.cu) replace rnr_tpu/ops/sh_pallas.py::sh_shade_fan
with its custom VJP: the ray fan is built per pixel from TBN + tangent
view direction + pivots in f32, each ray is shaded as coeff^T basis(dir)
* alpha, and rays_lt * radiance is averaged over the specular and the
diffuse fan.  K5 / K5b (csrc/sh_shade.cu) replace sh_pallas.py::sh_shade,
the same shading of a materialised rays_dir [N, H, W, 3, R] (the unfused
configuration, sh_fan_fuse=False); K5 and K5b evaluate K1's scaled ladder
on the same scaled coefficients (fan_coeff), and K5b is K1b's backward
(csrc/sh_bwd.cuh) with the rays read instead of built.
Gradients go to rays_lt (in its own dtype) and to coeff (f32); the rays,
TBN, the view direction, alpha and the pivots are G-buffer data and get
none (rnr_tpu's VJPs return zeros for them).
"""

from __future__ import annotations

import math

import torch

from rnr_tpu_torch.ops import _build
from rnr_tpu_torch.ops.backend import (check_launch, require, stream_of,
                                       use_kernel)
from rnr_tpu_torch.ops.sh import evaluate_sh_basis

MAX_LMAX = 10   # csrc/sh_common.cuh: the kernels instantiate lmax 1..10
MAX_RAYS = 64
# csrc/sh_bwd.cuh FAN_BWD_PIXELS: pixels per K1b / K5b block
FAN_BWD_PIXELS = 64
_FAN_SCALE: dict = {}   # (lmax, device) -> fan_basis_scale as f32


def fan_basis_scale(lmax: int) -> list[float]:
    """Per basis index l*l + l +- m, the factor s(l, m) between the basis
    value and r(l, m) T_m of the scaled ladder (csrc/sh_common.cuh):
    K_m S(l, m), times sqrt 2 for m != 0, where K_m = (1 / sqrt(4 pi))
    prod_{j<=m} sqrt((2j + 1) / 2j) is the diagonal's constant and S(l, m)
    = prod_{m<j<=l} a(j, m) the product of the ladder's a factors
    (ops/sh.py ladder_constants).  In double; rounded to f32 on use."""
    out = [0.0] * (lmax + 1) ** 2
    k_m = 1.0 / math.sqrt(4.0 * math.pi)
    for m in range(lmax + 1):
        if m > 0:
            k_m *= math.sqrt((2.0 * m + 1.0) / (2.0 * m))
        s = k_m * (math.sqrt(2.0) if m > 0 else 1.0)
        for l in range(m, lmax + 1):
            if l > m:
                s *= math.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            out[l * l + l + m] = out[l * l + l - m] = s
    return out


def _fan_scale(lmax: int, device) -> torch.Tensor:
    key = (lmax, device)
    scale = _FAN_SCALE.get(key)
    if scale is None:
        scale = _FAN_SCALE[key] = torch.tensor(
            fan_basis_scale(lmax), dtype=torch.float32, device=device)
    return scale


def fan_coeff(coeff: torch.Tensor, lmax: int) -> torch.Tensor:
    """The coefficients K1, K1b, K5 and K5b fold the ladder into: coeff
    [B, C] times the basis scale of each row, f32, on coeff's device."""
    scale = _fan_scale(lmax, coeff.device)
    return (coeff.to(torch.float32) * scale[:, None]).contiguous()


def fan_bwd_partials(n_pix: int, lmax: int) -> int:
    """Floats of K1b's and K5b's per-block d coeff partials: one row of
    the (lmax+1)^2 * 3 entries per block of FAN_BWD_PIXELS pixels (the C
    entries refuse less: rnr_sh_shade_fan_bwd_partials)."""
    return -(-n_pix // FAN_BWD_PIXELS) * (lmax + 1) ** 2 * 3


def sh_shade_torch(rays_dir, rays_lt, alpha_map, coeff, lmax: int,
                   r_spec: int):
    """Plain version of K5: per ray the basis of rays_dir[..., r] widened
    to f32, the radiance coeff^T basis * alpha, and rays_lt * radiance
    summed into the two means (rnr_tpu's _fwd_kernel :101), in f32."""
    f32 = torch.float32
    r_total = rays_dir.shape[-1]
    cf = coeff.to(f32)
    alpha = alpha_map.to(f32)
    spec = diff = None
    for r in range(r_total):
        basis = evaluate_sh_basis(lmax, rays_dir[..., r].to(f32))
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


def sh_shade_bwd_torch(rays_dir, rays_lt, alpha_map, coeff, gs, gd,
                       lmax: int, r_spec: int):
    """Plain backward of K5, the structure of `_bwd_kernel` (:140): per
    ray the basis again, gsel = (gs / r_spec or gd / r_diff) * alpha,
    d rays_lt = (coeff^T basis) * gsel in rays_lt's dtype, and
    d coeff += basis^T (rays_lt * gsel) in f32."""
    f32 = torch.float32
    r_total = rays_dir.shape[-1]
    r_diff = max(r_total - r_spec, 1)
    cf = coeff.to(f32)
    alpha = alpha_map.to(f32)
    gs, gd = gs.to(f32), gd.to(f32)
    dlt = torch.empty_like(rays_lt)
    dcoeff = torch.zeros_like(cf)
    for r in range(r_total):
        basis = evaluate_sh_basis(lmax, rays_dir[..., r].to(f32))
        rad = torch.einsum("nhwb,bc->nhwc", basis, cf)
        gsel = (gs / r_spec if r < r_spec else gd / r_diff) * alpha
        dlt[..., r, :] = (rad * gsel).to(rays_lt.dtype)
        ltg = rays_lt[..., r, :].to(f32) * gsel
        dcoeff += torch.einsum("nhwb,nhwc->bc", basis, ltg)
    return dlt, dcoeff


def _fan_dirs(tbn, view_dir_tangent, alpha_map, pivots, r_spec):
    from rnr_tpu_torch.models.rays import build_fan_channels

    f32 = torch.float32
    return build_fan_channels(tbn.to(f32), view_dir_tangent.to(f32),
                              alpha_map.to(f32), pivots.to(f32),
                              r_spec)[1]                   # [N, H, W, 3, R]


def sh_shade_fan_torch(tbn, view_dir_tangent, alpha_map, rays_lt, coeff,
                       pivots, lmax: int, r_spec: int):
    """Plain version of K1: build_fan_channels' rays, then K5's plain
    version (rnr_tpu/models/rays.py:353-421), in f32."""
    rays_dir = _fan_dirs(tbn, view_dir_tangent, alpha_map, pivots, r_spec)
    return sh_shade_torch(rays_dir, rays_lt, alpha_map, coeff, lmax, r_spec)


def sh_shade_fan_bwd_torch(tbn, view_dir_tangent, alpha_map, rays_lt, coeff,
                           pivots, gs, gd, lmax: int, r_spec: int):
    """Plain backward of K1, the structure of `_bwd_kernel_fan` (:500):
    the fan's rays, then K5's plain backward."""
    rays_dir = _fan_dirs(tbn, view_dir_tangent, alpha_map, pivots, r_spec)
    return sh_shade_bwd_torch(rays_dir, rays_lt, alpha_map, coeff, gs, gd,
                              lmax, r_spec)


def _check(tbn, view_dir_tangent, alpha_map, rays_lt, coeff, pivots, lmax,
           r_spec):
    """The contiguous f32 operands the kernels take, the coefficients
    scaled (fan_coeff), and the basis scale."""
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
    return tb, vd, al, lt, fan_coeff(cf, lmax), pv, _fan_scale(lmax, lt.device)


def _launch_fwd(tbn, view_dir_tangent, alpha_map, rays_lt, coeff, pivots,
                lmax, r_spec):
    tb, vd, al, lt, cf, pv, _ = _check(
        tbn, view_dir_tangent, alpha_map, rays_lt, coeff, pivots, lmax, r_spec)
    n, h, w, r_total, _ = lt.shape
    spec = torch.empty((n, h, w, 3), dtype=torch.float32, device=lt.device)
    diff = torch.empty_like(spec)
    fn = _build.fn("sh_fan", "rnr_sh_shade_fan", 8, 5)
    sh_shade_fan.launches += 1
    check_launch(fn(tb.data_ptr(), vd.data_ptr(), al.data_ptr(),
                    lt.data_ptr(), cf.data_ptr(), pv.data_ptr(),
                    spec.data_ptr(), diff.data_ptr(), lmax, n * h * w,
                    r_total, r_spec, int(lt.dtype == torch.bfloat16),
                    stream_of(lt)), "sh_shade_fan")
    return spec, diff


def sh_shade_fan_bwd(tbn, view_dir_tangent, alpha_map, rays_lt, coeff,
                     pivots, gs, gd, lmax: int, r_spec: int):
    """K1b: gs, gd [N,H,W,C] -> (d rays_lt in rays_lt's dtype, d coeff
    [B, C] f32); the plain backward on CPU tensors."""
    if not use_kernel(tbn, view_dir_tangent, alpha_map, rays_lt, coeff,
                      pivots, gs, gd):
        return sh_shade_fan_bwd_torch(tbn, view_dir_tangent, alpha_map,
                                      rays_lt, coeff, pivots, gs, gd, lmax,
                                      r_spec)
    tb, vd, al, lt, cf, pv, scale = _check(
        tbn, view_dir_tangent, alpha_map, rays_lt, coeff, pivots, lmax, r_spec)
    n, h, w, r_total, c = lt.shape
    gsf = gs.to(torch.float32).contiguous()
    gdf = gd.to(torch.float32).contiguous()
    require(gsf, "gs", torch.float32, (n, h, w, c))
    require(gdf, "gd", torch.float32, (n, h, w, c))
    n_pix = n * h * w
    dlt = torch.empty_like(lt)
    dcoeff = torch.empty_like(cf)
    part = torch.empty(fan_bwd_partials(n_pix, lmax), dtype=torch.float32,
                       device=lt.device)
    fn = _build.fn("sh_fan", "rnr_sh_shade_fan_bwd", 12, 6)
    sh_shade_fan_bwd.launches += 1
    check_launch(fn(tb.data_ptr(), vd.data_ptr(), al.data_ptr(),
                    lt.data_ptr(), cf.data_ptr(), pv.data_ptr(),
                    scale.data_ptr(), gsf.data_ptr(), gdf.data_ptr(),
                    dlt.data_ptr(), part.data_ptr(), dcoeff.data_ptr(),
                    lmax, n_pix, r_total, r_spec,
                    int(lt.dtype == torch.bfloat16), part.numel(),
                    stream_of(lt)), "sh_shade_fan_bwd")
    return dlt, dcoeff


class ShShadeFanFn(torch.autograd.Function):
    """K1 forward / K1b backward on CUDA tensors, the plain versions on
    CPU tensors.  Differentiable in rays_lt and coeff only."""

    @staticmethod
    def forward(ctx, tbn, view_dir_tangent, alpha_map, rays_lt, coeff,
                pivots, lmax, r_spec):
        ctx.lmax, ctx.r_spec = lmax, r_spec
        ctx.save_for_backward(tbn, view_dir_tangent, alpha_map, rays_lt,
                              coeff, pivots)
        if use_kernel(tbn, view_dir_tangent, alpha_map, rays_lt, coeff,
                      pivots):
            return _launch_fwd(tbn, view_dir_tangent, alpha_map, rays_lt,
                               coeff, pivots, lmax, r_spec)
        return sh_shade_fan_torch(tbn, view_dir_tangent, alpha_map, rays_lt,
                                  coeff, pivots, lmax, r_spec)

    @staticmethod
    def backward(ctx, gs, gd):
        tbn, vdt, alpha, rays_lt, coeff, pivots = ctx.saved_tensors
        dlt, dcoeff = sh_shade_fan_bwd(tbn, vdt, alpha, rays_lt, coeff,
                                       pivots, gs, gd, ctx.lmax, ctx.r_spec)
        # G-buffer inputs and pivots: no gradient (zeros in rnr_tpu)
        return (None, None, None, dlt, dcoeff.to(coeff.dtype), None, None,
                None)


def sh_shade_fan(tbn, view_dir_tangent, alpha_map, rays_lt, coeff, pivots,
                 lmax: int, r_spec: int):
    """tbn [N,H,W,3,3], view_dir_tangent [N,H,W,3], alpha_map [N,H,W,1],
    rays_lt [N,H,W,R,C] (bf16 or f32), coeff [B,C], pivots [R,3]
    -> (ltt_specular, ltt_diffuse) [N,H,W,C] f32, differentiable in
    rays_lt and coeff."""
    return ShShadeFanFn.apply(tbn, view_dir_tangent, alpha_map, rays_lt,
                              coeff, pivots, lmax, r_spec)


sh_shade_fan.launches = 0
sh_shade_fan_bwd.launches = 0


# ------------------------------------------------- K5 / K5b: materialised rays


def _check_rays(rays_dir, rays_lt, alpha_map, coeff, lmax, r_spec):
    """The contiguous operands K5 / K5b take: rays_dir and rays_lt in one
    storage type (bf16 or f32), alpha f32, and the scaled coefficients
    (fan_coeff)."""
    n, h, w, r_total, c = rays_lt.shape
    if not 1 <= lmax <= MAX_LMAX:
        raise ValueError(f"sh_shade kernel: lmax {lmax} not in 1..{MAX_LMAX}")
    if c != 3 or r_total > MAX_RAYS or not 1 <= r_spec <= r_total:
        raise ValueError(f"sh_shade kernel: C={c}, R={r_total}, "
                         f"r_spec={r_spec} unsupported")
    f32 = torch.float32
    lt = rays_lt.contiguous()
    if lt.dtype not in (torch.bfloat16, f32):
        raise TypeError(f"rays_lt: dtype {lt.dtype}, kernel takes bf16 or f32")
    rd = rays_dir.contiguous()
    al = alpha_map.to(f32).contiguous()
    cf = coeff.to(f32).contiguous()
    require(rd, "rays_dir", lt.dtype, (n, h, w, 3, r_total))
    require(al, "alpha_map", f32, (n, h, w, 1))
    require(cf, "coeff", f32, ((lmax + 1) ** 2, 3))
    return rd, lt, al, fan_coeff(cf, lmax)


def _launch_shade(rays_dir, rays_lt, alpha_map, coeff, lmax, r_spec):
    rd, lt, al, cfs = _check_rays(rays_dir, rays_lt, alpha_map, coeff, lmax,
                                  r_spec)
    n, h, w, r_total, _ = lt.shape
    spec = torch.empty((n, h, w, 3), dtype=torch.float32, device=lt.device)
    diff = torch.empty_like(spec)
    fn = _build.fn("sh_shade", "rnr_sh_shade", 6, 5)
    sh_shade.launches += 1
    check_launch(fn(rd.data_ptr(), al.data_ptr(), lt.data_ptr(),
                    cfs.data_ptr(), spec.data_ptr(), diff.data_ptr(), lmax,
                    n * h * w, r_total, r_spec,
                    int(lt.dtype == torch.bfloat16), stream_of(lt)),
                 "sh_shade")
    return spec, diff


def sh_shade_bwd(rays_dir, rays_lt, alpha_map, coeff, gs, gd, lmax: int,
                 r_spec: int):
    """K5b: gs, gd [N,H,W,C] -> (d rays_lt in rays_lt's dtype, d coeff
    [B, C] f32); the plain backward on CPU tensors."""
    if not use_kernel(rays_dir, rays_lt, alpha_map, coeff, gs, gd):
        return sh_shade_bwd_torch(rays_dir, rays_lt, alpha_map, coeff, gs,
                                  gd, lmax, r_spec)
    rd, lt, al, cfs = _check_rays(rays_dir, rays_lt, alpha_map, coeff, lmax,
                                  r_spec)
    n, h, w, r_total, c = lt.shape
    gsf = gs.to(torch.float32).contiguous()
    gdf = gd.to(torch.float32).contiguous()
    require(gsf, "gs", torch.float32, (n, h, w, c))
    require(gdf, "gd", torch.float32, (n, h, w, c))
    n_pix = n * h * w
    dlt = torch.empty_like(lt)
    dcoeff = torch.empty_like(cfs)
    part = torch.empty(fan_bwd_partials(n_pix, lmax), dtype=torch.float32,
                       device=lt.device)
    scale = _fan_scale(lmax, lt.device)
    fn = _build.fn("sh_shade", "rnr_sh_shade_bwd", 10, 6)
    sh_shade_bwd.launches += 1
    check_launch(fn(rd.data_ptr(), al.data_ptr(), lt.data_ptr(),
                    cfs.data_ptr(), scale.data_ptr(), gsf.data_ptr(),
                    gdf.data_ptr(), dlt.data_ptr(), part.data_ptr(),
                    dcoeff.data_ptr(), lmax, n_pix, r_total, r_spec,
                    int(lt.dtype == torch.bfloat16), part.numel(),
                    stream_of(lt)), "sh_shade_bwd")
    return dlt, dcoeff


class ShShadeFn(torch.autograd.Function):
    """K5 forward / K5b backward on CUDA tensors, the plain versions on
    CPU tensors.  Differentiable in rays_lt and coeff only."""

    @staticmethod
    def forward(ctx, rays_dir, rays_lt, alpha_map, coeff, lmax, r_spec):
        ctx.lmax, ctx.r_spec = lmax, r_spec
        ctx.save_for_backward(rays_dir, rays_lt, alpha_map, coeff)
        if use_kernel(rays_dir, rays_lt, alpha_map, coeff):
            return _launch_shade(rays_dir, rays_lt, alpha_map, coeff, lmax,
                                 r_spec)
        return sh_shade_torch(rays_dir, rays_lt, alpha_map, coeff, lmax,
                              r_spec)

    @staticmethod
    def backward(ctx, gs, gd):
        rays_dir, rays_lt, alpha, coeff = ctx.saved_tensors
        dlt, dcoeff = sh_shade_bwd(rays_dir, rays_lt, alpha, coeff, gs, gd,
                                   ctx.lmax, ctx.r_spec)
        # rays_dir and alpha: no gradient (zeros in rnr_tpu)
        return None, dlt, None, dcoeff.to(coeff.dtype), None, None


def sh_shade(rays_dir, rays_lt, alpha_map, coeff, lmax: int, r_spec: int):
    """rays_dir [N,H,W,3,R] and rays_lt [N,H,W,R,C] (one dtype, bf16 or
    f32), alpha_map [N,H,W,1], coeff [B,C] -> (ltt_specular, ltt_diffuse)
    [N,H,W,C] f32, differentiable in rays_lt and coeff."""
    return ShShadeFn.apply(rays_dir, rays_lt, alpha_map, coeff, lmax, r_spec)


sh_shade.launches = 0
sh_shade_bwd.launches = 0
