"""Closed-form real spherical harmonics (port of rnr_tpu/ops/sh.py).

Convention (pyshtools csphase=1 / 'ortho'): orthonormal over the sphere,
no Condon-Shortley phase, m > 0 -> cos(m phi), m < 0 -> sin(|m| phi),
flattened index l*l + l + m.  theta is the colatitude from +z.
"""

from __future__ import annotations

import math

import torch


def num_sh_basis(lmax: int) -> int:
    return (lmax + 1) ** 2


def ladder_constants(lmax: int) -> list[float]:
    """The ladder's scalar factors in the order the CUDA kernel reads them
    (csrc/sh_fan.cu): per m, the diagonal step (m > 0), the off-diagonal
    step (m < lmax), then (a, b) for l = m+2..lmax.  Computed in double
    and rounded to f32 on use, as the JAX ladder's Python floats are."""
    out = []
    for m in range(lmax + 1):
        if m > 0:
            out.append(math.sqrt((2.0 * m + 1.0) / (2.0 * m)))
        if m < lmax:
            out.append(math.sqrt(2.0 * m + 3.0))
            for l in range(m + 2, lmax + 1):
                out.append(math.sqrt((4.0 * l * l - 1.0) / (l * l - m * m)))
                out.append(math.sqrt(((l - 1.0) ** 2 - m * m)
                                     / (4.0 * (l - 1.0) ** 2 - 1.0)))
    return out


def evaluate_sh_basis(lmax: int, directions: torch.Tensor) -> torch.Tensor:
    """[..., 3] unit vectors -> [..., (lmax+1)^2] basis values."""
    x = directions[..., 0]
    y = directions[..., 1]
    z = directions[..., 2]
    ct = torch.clamp(z, -1.0, 1.0)
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))

    inv_sqrt_4pi = 1.0 / math.sqrt(4.0 * math.pi)
    q: list[dict[int, torch.Tensor]] = [dict() for _ in range(lmax + 1)]
    q[0][0] = torch.full_like(ct, inv_sqrt_4pi)
    for m in range(1, lmax + 1):
        q[m][m] = math.sqrt((2.0 * m + 1.0) / (2.0 * m)) * st * q[m - 1][m - 1]
    for m in range(0, lmax):
        q[m][m + 1] = math.sqrt(2.0 * m + 3.0) * ct * q[m][m]
    for m in range(0, lmax + 1):
        for l in range(m + 2, lmax + 1):
            a = math.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b = math.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
            q[m][l] = a * (ct * q[m][l - 1] - b * q[m][l - 2])

    # azimuth by angle addition on (x, y) / hypot(x, y); (1, 0) at the
    # poles, where every m > 0 term carries st^m = 0 anyway
    sqrt2 = math.sqrt(2.0)
    r2 = x * x + y * y
    pos = r2 > 0
    inv_rxy = torch.where(pos, torch.rsqrt(torch.where(pos, r2, 1.0)), 0.0)
    c1 = torch.where(pos, x * inv_rxy, 1.0)
    s1 = y * inv_rxy
    cos_m: list = [None] * (lmax + 1)
    sin_m: list = [None] * (lmax + 1)
    if lmax >= 1:
        cos_m[1], sin_m[1] = c1, s1
    for m in range(2, lmax + 1):
        cos_m[m] = cos_m[m - 1] * c1 - sin_m[m - 1] * s1
        sin_m[m] = sin_m[m - 1] * c1 + cos_m[m - 1] * s1

    out = []
    for l in range(lmax + 1):
        for m in range(-l, l + 1):
            if m == 0:
                out.append(q[0][l])
            elif m > 0:
                out.append(sqrt2 * q[m][l] * cos_m[m])
            else:
                out.append(sqrt2 * q[-m][l] * sin_m[-m])
    return torch.stack(out, dim=-1)


def fit_sh_coeff(samples: torch.Tensor, sh_basis_val: torch.Tensor
                 ) -> torch.Tensor:
    """Monte-Carlo projection of sphere samples onto the basis: samples
    [S, C] or [L, S, C] at [S, B] basis values -> [B, C] / [L, B, C],
    with the weight 4 pi / S of samples uniform on the sphere."""
    weight = 4.0 * math.pi / samples.shape[-2]
    return torch.einsum("...sc,sb->...bc", samples, sh_basis_val) * weight


def reconstruct_sh(sh_coeff: torch.Tensor, sh_basis_val: torch.Tensor) -> torch.Tensor:
    """[B, C] or [L, B, C] coefficients at [S, B] basis -> [S, C] / [L, S, C]."""
    return torch.einsum("sb,...bc->...sc", sh_basis_val, sh_coeff)
