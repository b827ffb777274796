"""Environment lighting: spherical harmonics and raw light probes (port of
rnr_tpu/models/lighting.py).

`LightingSH` holds the learned coefficients of each lighting; it gives
the light samples at the sphere sample directions `l_dir` (what the
lighting loss compares with the stitched probe) or, with `is_lp`, the
equirect probe reconstructed on a `lp_recon_h` x `lp_recon_w` grid (what
the probe-gather render reads).  `LightingLP` holds raw light samples,
initialised from probe images, and projects them onto SH (`fit_sh`):
the novel-light relighting of the inference driver.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from rnr_tpu_torch.ops.backend import resolve_device
from rnr_tpu_torch.ops.interpolate import interpolate_bilinear
from rnr_tpu_torch.ops.sh import evaluate_sh_basis, fit_sh_coeff, reconstruct_sh
from rnr_tpu_torch.ops.spherical import spherical_mapping, spherical_mapping_inv


def fib_sphere(n: int) -> np.ndarray:
    """[3, n] Fibonacci-sphere directions (the synthetic sample set)."""
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    return np.stack([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
                     np.cos(phi)]).astype(np.float32)


def _recon_grid_dirs(h: int, w: int) -> torch.Tensor:
    """[H*W, 3] unit directions of the equirect reconstruction grid, u and
    v each from 0 to 1 inclusive (row-major, v down the rows)."""
    v = torch.arange(h, dtype=torch.float32) / (h - 1)
    u = torch.arange(w, dtype=torch.float32) / (w - 1)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    uv = torch.stack([uu.reshape(-1), vv.reshape(-1)], dim=0)
    return spherical_mapping_inv(uv).T


class LightingSH(nn.Module):
    """`coeff` [L, (lmax+1)^2, C], zeros or `init_coeff` ([B, C] for every
    lighting, or [L, B, C]); buffers `l_dir` [3, S], `basis_val` [S, B]
    (the basis at the sample directions) and `basis_val_recon`
    [lp_recon_h * lp_recon_w, B] (the basis on the probe grid).
    `fix_params` stops the gradient into the coefficients."""

    def __init__(self, l_dir: np.ndarray, lmax: int = 10,
                 num_lighting: int = 1, num_channel: int = 3,
                 fix_params: bool = False, lp_recon_h: int = 100,
                 lp_recon_w: int = 200, init_coeff: np.ndarray | None = None):
        super().__init__()
        self.lmax = lmax
        self.fix_params = fix_params
        self.lp_recon_h, self.lp_recon_w = lp_recon_h, lp_recon_w
        l_dir = torch.as_tensor(np.asarray(l_dir, np.float32))
        self.register_buffer("l_dir", l_dir)
        self.register_buffer("basis_val", evaluate_sh_basis(lmax, l_dir.T))
        self.register_buffer("basis_val_recon", evaluate_sh_basis(
            lmax, _recon_grid_dirs(lp_recon_h, lp_recon_w)))
        nb = (lmax + 1) ** 2
        if init_coeff is None:
            coeff = torch.zeros((num_lighting, nb, num_channel))
        else:
            coeff = torch.as_tensor(np.asarray(init_coeff, np.float32))
            if coeff.ndim == 2:
                coeff = coeff[None].expand(num_lighting, *coeff.shape)
            coeff = coeff.clone()
        self.coeff = nn.Parameter(coeff)

    def _coeff(self) -> torch.Tensor:
        return self.coeff.detach() if self.fix_params else self.coeff

    def forward(self, lighting_idx: int | None = None,
                coeff: torch.Tensor | None = None,
                is_lp: bool = False) -> torch.Tensor:
        """The light samples at `l_dir`, [1, S, C] for one lighting and
        [1, L, S, C] for all, or with `is_lp` the probes, [1, H, W, C] /
        [1, L, H, W, C]; from `coeff` [B, C] / [L, B, C] when given."""
        if coeff is None:
            coeff = self._coeff()
            if lighting_idx is not None:
                coeff = coeff[lighting_idx]
        if is_lp:
            return self.reconstruct_lp(coeff)[None]
        return reconstruct_sh(coeff, self.basis_val)[None]

    def reconstruct_lp(self, coeff: torch.Tensor) -> torch.Tensor:
        """[B, C] or [L, B, C] -> [H, W, C] or [L, H, W, C] probe."""
        flat = reconstruct_sh(coeff, self.basis_val_recon)
        return flat.reshape(flat.shape[:-2] + (self.lp_recon_h,
                                               self.lp_recon_w,
                                               flat.shape[-1]))

    def get_lighting_params(self, lighting_idx: int) -> torch.Tensor:
        return self._coeff()[lighting_idx]


def normalize_lighting_coeff(coeff: torch.Tensor, ref_idx: int
                             ) -> torch.Tensor:
    """Rescale every lighting's coefficients [L, B, C] to the Frobenius
    norm of lighting `ref_idx`'s (which stays as it is)."""
    ref_norm = torch.linalg.vector_norm(coeff[ref_idx])
    norms = torch.sqrt(torch.sum(coeff * coeff, dim=(1, 2)))
    scale = ref_norm / torch.clamp(norms, min=1e-12)
    scale = torch.where(torch.arange(coeff.shape[0], device=coeff.device)
                        == ref_idx, torch.ones_like(scale), scale)
    return coeff * scale[:, None, None]


class LightingLP(nn.Module):
    """Raw per-sample light values `l_samples` [L, S, C]: zeros, or with
    `lps` [L, H, W, C] (equirect probes) each probe's bilinear value at
    `spherical_mapping(l_dir)`, the probes then kept as the `lps`
    buffer.  Built on `device` (the current CUDA device when None)."""

    def __init__(self, l_dir: np.ndarray, num_lighting: int = 1,
                 num_channel: int = 3, lps: np.ndarray | None = None,
                 fix_params: bool = False, device=None):
        super().__init__()
        device = resolve_device(device)
        self.fix_params = fix_params
        dirs = torch.as_tensor(np.asarray(l_dir, np.float32), device=device)
        self.register_buffer("l_dir", dirs)
        if lps is None:
            self.lps = None
            samples = torch.zeros((num_lighting, dirs.shape[1], num_channel),
                                  device=device)
        else:
            probes = torch.as_tensor(np.asarray(lps, np.float32),
                                     device=device)
            self.register_buffer("lps", probes)
            uv = spherical_mapping(dirs)                     # [2, S]
            h, w = probes.shape[1], probes.shape[2]
            x = torch.clamp(uv[0] * w, max=w - 1)
            y = torch.clamp(uv[1] * h, max=h - 1)
            samples = torch.stack([interpolate_bilinear(p, x, y)
                                   for p in probes])
        self.l_samples = nn.Parameter(samples)

    def forward(self, lighting_idx: int | None = None,
                is_lp: bool = False) -> torch.Tensor:
        """The samples [1, S, C] of one lighting or [1, L, S, C] of all;
        with `is_lp` the stored probes, [1, H, W, C] / [1, L, H, W, C]."""
        if is_lp:
            if self.lps is None:
                raise ValueError("no light probes stored")
            lps = self.lps
        else:
            lps = (self.l_samples.detach() if self.fix_params
                   else self.l_samples)
        return lps[None] if lighting_idx is None else lps[lighting_idx][None]

    def fit_sh(self, lmax: int) -> torch.Tensor:
        """The samples projected onto SH up to `lmax`: [L, B, C]."""
        basis = evaluate_sh_basis(lmax, self.l_dir.T)
        return fit_sh_coeff(self.l_samples, basis)
