"""SH lighting (port of rnr_tpu/models/lighting.py: LightingSH without the
probe grid).

The learned coefficients of each lighting, and the light samples they
give at the sphere sample directions `l_dir` (what the lighting loss
compares with the stitched probe).  The probe reconstruction grid
(`basis_val_recon`, `reconstruct_lp`) belongs to the light-probe path and
is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from rnr_tpu_torch.ops.sh import evaluate_sh_basis, reconstruct_sh


def fib_sphere(n: int) -> np.ndarray:
    """[3, n] Fibonacci-sphere directions (the synthetic sample set)."""
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    return np.stack([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
                     np.cos(phi)]).astype(np.float32)


class LightingSH(nn.Module):
    """`coeff` [L, (lmax+1)^2, C], initialised to zeros as in rnr_tpu;
    buffers `l_dir` [3, S] and `basis_val` [S, (lmax+1)^2], the basis at
    the sample directions (rnr_tpu's constants/lighting/basis_val).
    `fix_params` stops the gradient into the coefficients."""

    def __init__(self, l_dir: np.ndarray, lmax: int = 10,
                 num_lighting: int = 1, num_channel: int = 3,
                 fix_params: bool = False):
        super().__init__()
        self.lmax = lmax
        self.fix_params = fix_params
        l_dir = torch.as_tensor(np.asarray(l_dir, np.float32))
        self.register_buffer("l_dir", l_dir)
        self.register_buffer("basis_val", evaluate_sh_basis(lmax, l_dir.T))
        self.coeff = nn.Parameter(
            torch.zeros((num_lighting, (lmax + 1) ** 2, num_channel)))

    def _coeff(self) -> torch.Tensor:
        return self.coeff.detach() if self.fix_params else self.coeff

    def forward(self, lighting_idx: int | None = None) -> torch.Tensor:
        """The light samples at `l_dir`: [1, S, C] for one lighting,
        [1, L, S, C] for all."""
        coeff = self._coeff()
        if lighting_idx is not None:
            coeff = coeff[lighting_idx]
        return reconstruct_sh(coeff, self.basis_val)[None]

    def get_lighting_params(self, lighting_idx: int) -> torch.Tensor:
        return self._coeff()[lighting_idx]
