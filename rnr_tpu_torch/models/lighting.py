"""SH lighting, the part serving uses (port of rnr_tpu/models/lighting.py).

Serving reads only the learned coefficients of one lighting; the sphere
sample reconstruction (`l_samples`) and the probe grid are not needed per
frame and are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn


class LightingSH(nn.Module):
    """`coeff` [L, (lmax+1)^2, C], initialised to zeros as in rnr_tpu."""

    def __init__(self, lmax: int = 10, num_lighting: int = 1,
                 num_channel: int = 3):
        super().__init__()
        self.lmax = lmax
        self.coeff = nn.Parameter(
            torch.zeros((num_lighting, (lmax + 1) ** 2, num_channel)))

    def get_lighting_params(self, lighting_idx: int) -> torch.Tensor:
        return self.coeff[lighting_idx]
