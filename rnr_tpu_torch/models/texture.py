"""Laplacian-mipmap neural texture (port of rnr_tpu/models/texture.py).

A sample is the sum of bilinear taps at every pyramid level (K2, with K2b
as its backward); 9 of the sampled channels may then be modulated by the
per-pixel SH basis map.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from rnr_tpu_torch.ops.interpolate import resize_bilinear
from rnr_tpu_torch.ops.texture_cuda import mipmap_sample


class TextureMapper(nn.Module):
    """Parameters `texture_{l}` [S_l, S_l, C] (level l has side S/2^l),
    initialised like the JAX module: ones at level 0, 0.01 above, and
    `texture_init` [S, S, C0] (an image) written into channels [0, C0)
    and [C0, 2 C0) of level 0.  `fix_texture` stops the gradient into the
    levels."""

    def __init__(self, texture_size: int, texture_num_ch: int,
                 mipmap_level: int = 4, apply_sh: bool = True,
                 fix_texture: bool = False,
                 texture_init: np.ndarray | None = None):
        super().__init__()
        self.texture_size = texture_size
        self.mipmap_level = mipmap_level
        self.apply_sh = apply_sh
        self.fix_texture = fix_texture
        for level in range(mipmap_level):
            s = self.level_size(level)
            t = torch.ones((s, s, texture_num_ch), dtype=torch.float32)
            if level:
                t = t * 0.01
            elif texture_init is not None:
                ti = torch.as_tensor(np.asarray(texture_init, np.float32))
                c0 = ti.shape[-1]
                t[..., :c0] = ti
                t[..., c0:2 * c0] = ti
            setattr(self, f"texture_{level}", nn.Parameter(t))

    def level_size(self, level: int) -> int:
        return int(np.round(self.texture_size / (2.0 ** level)))

    def levels(self) -> list[torch.Tensor]:
        texs = [getattr(self, f"texture_{l}") for l in range(self.mipmap_level)]
        return [t.detach() for t in texs] if self.fix_texture else texs

    def forward(self, uv_map: torch.Tensor,
                sh_basis_map: torch.Tensor | None = None,
                sh_start_ch: int = 3) -> torch.Tensor:
        """uv_map [N, H, W, 2] in [0, 1], sh_basis_map [N, H, W, 9]
        -> [N, H, W, C]."""
        out = mipmap_sample(self.levels(), uv_map.detach())
        if self.apply_sh and sh_basis_map is not None:
            nb = sh_basis_map.shape[-1]
            mod = out[..., sh_start_ch:sh_start_ch + nb] * sh_basis_map
            out = torch.cat([out[..., :sh_start_ch], mod,
                             out[..., sh_start_ch + nb:]], dim=-1)
        return out

    def flatten_mipmap(self, start_ch: int, end_ch: int) -> torch.Tensor:
        """Every level's channels [start_ch, end_ch) upsampled to level-0
        resolution and summed (the albedo prior's input) -> [S0, S0,
        end_ch - start_ch]."""
        size0 = self.level_size(0)
        out = None
        for level in range(self.mipmap_level):
            t = getattr(self, f"texture_{level}")[..., start_ch:end_ch]
            if level:
                t = resize_bilinear(t, (size0, size0))
            out = t if out is None else out + t
        return out
