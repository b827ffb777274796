"""Bilinear gather (port of rnr_tpu/ops/interpolate.py).

Coordinates are in texel units; samples outside [0, W-1] x [0, H-1] are
exactly zero, corner indices are clamped, and at the right/bottom edge the
weight anchor shifts one texel back so that sampling exactly at the last
texel returns that texel.
"""

from __future__ import annotations

import torch


def interpolate_bilinear(data: torch.Tensor, x: torch.Tensor,
                         y: torch.Tensor) -> torch.Tensor:
    """data [H, W, C], x/y [...] -> [..., C]."""
    h, w = data.shape[0], data.shape[1]
    dtype = data.dtype
    x = x.to(dtype)
    y = y.to(dtype)

    valid = ((x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)).to(dtype)

    # clamp before the int conversion so it is defined for any finite x
    x0 = torch.clamp(torch.floor(x.clamp(-1, w)).to(torch.int64), 0, w - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y0 = torch.clamp(torch.floor(y.clamp(-1, h)).to(torch.int64), 0, h - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)

    flat = data.reshape(h * w, -1)
    i00 = flat[y0 * w + x0]
    i10 = flat[y1 * w + x0]
    i01 = flat[y0 * w + x1]
    i11 = flat[y1 * w + x1]

    x0w = (x0 - (x0 == x1).to(x0.dtype)).to(dtype)
    y0w = (y0 - (y0 == y1).to(y0.dtype)).to(dtype)
    x1w = x1.to(dtype)
    y1w = y1.to(dtype)

    w00 = (x1w - x) * (y1w - y) * valid
    w10 = (x1w - x) * (y - y0w) * valid
    w01 = (x - x0w) * (y1w - y) * valid
    w11 = (x - x0w) * (y - y0w) * valid

    return (i00 * w00[..., None] + i10 * w10[..., None]
            + i01 * w01[..., None] + i11 * w11[..., None])
