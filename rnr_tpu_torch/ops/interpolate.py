"""Bilinear gather and resize (port of rnr_tpu/ops/interpolate.py).

Coordinates are in texel units; samples outside [0, W-1] x [0, H-1] are
exactly zero, corner indices are clamped, and at the right/bottom edge the
weight anchor shifts one texel back so that sampling exactly at the last
texel returns that texel.  `interpolate_bilinear_np` is rnr_tpu's host
NumPy twin, with clamped corners and no masking (no driver calls it).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def bilinear_taps(x: torch.Tensor, y: torch.Tensor, h: int, w: int):
    """The four taps of `interpolate_bilinear` at x, y [...]: a list of
    (flat texel index [...] int64, weight [...]) in the order 00, 10, 01,
    11 (first index y, second x).  The backward scatter uses the same."""
    valid = ((x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)).to(x.dtype)

    # clamp before the int conversion so it is defined for any finite x
    x0 = torch.clamp(torch.floor(x.clamp(-1, w)).to(torch.int64), 0, w - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y0 = torch.clamp(torch.floor(y.clamp(-1, h)).to(torch.int64), 0, h - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)

    x0w = (x0 - (x0 == x1).to(x0.dtype)).to(x.dtype)
    y0w = (y0 - (y0 == y1).to(y0.dtype)).to(x.dtype)
    x1w = x1.to(x.dtype)
    y1w = y1.to(x.dtype)

    return [(y0 * w + x0, (x1w - x) * (y1w - y) * valid),
            (y1 * w + x0, (x1w - x) * (y - y0w) * valid),
            (y0 * w + x1, (x - x0w) * (y1w - y) * valid),
            (y1 * w + x1, (x - x0w) * (y - y0w) * valid)]


def interpolate_bilinear(data: torch.Tensor, x: torch.Tensor,
                         y: torch.Tensor) -> torch.Tensor:
    """data [H, W, C], x/y [...] -> [..., C]."""
    h, w = data.shape[0], data.shape[1]
    flat = data.reshape(h * w, -1)
    out = None
    for idx, wt in bilinear_taps(x.to(data.dtype), y.to(data.dtype), h, w):
        s = flat[idx] * wt[..., None]
        out = s if out is None else out + s
    return out


def interpolate_bilinear_batch(data: torch.Tensor, x: torch.Tensor,
                               y: torch.Tensor) -> torch.Tensor:
    """data [N, H, W, C], or [1, H, W, C] shared by the batch; x/y [N, ...]
    -> [N, ..., C]: one gather from a shared probe, else one per item."""
    if data.shape[0] == 1:
        return interpolate_bilinear(data[0], x, y)
    return torch.stack([interpolate_bilinear(d, xi, yi)
                        for d, xi, yi in zip(data, x, y)])


def resize_bilinear(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """img [H, W, C] -> [out_h, out_w, C], bilinear with half-pixel
    centres and clamped edges: jax.image.resize(..., "bilinear") when
    upsampling, the only use here (mipmap flattening).  Downsampling would
    differ (JAX antialiases).  Its backward is a fixed-order product with
    the interpolation matrices (`ResizeBilinearFn`), where F.interpolate's
    own adds with atomics on the card."""
    return ResizeBilinearFn.apply(img, tuple(out_hw))


def _resize_matrix(n_in: int, n_out: int, dtype, device) -> torch.Tensor:
    """[n_out, n_in] in `dtype`: the weights of F.interpolate's bilinear,
    half-pixel, align_corners=False along one axis (source index clamped
    at 0, the upper tap at n_in - 1; where the two taps meet, their
    weights add)."""
    o = torch.arange(n_out, dtype=dtype, device=device)
    src = torch.clamp((o + 0.5) * (n_in / n_out) - 0.5, min=0.0)
    i0 = torch.floor(src).to(torch.int64).clamp(max=n_in - 1)
    i1 = torch.clamp(i0 + 1, max=n_in - 1)
    l1 = src - i0.to(src.dtype)
    m = torch.zeros((n_out, n_in), dtype=dtype, device=device)
    rows = torch.arange(n_out, device=device)
    m.index_put_((rows, i0), 1.0 - l1, accumulate=True)
    m.index_put_((rows, i1), l1, accumulate=True)
    return m


class ResizeBilinearFn(torch.autograd.Function):
    """F.interpolate's bilinear resize of [H, W, C]; the backward
    A_y^T G A_x with the per-axis interpolation matrices
    (`_resize_matrix`): matrix products, the same bits every run."""

    @staticmethod
    def forward(ctx, img, out_hw):
        ctx.in_hw = img.shape[:2]
        y = F.interpolate(img.permute(2, 0, 1)[None], size=out_hw,
                          mode="bilinear", align_corners=False)
        return y[0].permute(1, 2, 0)

    @staticmethod
    def backward(ctx, g):
        (h, w), (oh, ow) = ctx.in_hw, g.shape[:2]
        ay = _resize_matrix(h, oh, g.dtype, g.device)       # [oh, h]
        ax = _resize_matrix(w, ow, g.dtype, g.device)       # [ow, w]
        c = g.shape[2]
        t = (ay.t() @ g.reshape(oh, ow * c)).reshape(h, ow, c)
        return (ax.t() @ t.permute(1, 0, 2).reshape(ow, h * c)).reshape(
            w, h, c).permute(1, 0, 2), None


def interpolate_bilinear_np(data: np.ndarray, sub_x, sub_y) -> np.ndarray:
    """data [H, W, C] at float pixel coordinates sub_x, sub_y [...] ->
    [..., C]: the four corners clamped into the image, no out-of-range
    masking (rnr_tpu's NumPy twin, which differs from
    `interpolate_bilinear` at the edges)."""
    x0 = np.floor(sub_x).astype(np.int64)
    y0 = np.floor(sub_y).astype(np.int64)
    x1, y1 = x0 + 1, y0 + 1
    x0, x1 = (np.clip(t, 0, data.shape[1] - 1) for t in (x0, x1))
    y0, y1 = (np.clip(t, 0, data.shape[0] - 1) for t in (y0, y1))
    w00 = (x1 - sub_x) * (y1 - sub_y)
    w10 = (x1 - sub_x) * (sub_y - y0)
    w01 = (sub_x - x0) * (y1 - sub_y)
    w11 = (sub_x - x0) * (sub_y - y0)
    return (data[y0, x0, :] * w00[..., None] + data[y1, x0, :] * w10[..., None]
            + data[y0, x1, :] * w01[..., None]
            + data[y1, x1, :] * w11[..., None])
