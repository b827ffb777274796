"""Loss terms of the RNR objective (port of rnr_tpu/train/losses.py:14-79).

Mask-weighted reductions with static shapes, as in rnr_tpu.
"""

from __future__ import annotations

import torch


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with rnr_tpu's gradient at 0, +1 (JAX's abs), where torch.abs
    gives 0: a lighting that starts equal to its anchor (a black stitched
    probe) or a black pixel rendered black then moves as in rnr_tpu."""
    return torch.where(x >= 0, x, -x)


def image_l1_loss(out_img: torch.Tensor, img_gt: torch.Tensor,
                  alpha_map: torch.Tensor, border_crop: int = 5,
                  rows: slice | None = None,
                  count: int | None = None) -> torch.Tensor:
    """Alpha-masked L1 with `border_crop` outer pixels excluded.
    out_img / img_gt [N, H, W, C], alpha_map [N, H, W, 1].  A row shard
    passes the `rows` its crop keeps (parallel/sharding.py::crop_rows:
    cropped at the frame's global top and bottom only) and the global
    batch's cropped element `count`, and gets its share of the global
    batch's loss: its sum over that count."""
    b = border_crop
    if rows is None:
        rows = slice(b, -b) if b > 0 else slice(None)
    cols = slice(b, -b) if b > 0 else slice(None)
    d = _abs(out_img[:, rows, cols] * alpha_map[:, rows, cols]
             - img_gt[:, rows, cols] * alpha_map[:, rows, cols])
    return torch.mean(d) if count is None else torch.sum(d) / count


def lighting_loss(l_samples_est: torch.Tensor, l_samples_init: torch.Tensor,
                  covered_mask: torch.Tensor, covered_weight: float = 1.0,
                  uncovered_weight: float = 0.1) -> torch.Tensor:
    """L1 between estimated and stitched-probe light samples [S, C];
    directions the probe covers (covered_mask [S], 0/1) at full weight,
    the others weakly."""
    diff = _abs(l_samples_init - l_samples_est)
    m = covered_mask[:, None]
    n_cov = torch.clamp(torch.sum(covered_mask), min=1.0)
    n_unc = torch.clamp(torch.sum(1.0 - covered_mask), min=1.0)
    cov = torch.sum(diff * m) / n_cov
    unc = torch.sum(diff * (1.0 - m)) / n_unc
    return cov * covered_weight + unc * uncovered_weight


def albedo_prior_loss(albedo_tex: torch.Tensor,
                      albedo_tex_init: torch.Tensor) -> torch.Tensor:
    """Pulls the mean of the touched albedo texels toward 0.5; a texel
    counts as touched once any channel differs from the initialisation,
    bit for bit.  albedo_tex / albedo_tex_init [H, W, C]."""
    changed = torch.any(albedo_tex != albedo_tex_init, dim=-1, keepdim=True)
    mask = changed.to(albedo_tex.dtype)
    denom = torch.sum(mask)
    mean_per_ch = torch.sum(albedo_tex * mask, dim=(0, 1)) / torch.clamp(
        denom, min=1.0)
    loss = torch.sum(_abs(mean_per_ch - 0.5)) / albedo_tex.shape[-1]
    return torch.where(denom == 0, torch.zeros_like(loss), loss)
