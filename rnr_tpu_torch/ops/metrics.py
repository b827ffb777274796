"""Masked image error metrics (port of rnr_tpu/ops/metrics.py:29-63,
`masked_err_metrics` only; psnr and SSIM are not ported yet)."""

from __future__ import annotations

import torch


def masked_err_metrics(img_est: torch.Tensor, img_gt: torch.Tensor,
                       mask: torch.Tensor) -> dict[str, torch.Tensor]:
    """MAE / MSE / PSNR over the full image and the masked region, each
    the mean over the batch of per-image values.  img_est, img_gt
    [N, H, W, C] in 0..255, mask [N, H, W, 1] 0/1.  Tensors stay on their
    device."""
    mask3 = mask.expand(img_est.shape)
    diff = torch.abs(img_est * mask3 - img_gt * mask3)
    num_valid = torch.clamp(torch.sum(mask3, dim=(1, 2, 3)), min=1.0)
    mae = torch.mean(diff, dim=(1, 2, 3))
    mae_valid = torch.sum(diff, dim=(1, 2, 3)) / num_valid
    mse = torch.mean(diff * diff, dim=(1, 2, 3))
    mse_valid = torch.sum(diff * diff, dim=(1, 2, 3)) / num_valid

    def psnr(m):
        return -10.0 * torch.log10(torch.clamp(m / (255.0 ** 2), min=1e-10))

    return {"mae": mae.mean(), "mae_valid": mae_valid.mean(),
            "mse": mse.mean(), "mse_valid": mse_valid.mean(),
            "psnr": psnr(mse).mean(), "psnr_valid": psnr(mse_valid).mean()}
