"""Image error metrics: PSNR, masked MAE / MSE / PSNR and a Gaussian SSIM
(port of rnr_tpu/ops/metrics.py).  Tensors stay on their device.  The
SSIM's separable blur is `F.conv2d` per channel, as rnr_tpu computes it
with an XLA convolution (no Pallas kernel)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def psnr(img_est: torch.Tensor, img_gt: torch.Tensor,
         mask: torch.Tensor | None = None, max_val: float = 255.0
         ) -> torch.Tensor:
    """PSNR in dB of 0..max_val images, optionally masked; 100 where the
    MSE is at most 1e-10."""
    diff = (img_est - img_gt) / max_val
    if mask is None:
        mse = torch.mean(diff * diff)
    else:
        mse = torch.sum(diff * diff * mask) / torch.clamp(torch.sum(mask),
                                                          min=1.0)
    mse = torch.clamp(mse, min=1e-10)
    return torch.where(mse <= 1.0e-10, torch.full_like(mse, 100.0),
                       -10.0 * torch.log10(mse))


def masked_err_metrics(img_est: torch.Tensor, img_gt: torch.Tensor,
                       mask: torch.Tensor, image_sum=None
                       ) -> dict[str, torch.Tensor]:
    """MAE / MSE / PSNR over the full image and the masked region, each
    the mean over the batch of per-image values.  img_est, img_gt
    [N, H, W, C] in 0..255, mask [N, H, W, 1] 0/1.  Each image's values
    come from its sums (|d|, d^2, the mask's count and the element
    count); where the image's rows lie on several ranks, `image_sum`
    sums those [4, N] over them first (an all-reduce over the sp group),
    so that the values are the whole frame's."""
    mask3 = mask.expand(img_est.shape)
    diff = torch.abs(img_est * mask3 - img_gt * mask3)
    s_abs = torch.sum(diff, dim=(1, 2, 3))
    sums = torch.stack([s_abs, torch.sum(diff * diff, dim=(1, 2, 3)),
                        torch.sum(mask3, dim=(1, 2, 3)),
                        torch.full_like(s_abs, diff[0].numel())])
    if image_sum is not None:
        sums = image_sum(sums)
    s_abs, s_sq, n_mask, n_all = sums.unbind()
    num_valid = torch.clamp(n_mask, min=1.0)
    mae = s_abs / n_all
    mae_valid = s_abs / num_valid
    mse = s_sq / n_all
    mse_valid = s_sq / num_valid

    def psnr_of(m):
        return -10.0 * torch.log10(torch.clamp(m / (255.0 ** 2), min=1e-10))

    return {"mae": mae.mean(), "mae_valid": mae_valid.mean(),
            "mse": mse.mean(), "mse_valid": mse_valid.mean(),
            "psnr": psnr_of(mse).mean(), "psnr_valid": psnr_of(mse_valid).mean()}


def _gaussian_kernel(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return g / torch.sum(g)


def ssim(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 255.0,
         win_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Mean Gaussian-window SSIM of [N, H, W, C] images (valid windows;
    the window shrinks to the largest odd size that fits)."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    max_win = min(img1.shape[1], img1.shape[2])
    if win_size > max_win:
        win_size = max_win if max_win % 2 == 1 else max_win - 1
    kernel = _gaussian_kernel(win_size, sigma, img1.device)
    kh = kernel.reshape(1, 1, win_size, 1)
    kw = kernel.reshape(1, 1, 1, win_size)

    def blur(x):
        n, h, w, c = x.shape
        y = torch.movedim(x, -1, 1).reshape(n * c, 1, h, w)
        y = F.conv2d(F.conv2d(y, kh), kw)
        return torch.movedim(y.reshape(n, c, y.shape[-2], y.shape[-1]), 1, -1)

    mu1, mu2 = blur(img1), blur(img2)
    # variances and covariance on globally mean-shifted inputs, so that
    # blur(x^2) - mu^2 cancels at the scale of the local contrast and not
    # of the magnitude (unclipped renders reach |x| ~ 1e4-1e5 x 255)
    d1 = img1 - torch.mean(img1)
    d2 = img2 - torch.mean(img2)
    nu1, nu2 = blur(d1), blur(d2)
    sigma1_sq = torch.clamp(blur(d1 * d1) - nu1 * nu1, min=0.0)
    sigma2_sq = torch.clamp(blur(d2 * d2) - nu2 * nu2, min=0.0)
    bound = torch.sqrt(sigma1_sq * sigma2_sq)
    sigma12 = torch.clamp(blur(d1 * d2) - nu1 * nu2, -bound, bound)
    ssim_map = ((2.0 * mu1 * mu2 + c1) * (2.0 * sigma12 + c2)) / (
        (mu1 * mu1 + mu2 * mu2 + c1) * (sigma1_sq + sigma2_sq + c2))
    return torch.mean(ssim_map)
