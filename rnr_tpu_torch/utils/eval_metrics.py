"""Host-side evaluation metrics with the reference's semantics (port of
rnr_tpu/utils/eval_metrics.py): masked MAE / MSE / PSNR over the full
image, the mask's bounding box and the masked region, and SSIM (through
`ops.metrics.ssim` on the CPU) where the unmasked pixels of the bounding
box take the ground truth.  NumPy in, Python floats out."""

from __future__ import annotations

import math

import numpy as np
import torch

from rnr_tpu_torch.ops.metrics import ssim


def psnr_np(img1, img2, mask=None, max_val=255.0):
    if mask is None:
        mse = np.mean((img1 / max_val - img2 / max_val) ** 2)
    else:
        n = mask.sum(dtype=np.float64)
        mse = np.sum((img1 / max_val - img2 / max_val) ** 2 * mask) / max(n, 1)
    if mse < 1e-10:
        return 100.0
    return 20 * math.log10(1.0 / math.sqrt(mse))


def _ssim_np(img1, img2, data_range=255.0):
    return float(ssim(torch.from_numpy(img1[None].astype(np.float32)),
                      torch.from_numpy(img2[None].astype(np.float32)),
                      data_range=data_range))


def compute_err_metrics(img_est, img_gt, mask, compute_ssim=True):
    """Metrics of one [H, W, 3] image pair (0..255) with an [H, W] mask."""
    img_est = np.asarray(img_est, np.float64).copy()
    img_gt = np.asarray(img_gt, np.float64).copy()
    mask = np.asarray(mask) == 1

    img_est[~mask] = 0
    img_gt[~mask] = 0
    mask3 = mask[:, :, None].repeat(3, axis=2).astype(np.float64)

    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return {"mae": np.nan}
    y0, y1 = ys.min(), ys.max() + 1
    x0, x1 = xs.min(), xs.max() + 1
    est_bb = img_est[y0:y1, x0:x1]
    gt_bb = img_gt[y0:y1, x0:x1]

    diff = np.abs(img_est - img_gt)
    diff_bb = diff[y0:y1, x0:x1]
    n_valid = mask3.sum(dtype=np.float64)

    m = {
        "mae": diff.mean(dtype=np.float64),
        "mae_bb": diff_bb.mean(dtype=np.float64),
        "mae_valid": (diff * mask3).sum(dtype=np.float64) / n_valid,
        "mse": (diff ** 2).mean(dtype=np.float64),
        "mse_bb": (diff_bb ** 2).mean(dtype=np.float64),
        "mse_valid": ((diff ** 2) * mask3).sum(dtype=np.float64) / n_valid,
        "psnr": psnr_np(img_est, img_gt),
        "psnr_bb": psnr_np(est_bb, gt_bb),
        "psnr_valid": psnr_np(img_est, img_gt, mask=mask3),
    }
    if compute_ssim:
        m["ssim"] = _ssim_np(img_est, img_gt)
        m["ssim_bb"] = _ssim_np(est_bb, gt_bb)
        inv = ~mask[y0:y1, x0:x1]
        est_fill = est_bb.copy()
        est_fill[inv] = gt_bb[inv]
        m["ssim_valid"] = _ssim_np(est_fill, gt_bb)
    return m


def compute_err_metrics_batch(img_est, img_gt, mask, compute_ssim=True):
    """[N, H, W, 3] images and an [N, H, W, 1] mask: per-image lists of
    every metric and their '*_mean'."""
    img_est = np.asarray(img_est)
    img_gt = np.asarray(img_gt)
    mask = np.asarray(mask)
    out: dict = {}
    for i in range(img_est.shape[0]):
        mi = compute_err_metrics(img_est[i], img_gt[i], mask[i, ..., 0],
                                 compute_ssim)
        for k, v in mi.items():
            out.setdefault(k, []).append(v)
    for k in list(out.keys()):
        out[k + "_mean"] = float(np.mean(out[k]))
    return out
