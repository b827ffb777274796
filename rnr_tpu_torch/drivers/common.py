"""Shared driver utilities (port of rnr_tpu/drivers/common.py): path
resolution, the device choice, sphere samples, the `--tex_fp` texture,
PNG output and the training loops' timing."""

from __future__ import annotations

import os
import time

import numpy as np
import scipy.io
import torch

from rnr_tpu_torch.data.imageio import (IMREAD_COLOR, read_image, resize,
                                        write_png)
from rnr_tpu_torch.ops.backend import resolve_device

PLATFORMS = ("cuda", "cpu")


def resolve(path: str | None, data_root: str) -> str | None:
    """Expand the reference's `_/` data-root-relative prefix."""
    if path is None:
        return None
    if path.startswith("_/"):
        return os.path.join(data_root, path[2:])
    return path


def str2bool(x) -> bool:
    """The reference's boolean flags: "true" or "1" (any case) is True."""
    return str(x).lower() in ["true", "1"]


def cond_mkdir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def setup_device(platform: str | None = "cuda") -> torch.device:
    """The device a driver runs on: `cuda` (the default: the current CUDA
    device, raising when there is none) or `cpu` (the kernels' plain
    versions).  Nothing falls back to the CPU."""
    platform = platform or "cuda"
    if platform not in PLATFORMS:
        raise ValueError(f"--platform {platform!r}: expected one of "
                         f"{PLATFORMS}")
    return resolve_device(None if platform == "cuda" else "cpu")


def load_sphere_samples(path: str) -> np.ndarray:
    """[3, num_sample] unit directions from a sphere_samples .mat file, or
    the 4096-point Fibonacci sphere when the file is absent."""
    if path and os.path.isfile(path):
        return scipy.io.loadmat(path)["sphere_samples"].T.astype(np.float32)
    n = 4096
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    return np.stack([np.sin(phi) * np.cos(theta),
                     np.sin(phi) * np.sin(theta),
                     np.cos(phi)]).astype(np.float32)


def read_texture_init(path: str, size: int) -> np.ndarray:
    """rnr_tpu's `--tex_fp` of train_rnr and train_dnr: cv2.imread's
    default IMREAD_COLOR read (EXIF orientation applied, 16 bits to their
    high byte, gray to three channels, alpha dropped) as RGB, resized to
    size x size with INTER_AREA, / 255 -> float32 [size, size, 3]."""
    tex = read_image(path, IMREAD_COLOR)
    return resize(tex, (size, size), "area").astype(np.float32) / 255.0


def save_png(path: str, img) -> None:
    """Write a float [H, W, C] RGB image in [0, 1] (a tensor or an array)
    as an 8-bit PNG, truncated as rnr_tpu's cv2 write of uint8 is."""
    if isinstance(img, torch.Tensor):
        img = img.detach().float().cpu().numpy()
    arr = np.clip(np.asarray(img, np.float32), 0.0, 1.0) * 255.0
    write_png(path, arr.astype(np.uint8))


def sync(dev: torch.device) -> None:
    """Wait for the card's queued work (nothing on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def loop_time(timing: dict, t_loop: float | None, dev) -> dict:
    """A training loop's timing at its end (summary.json's "timing"): its
    wall time after the first iteration, validation and checkpoints
    taken out, and iterations a second."""
    if t_loop is not None:
        sync(dev)
        timing["loop_s"] = (time.perf_counter() - t_loop
                            - timing["validate_s"] - timing["checkpoint_s"])
    if timing["loop_s"] > 0:
        timing["iters_per_s"] = timing["iters_timed"] / timing["loop_s"]
    return timing
