"""Kernel-vs-twin dispatch.

One rule, with no override: a CUDA tensor runs the hand-written kernel,
a CPU tensor runs its plain PyTorch twin.  A CUDA tensor whose kernel
cannot build or launch raises; nothing falls back to the twin.
"""

from __future__ import annotations

import torch


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device, False when all lie on
    the CPU; anything else (mixed or other devices) raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on devices {sorted(kinds)}: expected all "
                     "on one CUDA device or all on the CPU")


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds on: the current CUDA device when
    `device` is None (raising when there is no card: nothing falls back
    to the CPU), else `device` as given (`"cpu"` for the plain versions).
    On a CUDA device cuDNN is set to its deterministic algorithms, with no
    autotuning, so that the port's steps and frames repeat bit for bit."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the GPU "
                               "unless device='cpu' is passed")
        device = torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    return dev


def stream_of(t: torch.Tensor) -> int:
    """The current stream of the tensor's device, as the int handle the C
    entry points take; the device must be the current one, since the
    kernels launch into the current device's context."""
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {t.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(err: int, name: str) -> None:
    """Raise when a kernel's C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple | None = None) -> None:
    """Check what a kernel takes: dtype, optional shape, contiguity."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes a contiguous tensor")
