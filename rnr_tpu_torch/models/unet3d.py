"""3D U-Net and image down / upsampling stacks (port of
rnr_tpu/models/unet3d.py, which no driver uses): DownBlock3D / UpBlock3D
/ Unet3d on NDHWC volumes, DownsamplingNet / UpsamplingNet of the 2D
U-Net's blocks on NHWC images.  Plain PyTorch convs; submodules carry
the flax names, so `rnr_tpu_torch.convert` loads a flax tree by path.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from rnr_tpu_torch.models.unet import (DROPOUT_P, DownBlock, GroupNorm,
                                       UpBlock, _check_norm, _identity,
                                       dropout)


def _replicate_pad3d(x: torch.Tensor, p: int) -> torch.Tensor:
    """Edge padding of an NDHWC volume by p on D, H and W."""
    return F.pad(x.permute(0, 4, 1, 2, 3), (p,) * 6,
                 mode="replicate").permute(0, 2, 3, 4, 1)


class Conv3d(nn.Module):
    """flax nn.Conv over NDHWC with a DHWIO `kernel` [k, k, k, I, O],
    padding "VALID", stride s."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1,
                 use_bias: bool = True):
        super().__init__()
        self.stride = stride
        self.kernel = nn.Parameter(torch.zeros((k, k, k, in_ch, out_ch)))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv3d(x.permute(0, 4, 1, 2, 3),
                     self.kernel.permute(4, 3, 0, 1, 2), self.bias,
                     stride=self.stride)
        return y.permute(0, 2, 3, 4, 1)


class ConvTranspose3d(nn.Module):
    """flax nn.ConvTranspose (4, 4, 4), strides 2, "SAME" over NDHWC with
    a DHWIO `kernel`: a correlation with the flipped kernel on the dilated
    input, as F.conv_transpose3d with padding 1."""

    def __init__(self, in_ch: int, out_ch: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros((4, 4, 4, in_ch, out_ch)))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel.flip(0, 1, 2).permute(3, 4, 0, 1, 2)
        y = F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), k, self.bias,
                               stride=2, padding=1)
        return y.permute(0, 2, 3, 4, 1)


class BatchActNorm3D(nn.Module):
    """Current-batch-statistics norm over (N, D, H, W)."""

    def __init__(self, ch: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var, mean = torch.var_mean(x, dim=(0, 1, 2, 3), keepdim=True,
                                   unbiased=False)
        return (x - mean) * torch.rsqrt(var + self.epsilon) * self.scale \
            + self.bias


def _norm3d(mod: nn.Module, norm: str, ch: int, idx: int = 0) -> None:
    if norm == "batch":
        setattr(mod, f"BatchActNorm3D_{idx}", BatchActNorm3D(ch))
    elif norm == "group":
        setattr(mod, f"GroupNorm_{idx}", GroupNorm(ch))


def _apply_norm3d(mod: nn.Module, x: torch.Tensor, idx: int = 0):
    norm = (getattr(mod, f"BatchActNorm3D_{idx}", None)
            or getattr(mod, f"GroupNorm_{idx}", None))
    return x if norm is None else norm(x)


class DownBlock3D(nn.Module):
    """Replication-padded 4^3 stride-2 conv + norm + LeakyReLU."""

    def __init__(self, in_ch: int, out_ch: int, norm: str = "batch"):
        super().__init__()
        self.Conv_0 = Conv3d(in_ch, out_ch, 4, 2,
                             _check_norm(norm) == "none")
        _norm3d(self, norm, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(_replicate_pad3d(x, 1))
        return F.leaky_relu(_apply_norm3d(self, x), 0.2)


class UpBlock3D(nn.Module):
    """[skip concat] + 4^3 stride-2 transpose conv + norm + ReLU."""

    def __init__(self, in_ch: int, out_ch: int, norm: str = "batch"):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose3d(in_ch, out_ch,
                                               _check_norm(norm) == "none")
        _norm3d(self, norm, out_ch)

    def forward(self, x: torch.Tensor,
                skipped: torch.Tensor | None = None) -> torch.Tensor:
        if skipped is not None:
            x = torch.cat([skipped, x], dim=-1)
        return torch.relu(_apply_norm3d(self, self.ConvTranspose_0(x)))


class Unet3d(nn.Module):
    """3D U-Net with per-level skip concatenation (NDHWC)."""

    def __init__(self, in_channels: int, out_channels: int, nf0: int = 16,
                 num_down: int = 3, max_channels: int = 128,
                 norm: str = "batch", outermost_linear: bool = False):
        super().__init__()
        nd = self.num_down = num_down
        self.outermost_linear = outermost_linear
        chs = [nf0] + [min(2 ** (i + 1) * nf0, max_channels)
                       for i in range(nd)]
        self.Conv_0 = Conv3d(in_channels, nf0, 3, 1, norm == "none")
        if norm == "batch":
            self.BatchActNorm3D_0 = BatchActNorm3D(nf0)
        for i in range(nd):
            level_norm = "none" if i == nd - 1 else norm
            setattr(self, f"DownBlock3D_{i}",
                    DownBlock3D(chs[i], chs[i + 1], level_norm))
        for j, i in enumerate(reversed(range(nd))):
            level_norm = "none" if i == nd - 1 else norm
            in_ch = chs[nd] if i == nd - 1 else 2 * chs[i + 1]
            setattr(self, f"UpBlock3D_{j}", UpBlock3D(in_ch, chs[i],
                                                      level_norm))
        self.Conv_1 = Conv3d(2 * chs[0], out_channels, 3, 1,
                             outermost_linear)
        if not outermost_linear and norm == "batch":
            self.BatchActNorm3D_1 = BatchActNorm3D(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.Conv_0(_replicate_pad3d(x, 1))
        if hasattr(self, "BatchActNorm3D_0"):
            h = self.BatchActNorm3D_0(h)
        h = F.leaky_relu(h, 0.2)
        skips = []
        for i in range(self.num_down):
            skips.append(h)
            h = getattr(self, f"DownBlock3D_{i}")(h)
        for j, i in enumerate(reversed(range(self.num_down))):
            h = getattr(self, f"UpBlock3D_{j}")(h)
            h = torch.cat([skips[i], h], dim=-1)
        h = self.Conv_1(_replicate_pad3d(h, 1))
        if not self.outermost_linear:
            if hasattr(self, "BatchActNorm3D_1"):
                h = self.BatchActNorm3D_1(h)
            h = torch.relu(h)
        return h


def _drop(use_dropout: bool, p: float, train: bool,
          generator: torch.Generator | None):
    if not (use_dropout and train):
        return _identity
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    return functools.partial(dropout, p=p, generator=generator)


class DownsamplingNet(nn.Module):
    """A stack of the U-Net's stride-2 DownBlocks (NHWC): the first with
    its prep conv to per_layer_out_ch[0], the last without norm when
    last_layer_one."""

    def __init__(self, in_ch: int, per_layer_out_ch, use_dropout: bool = False,
                 dropout_prob: float = DROPOUT_P, last_layer_one: bool = False,
                 norm: str = "batch"):
        super().__init__()
        chs = list(per_layer_out_ch)
        self.n, self.use_dropout, self.p = len(chs), use_dropout, dropout_prob
        kw = dict(backend="xla")
        if chs:
            self.DownBlock_0 = DownBlock(in_ch, chs[0], norm,
                                         middle_ch=chs[0], **kw)
        for i in range(len(chs) - 1):
            n = ("none" if last_layer_one and i == len(chs) - 2 else norm)
            setattr(self, f"DownBlock_{i + 1}",
                    DownBlock(chs[i], chs[i + 1], n, **kw))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        drop = _drop(self.use_dropout, self.p, train, generator)
        for i in range(self.n):
            x = getattr(self, f"DownBlock_{i}")(x, drop)
        return x


class UpsamplingNet(nn.Module):
    """A stack of the U-Net's 2x UpBlocks (NHWC): the first without norm
    when first_layer_one."""

    def __init__(self, in_ch: int, per_layer_out_ch, use_dropout: bool = False,
                 dropout_prob: float = DROPOUT_P, first_layer_one: bool = False,
                 norm: str = "batch"):
        super().__init__()
        chs = list(per_layer_out_ch)
        self.n, self.use_dropout, self.p = len(chs), use_dropout, dropout_prob
        kw = dict(backend="xla")
        if chs:
            self.UpBlock_0 = UpBlock(in_ch, chs[0],
                                     "none" if first_layer_one else norm,
                                     **kw)
        for i in range(len(chs) - 1):
            setattr(self, f"UpBlock_{i + 1}",
                    UpBlock(chs[i], chs[i + 1], norm, **kw))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        drop = _drop(self.use_dropout, self.p, train, generator)
        for i in range(self.n):
            x = getattr(self, f"UpBlock_{i}")(x, drop)
        return x
