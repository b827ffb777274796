"""Deferred-rendering U-Net with GCN feature fusion (port of
rnr_tpu/models/unet.py).

NHWC at every module boundary.  Every 3x3 stride-1 conv runs K3 and, in
the backward, its data gradient (K3 again) and K3b (ops/conv_cuda.py), as
rnr_tpu's conv_backend="pallas3" does; the 4x4 stride-2 conv and the 4x4
transpose conv stay F.conv2d / F.conv_transpose2d, as they stay XLA convs
there.  Normalisation uses current-batch statistics ("batch", no running
state) or none.  With train=True, dropout (p 0.1) follows every
activation where rnr_tpu's Unet has it, its masks drawn from the
torch.Generator the caller passes.  Submodule names mirror the flax
auto-names (Conv_0, BatchActNorm_1, DownBlock_2, ...), so that
`rnr_tpu_torch.convert` can map a JAX parameter tree by path.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from rnr_tpu_torch.ops.conv_cuda import conv3x3

DROPOUT_P = 0.1   # rnr_tpu's RenderingNet fixes the U-Net's dropout rate


def _check_norm(norm: str) -> str:
    if norm not in ("batch", "none"):
        raise NotImplementedError(f"norm {norm!r}: the port has 'batch' and "
                                  "'none'")
    return norm


class Conv(nn.Module):
    """kxk conv with bias optional.  3x3 stride 1 keeps the HWIO `kernel`
    [3, 3, I, O] that K3 reads; any other shape keeps an OIHW `weight` for
    F.conv2d.  Padding is internal: reflect by 1, or zero "same"."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, use_bias: bool = True,
                 dtype: torch.dtype | None = None, pad_mode: str = "reflect"):
        super().__init__()
        if pad_mode not in ("reflect", "same"):
            raise ValueError(f"pad_mode {pad_mode!r}")
        self.k, self.stride = kernel_size, stride
        self.dtype, self.pad_mode = dtype, pad_mode
        self.is3x3 = kernel_size == 3 and stride == 1
        if self.is3x3:
            self.kernel = nn.Parameter(torch.zeros((3, 3, in_ch, out_ch)))
        else:
            self.weight = nn.Parameter(
                torch.zeros((out_ch, in_ch, kernel_size, kernel_size)))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        x = x.to(dt)
        if self.is3x3:
            b = self.bias if self.bias is not None else torch.zeros(
                self.kernel.shape[-1], device=x.device)
            return conv3x3(x, self.kernel, b, self.pad_mode)
        xn = x.permute(0, 3, 1, 2)
        if self.pad_mode == "reflect":
            xn = F.pad(xn, (1, 1, 1, 1), mode="reflect")
        else:   # XLA "SAME": total pad (out-1)*s + k - in, low half first
            pads = []
            for size in (xn.shape[3], xn.shape[2]):
                out = -(-size // self.stride)
                tot = max((out - 1) * self.stride + self.k - size, 0)
                pads += [tot // 2, tot - tot // 2]
            xn = F.pad(xn, pads)
        y = F.conv2d(xn, self.weight.to(dt), stride=self.stride)
        y = y.permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


class ConvTranspose(nn.Module):
    """4x4 stride-2 "SAME" transpose conv; `weight` [I, O, 4, 4] is the
    spatially flipped JAX kernel, so padding=1 reproduces
    jax.lax.conv_transpose(..., (2, 2), "SAME")."""

    def __init__(self, in_ch: int, out_ch: int, use_bias: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros((in_ch, out_ch, 4, 4)))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        x = x.to(dt)
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight.to(dt),
                               stride=2, padding=1).permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


class BatchActNorm(nn.Module):
    """Affine normalisation by current-batch statistics over (N, H, W)."""

    def __init__(self, ch: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        var, mean = torch.var_mean(x32, dim=(0, 1, 2), keepdim=True,
                                   unbiased=False)
        y = (x32 - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.scale + self.bias).to(x.dtype)


def _norm_act(mod: nn.Module, idx: int, x: torch.Tensor, act) -> torch.Tensor:
    norm = getattr(mod, f"BatchActNorm_{idx}", None)
    if norm is not None:
        x = norm(x)
    return act(x)


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _identity(x):
    return x


def dropout(x: torch.Tensor, p: float,
            generator: torch.Generator) -> torch.Tensor:
    """flax nn.Dropout in training: keep each value with probability 1 - p
    and scale the kept ones by 1 / (1 - p).  The mask is drawn from
    `generator` (on x's device), never from the global RNG."""
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class DownBlock(nn.Module):
    """[3x3 prep conv, norm, LeakyReLU] + [kxk stride-s conv, norm,
    LeakyReLU]."""

    def __init__(self, in_ch: int, out_ch: int, norm: str = "batch",
                 stride: int = 2, kernel: int = 4,
                 dtype: torch.dtype | None = None, pad_mode: str = "reflect"):
        super().__init__()
        use_bias = _check_norm(norm) == "none"
        self.Conv_0 = Conv(in_ch, in_ch, 3, 1, use_bias, dtype, pad_mode)
        self.Conv_1 = Conv(in_ch, out_ch, kernel, stride, use_bias, dtype,
                           pad_mode)
        if norm == "batch":
            self.BatchActNorm_0 = BatchActNorm(in_ch)
            self.BatchActNorm_1 = BatchActNorm(out_ch)

    def forward(self, x, drop=_identity):
        x = drop(_norm_act(self, 0, self.Conv_0(x), _lrelu))
        return drop(_norm_act(self, 1, self.Conv_1(x), _lrelu))


class UpBlock(nn.Module):
    """4x4 stride-2 transpose conv + 3x3 post conv, each norm + ReLU."""

    def __init__(self, in_ch: int, out_ch: int, norm: str = "batch",
                 dtype: torch.dtype | None = None, pad_mode: str = "reflect"):
        super().__init__()
        use_bias = _check_norm(norm) == "none"
        self.ConvTranspose_0 = ConvTranspose(in_ch, out_ch, use_bias, dtype)
        self.Conv_0 = Conv(out_ch, out_ch, 3, 1, use_bias, dtype, pad_mode)
        if norm == "batch":
            self.BatchActNorm_0 = BatchActNorm(out_ch)
            self.BatchActNorm_1 = BatchActNorm(out_ch)

    def forward(self, x, drop=_identity):
        x = drop(_norm_act(self, 0, self.ConvTranspose_0(x), torch.relu))
        return drop(_norm_act(self, 1, self.Conv_0(x), torch.relu))


class GcnFuseBlock(nn.Module):
    """GCN fusion with the constant-map conv collapsed to a dense: a 3x3
    conv of h to the concat width plus Dense(v) broadcast over space,
    norm, LeakyReLU, then a 3x3 conv to out_ch, norm, LeakyReLU."""

    def __init__(self, h_ch: int, v_ch: int, out_ch: int,
                 norm: str = "batch", dtype: torch.dtype | None = None,
                 pad_mode: str = "reflect"):
        super().__init__()
        use_bias = _check_norm(norm) == "none"
        mid = h_ch + v_ch
        self.dtype = dtype
        self.Conv_0 = Conv(h_ch, mid, 3, 1, use_bias, dtype, pad_mode)
        self.Dense_0 = nn.Linear(v_ch, mid, bias=False)
        self.Conv_1 = Conv(mid, out_ch, 3, 1, use_bias, dtype, pad_mode)
        if norm == "batch":
            self.BatchActNorm_0 = BatchActNorm(mid)
            self.BatchActNorm_1 = BatchActNorm(out_ch)

    def forward(self, h, v, drop=_identity):
        dt = self.dtype or v.dtype
        proj = F.linear(v.to(dt), self.Dense_0.weight.to(dt))
        x = self.Conv_0(h) + proj[:, None, None, :]
        x = drop(_norm_act(self, 0, x, _lrelu))
        return drop(_norm_act(self, 1, self.Conv_1(x), _lrelu))


class Unet(nn.Module):
    """Skip-connected encoder/decoder with GCN fusion after level 0.
    Dropout (p DROPOUT_P) runs in training; `use_dropout` may be switched
    off on an instance (as rnr_tpu's Unet field), e.g. to compare two
    devices' gradients."""

    def __init__(self, in_channels: int, out_channels: int, nf0: int = 64,
                 num_down: int = 5, max_channels: int = 512,
                 norm: str = "batch", outermost_linear: bool = True,
                 out_channels_gcn: int = 512, use_gcn: bool = True,
                 outermost_highway_mode: str = "concat",
                 compute_dtype: str = "float32", fuse_mode: str = "concat",
                 pad_mode: str = "reflect"):
        super().__init__()
        _check_norm(norm)
        if fuse_mode not in ("concat", "dense"):
            raise ValueError(f"fuse_mode {fuse_mode!r}")
        if outermost_highway_mode not in ("concat", "residual", "no_highway"):
            raise ValueError(f"outermost_highway_mode {outermost_highway_mode!r}")
        nd = num_down
        self.num_down, self.use_gcn, self.fuse_mode = nd, use_gcn, fuse_mode
        self.use_dropout = True
        self.outermost_linear = outermost_linear
        self.highway = outermost_highway_mode
        self.cdtype = cdt = getattr(torch, compute_dtype)
        chs = [nf0] + [min(2 ** (i + 1) * nf0, max_channels)
                       for i in range(nd - 1)]
        chs.append(min(2 ** (nd - 1) * nf0, max_channels))
        kw = dict(dtype=cdt, pad_mode=pad_mode)

        self.Conv_0 = Conv(in_channels, nf0, 3, 1, norm == "none", **kw)
        if norm == "batch":
            self.BatchActNorm_0 = BatchActNorm(nf0)

        # flax numbers modules per class in creation order: the concat
        # fusion DownBlock is created right after level 0's
        self.down_names: list[str] = []
        n_down = 0
        for i in range(nd):
            level_norm = "none" if i == nd - 1 else norm
            name = f"DownBlock_{n_down}"
            setattr(self, name, DownBlock(chs[i], chs[i + 1], level_norm,
                                          **kw))
            self.down_names.append(name)
            n_down += 1
            if i == 0 and use_gcn:
                if fuse_mode == "dense":
                    self.GcnFuseBlock_0 = GcnFuseBlock(
                        chs[1], out_channels_gcn, chs[1], norm, **kw)
                else:
                    self.fuse_name = f"DownBlock_{n_down}"
                    setattr(self, self.fuse_name, DownBlock(
                        chs[1] + out_channels_gcn, chs[1], norm, stride=1,
                        kernel=3, **kw))
                    n_down += 1

        # UpBlock_0 is the innermost level (created first, i = nd-1)
        for j, i in enumerate(reversed(range(nd))):
            level_norm = "none" if i == nd - 1 else norm
            in_ch = chs[nd] if i == nd - 1 else 2 * chs[i + 1]
            setattr(self, f"UpBlock_{j}", UpBlock(in_ch, chs[i], level_norm,
                                                  **kw))

        out_in = 2 * chs[0] if outermost_highway_mode == "concat" else chs[0]
        self.Conv_1 = Conv(out_in, out_channels, 3, 1,
                           outermost_linear or norm == "none", **kw)
        if not outermost_linear and norm == "batch":
            self.BatchActNorm_1 = BatchActNorm(out_channels)

    def forward(self, x: torch.Tensor, v_fea: torch.Tensor | None = None,
                train: bool = False,
                generator: torch.Generator | None = None):
        drop = _identity
        if train and self.use_dropout:
            if generator is None:
                raise ValueError("dropout in training needs a torch.Generator")
            drop = functools.partial(dropout, p=DROPOUT_P,
                                     generator=generator)
        x = x.to(self.cdtype)
        if v_fea is not None:
            v_fea = v_fea.to(self.cdtype)
        h = drop(_norm_act(self, 0, self.Conv_0(x), _lrelu))
        skips = []
        for i, name in enumerate(self.down_names):
            skips.append(h)
            h = getattr(self, name)(h, drop)
            if i == 0 and self.use_gcn:
                if v_fea is None:
                    raise ValueError("use_gcn=True requires v_fea")
                if self.fuse_mode == "dense":
                    h = self.GcnFuseBlock_0(h, v_fea, drop)
                else:
                    tiled = v_fea[:, None, None, :].expand(
                        h.shape[0], h.shape[1], h.shape[2], v_fea.shape[-1])
                    h = getattr(self, self.fuse_name)(
                        torch.cat([h, tiled], dim=-1), drop)
        for j, i in enumerate(reversed(range(self.num_down))):
            h = getattr(self, f"UpBlock_{j}")(h, drop)
            mode = self.highway if i == 0 else "concat"
            if mode == "concat":
                h = torch.cat([skips[i], h], dim=-1)
            elif mode == "residual":
                h = skips[i] + h
        h = self.Conv_1(h)
        if not self.outermost_linear:
            h = drop(_norm_act(self, 1, h, torch.relu))
        return h


class RenderingNet(nn.Module):
    """U-Net + tanh head; `Unet_0` as in the flax tree, with dropout
    (rnr_tpu's RenderingNet forces use_dropout=True)."""

    def __init__(self, nf0: int, in_channels: int, out_channels: int,
                 num_down_unet: int = 5, out_channels_gcn: int = 512,
                 use_gcn: bool = True, outermost_highway_mode: str = "concat",
                 norm: str = "batch", compute_dtype: str = "float32",
                 fuse_mode: str = "concat", pad_mode: str = "reflect"):
        super().__init__()
        self.Unet_0 = Unet(
            in_channels, out_channels, nf0=nf0, num_down=num_down_unet,
            max_channels=8 * nf0, norm=norm, outermost_linear=True,
            out_channels_gcn=out_channels_gcn, use_gcn=use_gcn,
            outermost_highway_mode=outermost_highway_mode,
            compute_dtype=compute_dtype, fuse_mode=fuse_mode,
            pad_mode=pad_mode)

    def forward(self, x, v_fea=None, train: bool = False,
                generator: torch.Generator | None = None):
        return torch.tanh(self.Unet_0(x, v_fea, train, generator).to(
            torch.float32))
