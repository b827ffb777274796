"""K3: 3x3 stride-1 conv (csrc/conv3x3.cu), its data gradient (K3 with
an f32 output), K3b: its weight gradient (csrc/conv3x3_wgrad.cu), and the
plain versions of all three, bound into one autograd.Function.

Replaces rnr_tpu/ops/conv_pallas.py::conv3x3 with its custom VJP
(fuse_act=False, as the U-Net calls it): NHWC activations, HWIO weights
cast to the activation dtype, f32 accumulation, + bias in f32, output in
the activation dtype; zero ("same") or reflect padding.  The backward is
that of `_conv3x3_bwd` (:409): the output gradient cast to the
activation dtype; db = sum(g) in f32; dx = the conv of g with the rotated,
io-transposed weights, in f32, under reflect padding run on g zero-padded
by one ring and folded back with the exact adjoint of reflect-pad; dW
from the K3b weight-gradient kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rnr_tpu_torch.ops import _build
from rnr_tpu_torch.ops.backend import (check_launch, require, stream_of,
                                       use_kernel)

WGRAD_TILE = 64          # csrc/conv3x3_wgrad.cu BM = BN
WGRAD_BK = 32            # pixels per K step
WGRAD_TARGET_BLOCKS = 1024


def conv3x3_torch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  pad_mode: str = "same") -> torch.Tensor:
    """Plain version: F.conv2d on the NCHW view, in f32 from inputs
    rounded to the activation dtype, + bias, rounded back to that dtype."""
    dt = x.dtype
    xf = x.to(torch.float32).permute(0, 3, 1, 2)
    wf = w.to(dt).to(torch.float32).permute(3, 2, 0, 1)
    if pad_mode == "reflect":
        xf = F.pad(xf, (1, 1, 1, 1), mode="reflect")
        y = F.conv2d(xf, wf)
    else:
        y = F.conv2d(xf, wf, padding=1)
    y = y + b.to(torch.float32)[None, :, None, None]
    return y.permute(0, 2, 3, 1).to(dt)


def _conv_f32_torch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The zero-padded conv with no bias and an f32 output, from operands
    rounded to x's dtype: what K3's f32-output instantiation computes."""
    xf = x.to(torch.float32).permute(0, 3, 1, 2)
    wf = w.to(x.dtype).to(torch.float32).permute(3, 2, 0, 1)
    return F.conv2d(xf, wf, padding=1).permute(0, 2, 3, 1)


def _launch_k3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               pad_mode: str, out_dtype: torch.dtype) -> torch.Tensor:
    """One launch of K3 (bf16 or f32 output); counts in conv3x3.launches."""
    n, h, wd, c = x.shape
    o = w.shape[-1]
    if pad_mode == "reflect" and (h < 2 or wd < 2):
        raise ValueError("reflect padding needs H, W >= 2")
    xb = x.contiguous()
    require(xb, "x", torch.bfloat16, (n, h, wd, c))
    wb = w.to(torch.bfloat16).contiguous()
    require(wb, "w", torch.bfloat16, (3, 3, c, o))
    bf = b.to(torch.float32).contiguous()
    require(bf, "b", torch.float32, (o,))
    y = torch.empty((n, h, wd, o), dtype=out_dtype, device=x.device)
    symbol = ("rnr_conv3x3" if out_dtype == torch.bfloat16
              else "rnr_conv3x3_f32out")
    f = _build.fn("conv3x3", symbol, 4, 6)
    conv3x3.launches += 1
    check_launch(f(xb.data_ptr(), wb.data_ptr(), bf.data_ptr(), y.data_ptr(),
                   n, h, wd, c, o, int(pad_mode == "reflect"), stream_of(xb)),
                 symbol)
    return y


def _dgrad(g: torch.Tensor, w: torch.Tensor, pad_mode: str, conv):
    """dx [N, H, W, C] f32 from g [N, H, W, O]: `conv` (zero padding, f32
    out) of g with w rotated by 180 degrees and io-transposed; under
    reflect padding the full correlation on g zero-padded by one ring,
    then the adjoint of reflect-pad (x_pad[0] = x[1], so dx[1] +=
    dx_pad[0], and so on; the corners compose)."""
    w_rot = w.flip(0, 1).transpose(2, 3)                  # [3, 3, O, C]
    if pad_mode == "same":
        return conv(g, w_rot)
    dxp = conv(F.pad(g, (0, 0, 1, 1, 1, 1)), w_rot)       # [N, H+2, W+2, C]
    dx = dxp[:, 1:-1, 1:-1].clone()
    dx[:, 1, :] += dxp[:, 0, 1:-1]
    dx[:, -2, :] += dxp[:, -1, 1:-1]
    dx[:, :, 1] += dxp[:, 1:-1, 0]
    dx[:, :, -2] += dxp[:, 1:-1, -1]
    dx[:, 1, 1] += dxp[:, 0, 0]
    dx[:, 1, -2] += dxp[:, 0, -1]
    dx[:, -2, 1] += dxp[:, -1, 0]
    dx[:, -2, -2] += dxp[:, -1, -1]
    return dx


def conv3x3_dgrad_torch(g: torch.Tensor, w: torch.Tensor,
                        pad_mode: str = "same") -> torch.Tensor:
    """Plain version of the data gradient, f32 [N, H, W, C]."""
    return _dgrad(g, w, pad_mode, _conv_f32_torch)


def conv3x3_dgrad(g: torch.Tensor, w: torch.Tensor,
                  pad_mode: str = "same") -> torch.Tensor:
    """Data gradient of conv3x3: g [N, H, W, O] (bf16 on the card), w
    [3, 3, C, O] -> dx [N, H, W, C] f32; K3 with an f32 output."""
    if not use_kernel(g, w):
        return conv3x3_dgrad_torch(g, w, pad_mode)
    zeros = torch.zeros(w.shape[2], dtype=torch.float32, device=g.device)
    return _dgrad(g, w, pad_mode,
                  lambda a, k: _launch_k3(a, k, zeros, "same", torch.float32))


def conv3x3_wgrad_torch(x: torch.Tensor, g: torch.Tensor,
                        pad_mode: str = "same") -> torch.Tensor:
    """Plain version of the weight gradient: per tap, the f32 sum over
    pixels of x_pad[.. + (dy, dx)] (x) g, from operands rounded to x's
    dtype -> [3, 3, C, O] f32."""
    n, h, wd, c = x.shape
    xf = x.to(torch.float32).permute(0, 3, 1, 2)
    xp = F.pad(xf, (1, 1, 1, 1),
               mode="reflect" if pad_mode == "reflect" else "constant")
    xp = xp.permute(0, 2, 3, 1)
    gf = g.to(x.dtype).to(torch.float32)
    taps = [torch.einsum("nhwc,nhwo->co", xp[:, dy:dy + h, dx:dx + wd], gf)
            for dy in range(3) for dx in range(3)]
    return torch.stack(taps).reshape(3, 3, c, g.shape[-1])


def wgrad_splits(n_pix: int, c: int, o: int) -> tuple[int, int]:
    """(splits, chunk) of K3b's split-K: about WGRAD_TARGET_BLOCKS blocks
    over the card, each summing `chunk` pixels (a multiple of 32).  Fixed
    by the shapes alone, so a rerun adds in the same order."""
    tiles = -(-c // WGRAD_TILE) * -(-o // WGRAD_TILE) * 9
    steps = -(-n_pix // WGRAD_BK)
    want = max(1, min(steps, -(-WGRAD_TARGET_BLOCKS // tiles)))
    chunk = -(-steps // want) * WGRAD_BK
    return -(-n_pix // chunk), chunk


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor,
                  pad_mode: str = "same") -> torch.Tensor:
    """Weight gradient of conv3x3: x [N, H, W, C] and g [N, H, W, O], both
    bf16 on the card -> dW [3, 3, C, O] f32 (K3b, deterministic)."""
    if not use_kernel(x, g):
        return conv3x3_wgrad_torch(x, g, pad_mode)
    n, h, wd, c = x.shape
    o = g.shape[-1]
    if pad_mode == "reflect" and (h < 2 or wd < 2):
        raise ValueError("reflect padding needs H, W >= 2")
    xb, gb = x.contiguous(), g.contiguous()
    require(xb, "x", torch.bfloat16, (n, h, wd, c))
    require(gb, "g", torch.bfloat16, (n, h, wd, o))
    splits, chunk = wgrad_splits(n * h * wd, c, o)
    dw = torch.empty((3, 3, c, o), dtype=torch.float32, device=x.device)
    part = (torch.empty(splits * 9 * c * o, dtype=torch.float32,
                        device=x.device) if splits > 1 else dw)
    f = _build.fn("conv3x3_wgrad", "rnr_conv3x3_wgrad", 4, 8)
    conv3x3_wgrad.launches += 1
    check_launch(f(xb.data_ptr(), gb.data_ptr(), part.data_ptr(),
                   dw.data_ptr(), n, h, wd, c, o,
                   int(pad_mode == "reflect"), splits, chunk, stream_of(xb)),
                 "conv3x3_wgrad")
    return dw


class Conv3x3Fn(torch.autograd.Function):
    """conv3x3 forward and backward: K3 / K3 f32-out / K3b on CUDA
    tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, x, w, b, pad_mode):
        ctx.pad_mode = pad_mode
        ctx.save_for_backward(x, w)
        if use_kernel(x, w, b):
            return _launch_k3(x, w, b, pad_mode, torch.bfloat16)
        return conv3x3_torch(x, w, b, pad_mode)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b, _ = ctx.needs_input_grad
        g = g.to(x.dtype)
        dx = (conv3x3_dgrad(g, w, ctx.pad_mode).to(x.dtype)
              if need_x else None)
        dw = conv3x3_wgrad(x, g, ctx.pad_mode) if need_w else None
        db = g.to(torch.float32).sum(dim=(0, 1, 2)) if need_b else None
        return dx, dw, db, None


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            pad_mode: str = "same") -> torch.Tensor:
    """x [N, H, W, C], w [3, 3, C, O], b [O] -> [N, H, W, O] in x.dtype,
    differentiable in x, w and b.  The kernels take bf16 activations."""
    if pad_mode not in ("same", "reflect"):
        raise ValueError(f"pad_mode {pad_mode!r}")
    return Conv3x3Fn.apply(x, w, b, pad_mode)


conv3x3.launches = 0
conv3x3_wgrad.launches = 0
