"""The U-Net's 3x3 stride-1 conv in two formulations, each bound into one
autograd.Function with its plain versions:

- K3, tap-wise (csrc/conv3x3.cu), its data gradient (K3 with an f32
  output) and K3b, its weight gradient (csrc/conv3x3_wgrad.cu):
  rnr_tpu/ops/conv_pallas.py::conv3x3, as conv_backend "pallas3",
  "pallas" and "p3s4" call it.
- K8a, the slab formulation (csrc/conv3x3_slab.cu), its data gradient
  (K8a with an f32 output) and K8b, its weight gradient
  (csrc/conv3x3_slab_wgrad.cu): rnr_tpu/ops/conv_pallas.py::conv3x3s, as
  conv_backend "slab3" and "slab" call it.  Its plain versions are
  written in the slab formulation too: the [N, H, W+2, 3C] slab of the
  three padded input rows, one product with the packed [3C, 3O] weights
  (`_pack_w_slab`, :907), the three column-shifted O-bands summed.

Both with rnr_tpu's custom VJP at fuse_act=False, as the U-Net calls
them: NHWC activations, HWIO weights cast to the activation dtype, f32
accumulation, + bias in f32, output in the activation dtype; zero
("same") or reflect padding.  The backward is that of `_conv3x3_bwd`
(:409) and `_conv3x3s_bwd` (:1054): the output gradient cast to the
activation dtype; db = sum(g) in f32; dx = the forward's f32-output
kernel on g with the rotated, io-transposed weights, under reflect
padding run on g zero-padded by one ring and folded back with the exact
adjoint of reflect-pad; dW from the weight-gradient kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rnr_tpu_torch.ops import _build
from rnr_tpu_torch.ops.backend import (check_launch, require, stream_of,
                                       use_kernel)

# split-K of the weight gradients: csrc/conv3x3_wgrad.cu's BM = BN and
# csrc/conv3x3_slab_wgrad.cu's BM = NB, and both kernels' pixels per K step
WGRAD_TILE = 64
WGRAD_BK = 32
WGRAD_TARGET_BLOCKS = 1024


def _check_pad(pad_mode: str) -> None:
    if pad_mode not in ("same", "reflect"):
        raise ValueError(f"pad_mode {pad_mode!r}")


def _pad_nhwc(x: torch.Tensor, pad_mode: str) -> torch.Tensor:
    """NHWC x with a ring of 1 (reflected, or zeros)."""
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1),
               mode="reflect" if pad_mode == "reflect" else "constant")
    return xp.permute(0, 2, 3, 1)


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


def _slab(x: torch.Tensor, pad_mode: str) -> torch.Tensor:
    """[N, H, W, C] -> the f32 slab [N, H, W+2, 3C]: per output row, the
    three padded input rows stacked on channels (rnr_tpu's `_make_slab`
    without its TPU padding)."""
    h = x.shape[1]
    xp = _pad_nhwc(x.to(torch.float32), pad_mode)
    return torch.cat([xp[:, 0:h], xp[:, 1:h + 1], xp[:, 2:h + 2]], dim=-1)


def conv3x3s_torch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   pad_mode: str = "same",
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version of K8a, in the slab formulation: Y = slab [N, H, W+2,
    3C] times the packed weights [3C, 3O] ([dy C + c, dx O + o] =
    w[dy, dx, c, o], cast to x's dtype), in f32; out[.., j, :] = Y[.., j,
    0:O] + Y[.., j+1, O:2O] + Y[.., j+2, 2O:3O] + b, rounded once to
    `out_dtype` (x's dtype when None)."""
    _check_pad(pad_mode)
    n, h, wd, c = x.shape
    o = w.shape[-1]
    wcat = w.to(x.dtype).to(torch.float32).permute(0, 2, 1, 3).reshape(
        3 * c, 3 * o)
    y = _slab(x, pad_mode) @ wcat                       # [N, H, W+2, 3O]
    acc = (y[:, :, 0:wd, 0:o] + y[:, :, 1:1 + wd, o:2 * o]
           + y[:, :, 2:2 + wd, 2 * o:3 * o])
    return (acc + b.to(torch.float32)).to(out_dtype or x.dtype)


def _launch(lib: str, symbol: str, counter, x: torch.Tensor,
            w: torch.Tensor, b: torch.Tensor, pad_mode: str,
            out_dtype: torch.dtype) -> torch.Tensor:
    """One launch of K3 or K8a, `symbol` of csrc/`lib`.cu (`symbol`_f32out
    for an f32 output); counts in `counter.launches`."""
    n, h, wd, c = x.shape
    o = w.shape[-1]
    if pad_mode == "reflect" and (h < 2 or wd < 2):
        raise ValueError("reflect padding needs H, W >= 2")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{symbol}: output dtype {out_dtype}, the kernel "
                        "writes bf16 or f32")
    xb = x.contiguous()
    require(xb, "x", torch.bfloat16, (n, h, wd, c))
    wb = w.to(torch.bfloat16).contiguous()
    require(wb, "w", torch.bfloat16, (3, 3, c, o))
    bf = b.to(torch.float32).contiguous()
    require(bf, "b", torch.float32, (o,))
    y = torch.empty((n, h, wd, o), dtype=out_dtype, device=x.device)
    if out_dtype == torch.float32:
        symbol += "_f32out"
    f = _build.fn(lib, symbol, 4, 6)
    counter.launches += 1
    check_launch(f(xb.data_ptr(), wb.data_ptr(), bf.data_ptr(), y.data_ptr(),
                   n, h, wd, c, o, int(pad_mode == "reflect"), stream_of(xb)),
                 symbol)
    return y


def conv3x3s_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 pad_mode: str = "same",
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The slab conv, not differentiable (K8a on CUDA tensors, the plain
    version on CPU tensors): x [N, H, W, C] (bf16 on the card), w
    [3, 3, C, O], b [O] -> [N, H, W, O] in `out_dtype` (x's when None)."""
    _check_pad(pad_mode)
    if not use_kernel(x, w, b):
        return conv3x3s_torch(x, w, b, pad_mode, out_dtype)
    return _launch("conv3x3_slab", "rnr_conv3x3s", conv3x3s, x, w, b,
                   pad_mode, out_dtype or x.dtype)


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
                  lambda a, k: _launch("conv3x3", "rnr_conv3x3", conv3x3, a,
                                       k, zeros, "same", torch.float32))


def _slab_dgrad_conv(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    zeros = torch.zeros(k.shape[-1], dtype=torch.float32, device=a.device)
    return conv3x3s_fwd(a, k, zeros, "same", torch.float32)


def conv3x3s_dgrad_torch(g: torch.Tensor, w: torch.Tensor,
                         pad_mode: str = "same") -> torch.Tensor:
    """Plain version of the slab conv's data gradient, f32 [N, H, W, C]."""
    return _dgrad(g, w, pad_mode, lambda a, k: conv3x3s_torch(
        a, k, torch.zeros(k.shape[-1], device=a.device), "same",
        torch.float32))


def conv3x3s_dgrad(g: torch.Tensor, w: torch.Tensor,
                   pad_mode: str = "same") -> torch.Tensor:
    """Data gradient of conv3x3s: g [N, H, W, O] (bf16 on the card), w
    [3, 3, C, O] -> dx [N, H, W, C] f32; K8a with an f32 output (through
    conv3x3s_fwd)."""
    _check_pad(pad_mode)
    return _dgrad(g, w, pad_mode, _slab_dgrad_conv)


def conv3x3_wgrad_torch(x: torch.Tensor, g: torch.Tensor,
                        pad_mode: str = "same") -> torch.Tensor:
    """Plain version of the weight gradient: per tap, the f32 sum over
    pixels of x_pad[.. + (dy, dx)] (x) g, from operands rounded to x's
    dtype -> [3, 3, C, O] f32."""
    n, h, wd, c = x.shape
    xp = _pad_nhwc(x.to(torch.float32), pad_mode)
    gf = g.to(x.dtype).to(torch.float32)
    taps = [torch.einsum("nhwc,nhwo->co", xp[:, dy:dy + h, dx:dx + wd], gf)
            for dy in range(3) for dx in range(3)]
    return torch.stack(taps).reshape(3, 3, c, g.shape[-1])


def conv3x3s_wgrad_torch(x: torch.Tensor, g: torch.Tensor,
                         pad_mode: str = "same") -> torch.Tensor:
    """Plain version of K8b, in the slab formulation: dWcat [3C, 3O] =
    slab^T g3 in f32, with g3 [N, H, W+2, 3O] holding g (rounded to x's
    dtype) shifted right by dx in band dx, unpacked to [3, 3, C, O]."""
    _check_pad(pad_mode)
    c, o = x.shape[-1], g.shape[-1]
    gf = g.to(x.dtype).to(torch.float32)
    g3 = torch.cat([F.pad(gf, (0, 0, dx, 2 - dx)) for dx in range(3)],
                   dim=-1)
    dwcat = _slab(x, pad_mode).reshape(-1, 3 * c).T @ g3.reshape(-1, 3 * o)
    return dwcat.reshape(3, c, 3, o).permute(0, 2, 1, 3)


def wgrad_splits(n_pix: int, tiles: int) -> tuple[int, int]:
    """(splits, chunk) of K3b's and K8b's split-K over `n_pix` pixels when
    one split has `tiles` blocks: about WGRAD_TARGET_BLOCKS blocks over
    the card, each summing `chunk` pixels (a multiple of 32).  Fixed by
    the shapes alone, so a rerun adds in the same order."""
    steps = -(-n_pix // WGRAD_BK)
    want = max(1, min(steps, -(-WGRAD_TARGET_BLOCKS // tiles)))
    chunk = -(-steps // want) * WGRAD_BK
    return -(-n_pix // chunk), chunk


def _launch_wgrad(lib: str, symbol: str, counter, x: torch.Tensor,
                  g: torch.Tensor, pad_mode: str, n_pix: int,
                  tiles: int) -> torch.Tensor:
    """One launch of K3b or K8b (and its split reduction): x and g bf16,
    the kernel's `n_pix` pixels in splits of `tiles` blocks -> dW
    [3, 3, C, O] f32; counts in `counter.launches`."""
    n, h, wd, c = x.shape
    o = g.shape[-1]
    if pad_mode == "reflect" and (h < 2 or wd < 2):
        raise ValueError("reflect padding needs H, W >= 2")
    xb, gb = x.contiguous(), g.contiguous()
    require(xb, "x", torch.bfloat16, (n, h, wd, c))
    require(gb, "g", torch.bfloat16, (n, h, wd, o))
    splits, chunk = wgrad_splits(n_pix, tiles)
    dw = torch.empty((3, 3, c, o), dtype=torch.float32, device=x.device)
    part = (torch.empty(splits * 9 * c * o, dtype=torch.float32,
                        device=x.device) if splits > 1 else dw)
    f = _build.fn(lib, symbol, 4, 8)
    counter.launches += 1
    check_launch(f(xb.data_ptr(), gb.data_ptr(), part.data_ptr(),
                   dw.data_ptr(), n, h, wd, c, o,
                   int(pad_mode == "reflect"), splits, chunk, stream_of(xb)),
                 symbol)
    return dw


def _tiles(c: int, o: int) -> int:
    return -(-c // WGRAD_TILE) * -(-o // WGRAD_TILE)


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor,
                  pad_mode: str = "same") -> torch.Tensor:
    """Weight gradient of conv3x3: x [N, H, W, C] and g [N, H, W, O], both
    bf16 on the card -> dW [3, 3, C, O] f32 (K3b, deterministic)."""
    if not use_kernel(x, g):
        return conv3x3_wgrad_torch(x, g, pad_mode)
    n, h, wd, c = x.shape
    # a block per 64 x 64 tile of one tap's dW
    return _launch_wgrad("conv3x3_wgrad", "rnr_conv3x3_wgrad", conv3x3_wgrad,
                         x, g, pad_mode, n * h * wd,
                         9 * _tiles(c, g.shape[-1]))


def conv3x3s_wgrad(x: torch.Tensor, g: torch.Tensor,
                   pad_mode: str = "same") -> torch.Tensor:
    """Weight gradient of conv3x3s: x [N, H, W, C] and g [N, H, W, O],
    both bf16 on the card -> dW [3, 3, C, O] f32 (K8b, deterministic)."""
    _check_pad(pad_mode)
    if not use_kernel(x, g):
        return conv3x3s_wgrad_torch(x, g, pad_mode)
    n, h, wd, c = x.shape
    # over the N H (W + 2) slab pixels, a block per band dy's 64 channels
    # and all three dx bands of 64 outputs
    return _launch_wgrad("conv3x3_slab_wgrad", "rnr_conv3x3s_wgrad",
                         conv3x3s_wgrad, x, g, pad_mode, n * h * (wd + 2),
                         3 * _tiles(c, g.shape[-1]))


def _vjp(ctx, g, dgrad, wgrad):
    """(dx, dw, db, None) of rnr_tpu's 3x3 VJP, from the formulation's
    `dgrad` (f32, cast to x's dtype) and `wgrad`."""
    x, w = ctx.saved_tensors
    need_x, need_w, need_b, _ = ctx.needs_input_grad
    g = g.to(x.dtype)
    dx = dgrad(g, w, ctx.pad_mode).to(x.dtype) if need_x else None
    dw = wgrad(x, g, ctx.pad_mode) if need_w else None
    db = g.to(torch.float32).sum(dim=(0, 1, 2)) if need_b else None
    return dx, dw, db, None


class Conv3x3Fn(torch.autograd.Function):
    """conv3x3 forward and backward: K3 / K3 f32-out / K3b on CUDA
    tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, x, w, b, pad_mode):
        ctx.pad_mode = pad_mode
        ctx.save_for_backward(x, w)
        if use_kernel(x, w, b):
            return _launch("conv3x3", "rnr_conv3x3", conv3x3, x, w, b,
                           pad_mode, torch.bfloat16)
        return conv3x3_torch(x, w, b, pad_mode)

    @staticmethod
    def backward(ctx, g):
        return _vjp(ctx, g, conv3x3_dgrad, conv3x3_wgrad)


class Conv3x3SlabFn(torch.autograd.Function):
    """conv3x3s forward and backward: K8a / K8a f32-out / K8b on CUDA
    tensors, their plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, x, w, b, pad_mode):
        ctx.pad_mode = pad_mode
        ctx.save_for_backward(x, w)
        return conv3x3s_fwd(x, w, b, pad_mode)

    @staticmethod
    def backward(ctx, g):
        return _vjp(ctx, g, conv3x3s_dgrad, conv3x3s_wgrad)


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            pad_mode: str = "same") -> torch.Tensor:
    """x [N, H, W, C], w [3, 3, C, O], b [O] -> [N, H, W, O] in x.dtype,
    differentiable in x, w and b.  The kernels take bf16 activations."""
    _check_pad(pad_mode)
    return Conv3x3Fn.apply(x, w, b, pad_mode)


def conv3x3s(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             pad_mode: str = "same") -> torch.Tensor:
    """conv3x3 in the slab formulation (K8a, K8b on the card): the same
    contract, differentiable in x, w and b."""
    _check_pad(pad_mode)
    return Conv3x3SlabFn.apply(x, w, b, pad_mode)


conv3x3.launches = 0
conv3x3_wgrad.launches = 0
conv3x3s.launches = 0
conv3x3s_wgrad.launches = 0
