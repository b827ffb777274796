"""K6: the 4x4 stride-2 conv `down4` and transpose conv `convt4`
(csrc/conv4x4.cu); K8's 4x4 pair, the same two functions in the slab
formulation, `down4s` and `convt4s` (csrc/conv4x4_slab.cu); their plain
versions, and the four autograd.Functions with rnr_tpu's VJPs.

Replaces rnr_tpu/ops/conv_pallas.py::down4 / convt4 / down4s / convt4s
(:747, :787, :1207, :1338), as the U-Net calls them under conv_backend
"pallas" (K6) and "p3s4" (K8's pair): NHWC activations, HWIO weights
[4, 4, C, O] cast to the activation dtype, f32 sums, no bias (the U-Net
adds it after, in the activation dtype).

- down4(x, w, pad_mode): out[i, j] = sum_{dy, dx < 4} xp[2i + dy,
  2j + dx] w[dy, dx], with xp = x and a ring of 1 (zero, "same", or
  reflect): [N, H, W, C] -> [N, H//2, W//2, O].  H//2 at odd sizes too,
  as rnr_tpu's kernels (XLA's conv would give ceil(H/2)).
- convt4(x, w): jax.lax.conv_transpose(x, w, (2, 2), "SAME") with
  transpose_kernel=False, a correlation on the 2x-dilated input.  Per
  output parity (a, b) it is a 2x2 correlation on x zero-padded by 1:
  out[2t + a, 2s + b] = sum_{r, q < 2} xq[t + a + r, s + b + q]
  w[a + 2r, b + 2q]: [N, H, W, C] -> [N, 2H, 2W, O].

The VJPs are rnr_tpu's (conv_pallas.py:763-806, 1218-1221, 1347-1355).
The output gradient g is cast to x's dtype.  dx of down4 and of down4s
under "same" is K6's convt4 of g with the flipped, io-swapped kernel,
f32 out, cast to x's dtype; under "reflect" dx and dw are the plain
conv's, as rnr_tpu leaves them to XLA.  dx of convt4 is down4 ("same",
f32 out), of convt4s down4s.  dw is the plain conv's weight gradient at
x's dtype (cuDNN on the card, where rnr_tpu has XLA's), cast to f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rnr_tpu_torch.ops import _build
from rnr_tpu_torch.ops.backend import (check_launch, require, stream_of,
                                       use_kernel)

_conv_bwd = torch.ops.aten.convolution_backward


def _check_pad(pad_mode: str) -> None:
    if pad_mode not in ("same", "reflect"):
        raise ValueError(f"pad_mode {pad_mode!r}")


def _ring(xn: torch.Tensor, pad_mode: str) -> torch.Tensor:
    """NCHW x with a ring of 1: reflected, or zeros."""
    return F.pad(xn, (1, 1, 1, 1),
                 mode="reflect" if pad_mode == "reflect" else "constant")


def _flip_io(w: torch.Tensor) -> torch.Tensor:
    """[4, 4, C, O] -> [4, 4, O, C], spatially flipped: the kernel of the
    data gradient (each conv's adjoint is the other's correlation)."""
    return w.flip(0, 1).transpose(2, 3)


def down4_torch(x: torch.Tensor, w: torch.Tensor, pad_mode: str = "same",
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version of down4 / down4s: F.conv2d at stride 2 on the
    ring-padded NCHW view, in f32 from operands rounded to x's dtype,
    rounded to `out_dtype` (x's dtype when None)."""
    _check_pad(pad_mode)
    dt = x.dtype
    xf = _ring(x.to(torch.float32).permute(0, 3, 1, 2), pad_mode)
    wf = w.to(dt).to(torch.float32).permute(3, 2, 0, 1)
    y = F.conv2d(xf, wf, stride=2)
    return y.permute(0, 2, 3, 1).to(out_dtype or dt)


def convt4_torch(x: torch.Tensor, w: torch.Tensor,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version of convt4 / convt4s: F.conv_transpose2d at stride 2,
    padding 1, with the flipped kernel as [C, O, 4, 4], in f32 from
    operands rounded to x's dtype, rounded to `out_dtype`."""
    dt = x.dtype
    xf = x.to(torch.float32).permute(0, 3, 1, 2)
    kf = w.to(dt).to(torch.float32).flip(0, 1).permute(2, 3, 0, 1)
    y = F.conv_transpose2d(xf, kf, stride=2, padding=1)
    return y.permute(0, 2, 3, 1).to(out_dtype or dt)


def _launch(lib: str, symbol: str, counter, x: torch.Tensor,
            w: torch.Tensor, out_shape: tuple, out_dtype, pad: tuple = ()
            ) -> torch.Tensor:
    """One launch of a 4x4 kernel (bf16 or f32 output); counts in
    `counter.launches`.  `pad` is (reflect,) for the down convs."""
    n, h, wd, c = x.shape
    o = w.shape[-1]
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{symbol}: output dtype {out_dtype}, the kernel "
                        "writes bf16 or f32")
    if min(out_shape) < 1:
        raise ValueError(f"{symbol}: empty output {out_shape} from x "
                         f"{tuple(x.shape)}")
    xb = x.contiguous()
    require(xb, "x", torch.bfloat16, (n, h, wd, c))
    wb = w.to(torch.bfloat16).contiguous()
    require(wb, "w", torch.bfloat16, (4, 4, c, o))
    y = torch.empty(out_shape, dtype=out_dtype, device=x.device)
    if out_dtype == torch.float32:
        symbol += "_f32out"
    f = _build.fn(lib, symbol, 3, 5 + len(pad))
    counter.launches += 1
    check_launch(f(xb.data_ptr(), wb.data_ptr(), y.data_ptr(), n, h, wd, c,
                   o, *pad, stream_of(xb)), symbol)
    return y


def _launch_down(lib, symbol, counter, x, w, pad_mode, out_dtype):
    _check_pad(pad_mode)
    n, h, wd, _ = x.shape
    if pad_mode == "reflect" and (h < 2 or wd < 2):
        raise ValueError("reflect padding needs H, W >= 2")
    return _launch(lib, symbol, counter, x, w,
                   (n, h // 2, wd // 2, w.shape[-1]), out_dtype,
                   (int(pad_mode == "reflect"),))


def _launch_up(lib, symbol, counter, x, w, out_dtype):
    n, h, wd, _ = x.shape
    return _launch(lib, symbol, counter, x, w,
                   (n, 2 * h, 2 * wd, w.shape[-1]), out_dtype)


def down4_fwd(x: torch.Tensor, w: torch.Tensor, pad_mode: str = "same",
              out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The 4x4 stride-2 conv, tap-wise (K6 on CUDA tensors, the plain
    version on CPU tensors), not differentiable: x [N, H, W, C] (bf16 on
    the card), w [4, 4, C, O] -> [N, H//2, W//2, O] in `out_dtype`."""
    if not use_kernel(x, w):
        return down4_torch(x, w, pad_mode, out_dtype)
    return _launch_down("conv4x4", "rnr_down4", down4, x, w, pad_mode,
                        out_dtype)


def convt4_fwd(x: torch.Tensor, w: torch.Tensor,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The 4x4 stride-2 "SAME" transpose conv, by parity (K6 on CUDA
    tensors, the plain version on CPU tensors), not differentiable:
    x [N, H, W, C], w [4, 4, C, O] -> [N, 2H, 2W, O] in `out_dtype`."""
    if not use_kernel(x, w):
        return convt4_torch(x, w, out_dtype)
    return _launch_up("conv4x4", "rnr_convt4", convt4, x, w, out_dtype)


def down4s_fwd(x: torch.Tensor, w: torch.Tensor, pad_mode: str = "same",
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """down4_fwd in the slab formulation (K8's down4s on CUDA tensors)."""
    if not use_kernel(x, w):
        return down4_torch(x, w, pad_mode, out_dtype)
    return _launch_down("conv4x4_slab", "rnr_down4s", down4s, x, w,
                        pad_mode, out_dtype)


def convt4s_fwd(x: torch.Tensor, w: torch.Tensor,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """convt4_fwd in the slab formulation (K8's convt4s on CUDA tensors)."""
    if not use_kernel(x, w):
        return convt4_torch(x, w, out_dtype)
    return _launch_up("conv4x4_slab", "rnr_convt4s", convt4s, x, w,
                      out_dtype)


# ------------------------------------------------------------- gradients


def _down4_plain_grads(x, w, g, pad_mode, need_x, need_w):
    """(dx, dw) of the plain down conv at x's dtype: the conv's own
    backward on the ring-padded input, then the adjoint of the reflect
    ring (or padding 1 in the conv itself under "same")."""
    xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    wk = w.to(x.dtype).permute(3, 2, 0, 1)
    reflect = pad_mode == "reflect"
    xp = _ring(xn, pad_mode) if reflect else xn
    dxp, dwk, _ = _conv_bwd(gn, xp, wk, None, [2, 2],
                            [0, 0] if reflect else [1, 1], [1, 1], False,
                            [0, 0], 1, [need_x, need_w, False])
    dx = dw = None
    if need_x:
        if reflect:
            dxp = torch.ops.aten.reflection_pad2d_backward(dxp, xn,
                                                           [1, 1, 1, 1])
        dx = dxp.permute(0, 2, 3, 1)
    if need_w:
        dw = dwk.permute(2, 3, 1, 0).to(w.dtype)
    return dx, dw


def _down4_vjp(ctx, g):
    x, w = ctx.saved_tensors
    need_x, need_w = ctx.needs_input_grad[:2]
    g = g.to(x.dtype)
    if ctx.pad_mode == "reflect":
        return _down4_plain_grads(x, w, g, "reflect", need_x, need_w)
    dx = dw = None
    if need_x:
        if x.shape[1] % 2 or x.shape[2] % 2:
            # the transpose conv gives 2 (H//2) rows; rnr_tpu's VJP fails
            # on that shape as well
            raise ValueError(f"down4's data gradient under 'same' needs "
                             f"even H and W, got {tuple(x.shape[1:3])}")
        dx = convt4_fwd(g, _flip_io(w), torch.float32).to(x.dtype)
    if need_w:
        dw = _down4_plain_grads(x, w, g, "same", False, True)[1]
    return dx, dw


def _convt4_vjp(ctx, g, down_fwd):
    """(dx, dw) of a transpose conv: dx from `down_fwd` ("same", f32 out)
    on g with the flipped, io-swapped kernel; dw the plain transpose
    conv's weight gradient at x's dtype."""
    x, w = ctx.saved_tensors
    need_x, need_w = ctx.needs_input_grad[:2]
    g = g.to(x.dtype)
    dx = dw = None
    if need_x:
        dx = down_fwd(g, _flip_io(w), "same", torch.float32).to(x.dtype)
    if need_w:
        kt = w.to(x.dtype).flip(0, 1).permute(2, 3, 0, 1)     # [C, O, 4, 4]
        dk = _conv_bwd(g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), kt,
                       None, [2, 2], [1, 1], [1, 1], True, [0, 0], 1,
                       [False, True, False])[1]
        dw = dk.permute(2, 3, 0, 1).flip(0, 1).to(w.dtype)
    return dx, dw


class Down4Fn(torch.autograd.Function):
    """down4: K6 forward; dx by K6's convt4 under "same"."""

    @staticmethod
    def forward(ctx, x, w, pad_mode):
        ctx.pad_mode = pad_mode
        ctx.save_for_backward(x, w)
        return down4_fwd(x, w, pad_mode)

    @staticmethod
    def backward(ctx, g):
        return (*_down4_vjp(ctx, g), None)


class Down4sFn(torch.autograd.Function):
    """down4s: K8's down4s forward; the backward of down4 (K6's convt4
    for dx under "same"), as rnr_tpu's `_down4s_bwd`."""

    @staticmethod
    def forward(ctx, x, w, pad_mode):
        ctx.pad_mode = pad_mode
        ctx.save_for_backward(x, w)
        return down4s_fwd(x, w, pad_mode)

    @staticmethod
    def backward(ctx, g):
        return (*_down4_vjp(ctx, g), None)


class Convt4Fn(torch.autograd.Function):
    """convt4: K6 forward; dx by K6's down4."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return convt4_fwd(x, w)

    @staticmethod
    def backward(ctx, g):
        return _convt4_vjp(ctx, g, down4_fwd)


class Convt4sFn(torch.autograd.Function):
    """convt4s: K8's convt4s forward; dx by K8's down4s."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return convt4s_fwd(x, w)

    @staticmethod
    def backward(ctx, g):
        return _convt4_vjp(ctx, g, down4s_fwd)


def down4(x: torch.Tensor, w: torch.Tensor,
          pad_mode: str = "same") -> torch.Tensor:
    """x [N, H, W, C], w [4, 4, C, O] -> [N, H//2, W//2, O] in x.dtype,
    differentiable in x and w; K6 on the card (bf16 activations)."""
    _check_pad(pad_mode)
    return Down4Fn.apply(x, w, pad_mode)


def down4s(x: torch.Tensor, w: torch.Tensor,
           pad_mode: str = "same") -> torch.Tensor:
    """down4 through K8's slab kernel."""
    _check_pad(pad_mode)
    return Down4sFn.apply(x, w, pad_mode)


def convt4(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [N, H, W, C], w [4, 4, C, O] -> [N, 2H, 2W, O] in x.dtype,
    differentiable in x and w; K6 on the card (bf16 activations)."""
    return Convt4Fn.apply(x, w)


def convt4s(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """convt4 through K8's slab kernel."""
    return Convt4sFn.apply(x, w)


down4.launches = 0
convt4.launches = 0
down4s.launches = 0
convt4s.launches = 0
