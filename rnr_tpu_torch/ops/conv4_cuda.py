"""K6: the 4x4 stride-2 conv `down4` and transpose conv `convt4`
(csrc/conv4x4.cu, planned by `conv4_plan`); K8's 4x4 pair `down4s` and
`convt4s` (csrc/conv4x4_slab.cu, planned by `conv4s_plan`): the same two
functions as implicit GEMMs on wgmma over TMA bands, K6 with units of a
parity plane's four taps (down4) or an output row parity's eight
(convt4), K8 with units of two taps of one input row; their plain
versions, and the four autograd.Functions with rnr_tpu's VJPs.

Replaces rnr_tpu/ops/conv_pallas.py::down4 / convt4 / down4s / convt4s
(:747, :787, :1207, :1338), as the U-Net calls them under conv_backend
"pallas" (K6) and "p3s4" (K8's pair): NHWC activations, HWIO weights
[4, 4, C, O] cast to the activation dtype, f32 sums, no bias (the U-Net
adds it after, in the activation dtype).  The kernels multiply bf16;
f32 activations take three launches on bf16 parts
(`conv_cuda.f32_by_three`).

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
from rnr_tpu_torch.ops.conv_cuda import (f32_by_three, k3_weights,
                                         pad_channels, reflect_ring_adjoint,
                                         round8)

# K8's tiling (csrc/conv4x4_slab.cu): input channels per reduction unit,
# the blocks of one wave on the H100 (132 SMs), the fewest units a split
# of K takes; K6's (csrc/conv4x4.cu) has the same channels and wave and
# units of four (down4) or eight (convt4) taps, so fewer a split
K8_UNIT = 64
K8_TARGET_BLOCKS = 132
K8_MIN_UNITS = 4
K6_MIN_UNITS = 2

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


def _check_down(x: torch.Tensor, pad_mode: str) -> None:
    _check_pad(pad_mode)
    if pad_mode == "reflect" and min(x.shape[1:3]) < 2:
        raise ValueError("reflect padding needs H, W >= 2")


def _output(symbol: str, x: torch.Tensor, w: torch.Tensor, up: bool,
            out_dtype) -> torch.Tensor:
    """The empty output of a 4x4 kernel: [N, 2H, 2W, O] (up) or [N, H//2,
    W//2, O], bf16 or f32 (x's dtype when None)."""
    n, h, wd, _ = x.shape
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{symbol}: output dtype {out_dtype}, the kernel "
                        "writes bf16 or f32")
    o = w.shape[-1]
    shape = (n, 2 * h, 2 * wd, o) if up else (n, h // 2, wd // 2, o)
    if min(shape) < 1:
        raise ValueError(f"{symbol}: empty output {shape} from x "
                         f"{tuple(x.shape)}")
    return torch.empty(shape, dtype=out_dtype, device=x.device)


def conv4s_plan(n: int, h: int, wd: int, c8: int, o: int,
                up: bool) -> tuple[int, int, int, int, int]:
    """(bn, wgs, sw, splits, per) of K8's launch for x [N, H, W, c8] (c8 a
    multiple of 8) and O outputs: down4s (up False) over the [N, H//2,
    W//2] output grid, convt4s over the [N, H, W] input grid per output
    row parity.  BN = 64 or 128 outputs a tile; wgs consumer warpgroups of
    64 GEMM rows each; a tile's 64 wgs rows are row segments of sw
    positions: sw = 16 or 32 where a row has at most 32 positions (then
    one warpgroup), else 64, or 128 where rows have 128 positions or
    more.  Two warpgroups where their tiles fill half a wave (rows of 64
    to 127 positions) or a wave (longer rows).  Where the tiles fill less
    than a wave, the reduction's units (8 (down4s) or 4 (convt4s) a
    64-channel chunk) are cut into `splits` runs of `per`, at most
    K8_TARGET_BLOCKS tiles in all and at least K8_MIN_UNITS units a run.
    Fixed by the shapes alone, so a rerun adds in the same order."""
    gh, gw = (h, wd) if up else (h // 2, wd // 2)
    rows = n * gh
    bn = 64 if round8(o) <= 64 else 128
    par = 2 if up else 1

    def tiles(bm: int, sw: int) -> int:
        return (-(-gw // sw) * -(-rows // (bm // sw)) * -(-o // bn) * par)

    if gw <= 32:
        wgs, sw = 1, (16 if gw <= 16 else 32)
    elif gw < 128:
        wgs = 2 if tiles(128, 64) >= K8_TARGET_BLOCKS // 2 else 1
        sw = 64
    else:
        wgs = 2 if tiles(128, 128) >= K8_TARGET_BLOCKS else 1
        sw = 64 * wgs
    units = (4 if up else 8) * -(-c8 // K8_UNIT)
    want = max(1, min(K8_TARGET_BLOCKS // tiles(64 * wgs, sw),
                      units // K8_MIN_UNITS))
    per = -(-units // want)
    return bn, wgs, sw, -(-units // per), per


def conv4_plan(n: int, h: int, wd: int, c8: int, o: int,
               up: bool) -> tuple[int, int, int, int, int]:
    """(bn, wgs, sw, splits, per) of K6's launch for x [N, H, W, c8] (c8 a
    multiple of 8) and O outputs: down4 (up False) over the [N, H//2,
    W//2] output grid, convt4 over the [N, H, W] input grid, all four
    output parities in one tile.  BN = 64 outputs a tile, or 128 for
    down4 where O > 64 (convt4's four accumulators take BN 64); wgs
    consumer warpgroups of 64 GEMM rows each; a tile's 64 wgs rows are
    64 wgs / sw row segments of sw positions of one image: sw = 16 or 32
    where a row has at most 32 positions (then one warpgroup), else 64.
    Two warpgroups where their tiles fill half a wave.  Where the tiles
    fill less than a wave, the reduction's units (4 (down4: the parity
    planes) or 2 (convt4: the output row parities) a 64-channel chunk)
    are cut into `splits` runs of `per`, at most K8_TARGET_BLOCKS tiles
    in all and at least K6_MIN_UNITS units a run; convt4's runs are whole
    chunks (per even), so the kernel takes both parities a in turn.
    Fixed by the shapes alone, so a rerun adds in the same order."""
    gh, gw = (h, wd) if up else (h // 2, wd // 2)
    bn = 64 if up or round8(o) <= 64 else 128

    def tiles(wgs: int, sw: int) -> int:
        rows = 64 * wgs // sw
        return n * -(-gh // rows) * -(-gw // sw) * -(-o // bn)

    if gw <= 32:
        wgs, sw = 1, (16 if gw <= 16 else 32)
    else:
        sw = 64
        wgs = 2 if tiles(2, sw) >= K8_TARGET_BLOCKS // 2 else 1
    units = (2 if up else 4) * -(-c8 // K8_UNIT)
    want = max(1, min(K8_TARGET_BLOCKS // tiles(wgs, sw),
                      units // K6_MIN_UNITS))
    per = -(-units // want)
    if up:
        per += per % 2
    return bn, wgs, sw, -(-units // per), per


def _launch(lib: str, plan, symbol: str, counter, x: torch.Tensor,
            w: torch.Tensor, up: bool, pad: tuple,
            out_dtype) -> torch.Tensor:
    """One launch of a 4x4 kernel of `lib` (K6's csrc/conv4x4.cu planned
    by conv4_plan, or K8's csrc/conv4x4_slab.cu by conv4s_plan), bf16 or
    f32 output, its split-K sum included; counts in `counter.launches`.
    C % 8 != 0 is padded with zero channels first, O with zero weights.
    `pad` is (reflect,) for the down convs.  f32 x with an f32 output:
    three launches on bf16 parts, `conv_cuda.f32_by_three`."""
    n, h, wd, c = x.shape
    o = w.shape[-1]
    if x.dtype == torch.float32 and out_dtype in (None, torch.float32):
        return f32_by_three(
            lambda xp, wp, _: _launch(lib, plan, symbol, counter, xp, wp, up,
                                      pad, torch.float32),
            x, w.to(torch.float32))
    y = _output(symbol, x, w, up, out_dtype)
    xc = x.contiguous()
    require(xc, "x", torch.bfloat16, (n, h, wd, c))
    c8 = round8(c)
    xb = pad_channels(xc, c8)
    wb = k3_weights(w, c8)
    require(wb, "w", torch.bfloat16, (4, 4, c8, round8(o)))
    bn, wgs, sw, splits, per = plan(n, h, wd, c8, o, up)
    part = (torch.empty(splits * y.numel(), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    if y.dtype == torch.float32:
        symbol += "_f32out"
    f = _build.fn(lib, symbol, 4, 10 + len(pad))
    counter.launches += 1
    check_launch(f(xb.data_ptr(), wb.data_ptr(), y.data_ptr(),
                   None if part is None else part.data_ptr(), n, h, wd, c8,
                   o, *pad, bn, wgs, sw, splits, per, stream_of(xb)), symbol)
    return y


def down4_fwd(x: torch.Tensor, w: torch.Tensor, pad_mode: str = "same",
              out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The 4x4 stride-2 conv by parity plane (K6 on CUDA tensors, the
    plain version on CPU tensors), not differentiable: x [N, H, W, C]
    (bf16 on the card), w [4, 4, C, O] -> [N, H//2, W//2, O] in
    `out_dtype`."""
    if not use_kernel(x, w):
        return down4_torch(x, w, pad_mode, out_dtype)
    _check_down(x, pad_mode)
    return _launch("conv4x4", conv4_plan, "rnr_down4", down4, x, w, False,
                   (int(pad_mode == "reflect"),), out_dtype)


def convt4_fwd(x: torch.Tensor, w: torch.Tensor,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The 4x4 stride-2 "SAME" transpose conv, by parity (K6 on CUDA
    tensors, the plain version on CPU tensors), not differentiable:
    x [N, H, W, C], w [4, 4, C, O] -> [N, 2H, 2W, O] in `out_dtype`."""
    if not use_kernel(x, w):
        return convt4_torch(x, w, out_dtype)
    return _launch("conv4x4", conv4_plan, "rnr_convt4", convt4, x, w, True,
                   (), out_dtype)


def down4s_fwd(x: torch.Tensor, w: torch.Tensor, pad_mode: str = "same",
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """down4_fwd through K8's down4s on CUDA tensors (the plain version
    on CPU tensors)."""
    if not use_kernel(x, w):
        return down4_torch(x, w, pad_mode, out_dtype)
    _check_down(x, pad_mode)
    return _launch("conv4x4_slab", conv4s_plan, "rnr_down4s", down4s, x, w,
                   False, (int(pad_mode == "reflect"),), out_dtype)


def convt4s_fwd(x: torch.Tensor, w: torch.Tensor,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """convt4_fwd through K8's convt4s on CUDA tensors (the plain version
    on CPU tensors)."""
    if not use_kernel(x, w):
        return convt4_torch(x, w, out_dtype)
    return _launch("conv4x4_slab", conv4s_plan, "rnr_convt4s", convt4s, x,
                   w, True, (), out_dtype)


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
        dx = dxp.permute(0, 2, 3, 1)
        if reflect:
            dx = reflect_ring_adjoint(dx)
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
    """down4 through K8's down4s kernel."""
    _check_pad(pad_mode)
    return Down4sFn.apply(x, w, pad_mode)


def convt4(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [N, H, W, C], w [4, 4, C, O] -> [N, 2H, 2W, O] in x.dtype,
    differentiable in x and w; K6 on the card (bf16 activations)."""
    return Convt4Fn.apply(x, w)


def convt4s(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """convt4 through K8's convt4s kernel."""
    return Convt4sFn.apply(x, w)


down4.launches = 0
convt4.launches = 0
down4s.launches = 0
convt4s.launches = 0
