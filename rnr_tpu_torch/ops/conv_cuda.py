"""The U-Net's 3x3 stride-1 conv in two formulations, each bound into one
autograd.Function with its plain versions:

- K3, tap-wise (csrc/conv3x3.cu), its data gradient (K3 with an f32
  output) and K3b, its weight gradient (csrc/conv3x3_wgrad.cu):
  rnr_tpu/ops/conv_pallas.py::conv3x3, as conv_backend "pallas3",
  "pallas" and "p3s4" call it.  Both run wgmma on TMA-fed bands of the
  input staged once per tap row (csrc/sm90.cuh); they take C and O in
  multiples of 8, so the wrappers pad other counts with zero channels
  (`pad_channels`, `k3_weights`), and K3b's split-K is `k3b_plan`.
- K8a, the slab formulation (csrc/conv3x3_slab.cu), its data gradient
  (K8a with an f32 output) and K8b, its weight gradient
  (csrc/conv3x3_slab_wgrad.cu): rnr_tpu/ops/conv_pallas.py::conv3x3s, as
  conv_backend "slab3" and "slab" call it.  Its plain versions are
  written in the slab formulation too: the [N, H, W+2, 3C] slab of the
  three padded input rows, one product with the packed [3C, 3O] weights
  (`_pack_w_slab`, :907), the three column-shifted O-bands summed.  The
  kernels run wgmma on the same TMA bands as K3 / K3b, the slab's column
  shift a descriptor move (K8a: three accumulators, one per dx band);
  they take the same padded channels, their plans are `k8a_plan` and
  `k8b_plan`.

Both with rnr_tpu's custom VJP at fuse_act=False, as the U-Net calls
them: NHWC activations, HWIO weights cast to the activation dtype, f32
accumulation, + bias in f32, output in the activation dtype; zero
("same") or reflect padding.  The kernels multiply bf16; f32 activations
(rnr_tpu's kernels keep f32 products for them) take three launches on
bf16 parts, `f32_by_three`, and the weight gradients, whose sums over
every pixel cancel, six, `f32_by_six`.  The backward is that of
`_conv3x3_bwd` (:409) and `_conv3x3s_bwd` (:1054): the output gradient
cast to the activation dtype; db = sum(g) in f32; dx = the forward's
f32-output kernel on g with the rotated, io-transposed weights, under
reflect padding run on g zero-padded by one ring and folded back with
the exact adjoint of reflect-pad; dW from the weight-gradient kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rnr_tpu_torch.ops import _build
from rnr_tpu_torch.ops.backend import (check_launch, require, stream_of,
                                       use_kernel)

# the H100's SMs: K3 / K8a take two consumer warpgroups only where their
# blocks fill the card
SMS = 132
# split-K of K3b (csrc/conv3x3_wgrad.cu): 64 columns of a row per unit,
# 64 x 64 of dW per block, at most one wave of one block per SM of the
# H100's 132 (more splits add partials to write and reduce)
K3B_UNIT = 64
K3B_CT = 64
K3B_TARGET_BLOCKS = SMS
# split-K of K8b (csrc/conv3x3_slab_wgrad.cu): the same units; a block per
# band dy x 64 channels x 64 outputs of each dx band, three blocks an SM
K8B_TARGET_BLOCKS = 3 * SMS
# f32 weight gradients: runs of at most this many units, so that each
# tensor-core accumulation chain (its adds rounded toward zero) stays
# short against sums that cancel
F32_WGRAD_PER = 8
# K3's `pad` argument: zero ring, reflect ring, or the reflect data
# gradient's full correlation (csrc/conv3x3.cu)
K3_PAD = {"same": 0, "reflect": 1}
K3_FULL = 2


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


def round8(k: int) -> int:
    """k rounded up to a multiple of 8: K3 and K3b read activations and
    weights by TMA, whose rows must be multiples of 16 bytes."""
    return -(-k // 8) * 8


def pad_channels(t: torch.Tensor, k: int) -> torch.Tensor:
    """t with its last dimension zero-padded to k: t itself when it already
    has k (no copy), else one padded copy in one pass (K3 / K3b's ragged C
    or O)."""
    if t.shape[-1] == k:
        return t
    return torch.cat([t, t.new_zeros((*t.shape[:-1], k - t.shape[-1]))], -1)


def k3_weights(w: torch.Tensor, c8: int) -> torch.Tensor:
    """w [kh, kw, C, O] (any strides) -> contiguous bf16 [kh, kw, c8,
    round8(O)], zero-padded: one conversion, and a pad only where C or O
    is ragged (K3's 3x3 weights, K8's 4x4 ones)."""
    c, o = w.shape[2], w.shape[3]
    # .to() returns a bf16 w itself, strides and all: a transposed view (a
    # data gradient's weights) needs the copy
    wb = w.to(torch.bfloat16).contiguous()
    if (c8, round8(o)) == (c, o):
        return wb
    return F.pad(wb, (0, round8(o) - o, 0, c8 - c))


def ring_len(h: int, wd: int) -> int:
    """Positions of the ring around an H x W image on the (H + 2) x (W + 2)
    grid of the reflect data gradient: top and bottom rows, then the left
    and right columns between them (K3's pad-2 side buffer, per image)."""
    return 2 * (wd + 2) + 2 * h


def k8a_plan(n: int, h: int, wd: int, o: int,
             full: bool) -> tuple[int, int, int]:
    """(bn, wgs, ring) of K8a's launch over the [N, H, W] output grid, or
    the (H + 2) x (W + 2) grid of the reflect dgrad's full correlation
    (`full`), with O outputs.  BN = 80 where round8(O) is 72 or 80 (one
    tile; three accumulators of 40 a thread), else 64.  Two consumer
    warpgroups (tiles of 128 columns) where a grid row has more than 64
    columns and its row tiles fill the card's SMs, else one (the 32^2 and
    64^2 levels).  ring = 1 (full only): the grid's columns 0 and W + 1 go
    to ring tiles, strips of rows of one column, and the row tiles take
    columns 1 .. W, where tiles over all W + 2 columns would compute half
    as many columns again or more (W = 128, 256: measured faster; at W =
    512 the strips cost more than the fifth tile a row they save)."""
    bn = 80 if 64 < round8(o) <= 80 else 64
    ho, wo = (h + 2, wd + 2) if full else (h, wd)
    blocks = -(-wo // 128) * n * ho * -(-o // bn)
    wgs = 2 if wo > 64 and blocks >= SMS else 1
    bm = 64 * wgs
    ring = int(full and -(-wo // bm) * 2 >= -(-wd // bm) * 3)
    return bn, wgs, ring


def split_bf16(t: torch.Tensor, parts: int = 2) -> list[torch.Tensor]:
    """An f32 tensor as `parts` bf16 tensors, largest first, each the rest
    of t rounded to bf16 (the differences are exact in f32): two hold 16
    bits of t's 24, three all of them."""
    out, rest = [], t
    for i in range(parts):
        q = rest.to(torch.bfloat16)
        out.append(q)
        if i < parts - 1:
            rest = rest - q.to(torch.float32)
    return out


def add_parts(*parts: torch.Tensor) -> torch.Tensor:
    """The f32 route's products summed left to right."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def f32_by_three(one, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A product of f32 operands a and b (activations and weights) on a
    kernel that multiplies bf16 and sums in f32: a b as a_hi b_hi + a_lo
    b_hi + a_hi b_lo, three calls one(a_part, b_part, first) with f32
    results summed in that order (`first`: the call that adds the bias).
    What is dropped, a_lo b_lo and the rounding of the lo parts, is below
    2^-16 of a b."""
    ah, al = split_bf16(a)
    bh, bl = split_bf16(b)
    return add_parts(one(ah, bh, True), one(al, bh, False),
                     one(ah, bl, False))


def f32_by_six(one, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32_by_three's product to f32's precision, for sums whose result
    is far below the sum of their terms' sizes (a weight gradient's, over
    every pixel): a and b in three bf16 parts each, a b as the six
    products a_i b_j with i + j <= 2, the small ones summed first.  What
    is dropped, a_1 b_2, a_2 b_1 and a_2 b_2, is below 2^-23 of a b."""
    a0, a1, a2 = split_bf16(a, 3)
    b0, b1, b2 = split_bf16(b, 3)
    return add_parts(one(a1, b1, False), one(a2, b0, False),
                     one(a0, b2, False), one(a1, b0, False),
                     one(a0, b1, False), one(a0, b0, True))


def _launch_conv3(lib: str, symbol: str, counter, x: torch.Tensor,
                  w: torch.Tensor, b: torch.Tensor | None, pad: int,
                  out_dtype: torch.dtype, plan: tuple = ()) -> torch.Tensor:
    """One launch of K3 (csrc/conv3x3.cu) or K8a (csrc/conv3x3_slab.cu,
    with its `plan`), `symbol` of csrc/`lib`.cu (`symbol`_f32out for an
    f32 output); counts in `counter.launches`: x [N, H, W, C] bf16, w
    [3, 3, C, O], b [O] (None: no bias) -> [N, H, W, O] in `out_dtype`
    (bf16 or f32); under pad K3_FULL (f32, no bias) a flat buffer whose
    first N H W rows of O are the reflect dgrad dx, the ring rows after
    them its scratch.  C % 8 != 0 is padded with zero channels first.
    f32 x (with an f32 output): three launches, `f32_by_three`."""
    n, h, wd, c = x.shape
    o = w.shape[-1]
    if x.dtype == torch.float32 and out_dtype == torch.float32:
        return f32_by_three(
            lambda xp, wp, first: _launch_conv3(
                lib, symbol, counter, xp, wp, b if first else None, pad,
                torch.float32, plan), x, w.to(torch.float32))
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{symbol}: output dtype {out_dtype}, the kernel "
                        "writes bf16 or f32")
    _require_bf16(x, "x")
    c8 = round8(c)
    xb = pad_channels(x.contiguous(), c8)
    require(xb, "x", torch.bfloat16, (n, h, wd, c8))
    wb = k3_weights(w, c8)
    require(wb, "w", torch.bfloat16, (3, 3, c8, round8(o)))
    bf = None
    if b is not None:
        bf = b.to(torch.float32).contiguous()
        require(bf, "b", torch.float32, (o,))
    if pad == K3_FULL:
        y = torch.empty((n * h * wd + n * ring_len(h, wd)) * o,
                        dtype=torch.float32, device=x.device)
    else:
        y = torch.empty((n, h, wd, o), dtype=out_dtype, device=x.device)
    if out_dtype == torch.float32:
        symbol += "_f32out"
    f = _build.fn(lib, symbol, 4, 6 + len(plan))
    counter.launches += 1
    check_launch(f(xb.data_ptr(), wb.data_ptr(),
                   None if bf is None else bf.data_ptr(), y.data_ptr(),
                   n, h, wd, c8, o, pad, *plan, stream_of(xb)), symbol)
    return y


def _launch_k3(x, w, b, pad, out_dtype) -> torch.Tensor:
    return _launch_conv3("conv3x3", "rnr_conv3x3", conv3x3, x, w, b, pad,
                         out_dtype)


def _launch_k8a(x, w, b, pad, out_dtype) -> torch.Tensor:
    n, h, wd, _ = x.shape
    return _launch_conv3("conv3x3_slab", "rnr_conv3x3s", conv3x3s, x, w, b,
                         pad, out_dtype,
                         k8a_plan(n, h, wd, w.shape[-1], pad == K3_FULL))


def _require_bf16(t: torch.Tensor, name: str) -> None:
    """The 3x3 kernels take bf16 activations (checked before any padded
    copy)."""
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes "
                        f"{torch.bfloat16}")


def _check_reflect(pad_mode: str, h: int, wd: int) -> None:
    if pad_mode == "reflect" and (h < 2 or wd < 2):
        raise ValueError("reflect padding needs H, W >= 2")


def conv3x3_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                pad_mode: str = "same",
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The tap-wise conv, not differentiable (K3 on CUDA tensors, the
    plain version on CPU tensors): x [N, H, W, C] (bf16 on the card), w
    [3, 3, C, O], b [O] -> [N, H, W, O] in `out_dtype` (x's when None;
    an f32 output is the sums + bias unrounded)."""
    _check_pad(pad_mode)
    out_dtype = out_dtype or x.dtype
    if not use_kernel(x, w, b):
        wr = w.to(x.dtype).to(torch.float32)
        return conv3x3_torch(x.to(torch.float32), wr, b, pad_mode).to(
            out_dtype)
    _check_reflect(pad_mode, x.shape[1], x.shape[2])
    return _launch_k3(x, w, b, K3_PAD[pad_mode], out_dtype)


def conv3x3s_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 pad_mode: str = "same",
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The slab conv, not differentiable (K8a on CUDA tensors, the plain
    version on CPU tensors): x [N, H, W, C] (bf16 on the card), w
    [3, 3, C, O], b [O] -> [N, H, W, O] in `out_dtype` (x's when None)."""
    _check_pad(pad_mode)
    if not use_kernel(x, w, b):
        return conv3x3s_torch(x, w, b, pad_mode, out_dtype)
    _check_reflect(pad_mode, x.shape[1], x.shape[2])
    return _launch_k8a(x, w, b, K3_PAD[pad_mode], out_dtype or x.dtype)


def _dgrad(g: torch.Tensor, w: torch.Tensor, pad_mode: str, conv):
    """dx [N, H, W, C] f32 from g [N, H, W, O]: `conv` (zero padding, f32
    out) of g with w rotated by 180 degrees and io-transposed; under
    reflect padding the full correlation on g zero-padded by one ring,
    then the adjoint of reflect-pad (x_pad[0] = x[1], so dx[1] +=
    dx_pad[0], and so on; the corners compose)."""
    w_rot = w.flip(0, 1).transpose(2, 3)                  # [3, 3, O, C]
    if pad_mode == "same":
        return conv(g, w_rot)
    # [N, H+2, W+2, C]
    return reflect_ring_adjoint(conv(F.pad(g, (0, 0, 1, 1, 1, 1)), w_rot))


def reflect_ring_adjoint(dxp: torch.Tensor) -> torch.Tensor:
    """dx [N, H, W, C] from dxp [N, H+2, W+2, C], the gradient of x padded
    by one reflected ring (x_pad[0] = x[1], so dx[1] += dx_pad[0], and so
    on; the corners compose): the interior, then the four edges, then the
    four corners, each a fixed slice add.  No atomics, so the same bits
    every run, where torch's reflection_pad2d_backward adds with them."""
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


class ReflectPad1Fn(torch.autograd.Function):
    """NCHW x reflect-padded by 1 (F.pad's), with reflect_ring_adjoint as
    its backward."""

    @staticmethod
    def forward(ctx, xn):
        return F.pad(xn, (1, 1, 1, 1), mode="reflect")

    @staticmethod
    def backward(ctx, g):
        return reflect_ring_adjoint(g.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def reflect_pad1(xn: torch.Tensor) -> torch.Tensor:
    """NCHW x reflect-padded by 1, with a fixed-order backward."""
    return ReflectPad1Fn.apply(xn)


def conv3x3_dgrad_torch(g: torch.Tensor, w: torch.Tensor,
                        pad_mode: str = "same") -> torch.Tensor:
    """Plain version of the data gradient, f32 [N, H, W, C]."""
    return _dgrad(g, w, pad_mode, _conv_f32_torch)


def conv3x3_dgrad(g: torch.Tensor, w: torch.Tensor,
                  pad_mode: str = "same") -> torch.Tensor:
    """Data gradient of conv3x3: g [N, H, W, O] (bf16 on the card), w
    [3, 3, C, O] -> dx [N, H, W, C] f32; K3 with an f32 output.  Under
    reflect padding the one launch computes `_dgrad`'s full correlation,
    reading g with its zero ring by TMA, writes the interior into dx and
    the ring beside it, and adds the ring onto dx in `_dgrad`'s order of
    adds (bitwise the same fold)."""
    if not use_kernel(g, w):
        return conv3x3_dgrad_torch(g, w, pad_mode)
    return _dgrad_launch(g, w, pad_mode, _launch_k3)


def _dgrad_launch(g: torch.Tensor, w: torch.Tensor, pad_mode: str,
                  launch) -> torch.Tensor:
    """dx f32 by one call of `launch` (K3 or K8a with an f32 output) on g
    with the rotated, io-transposed kernel: zero padding, or the reflect
    dgrad's full correlation with its ring folded in the same call."""
    _check_pad(pad_mode)
    n, h, wd, _ = g.shape
    c = w.shape[2]
    _check_reflect(pad_mode, h, wd)
    w_rot = w.flip(0, 1).transpose(2, 3)                  # [3, 3, O, C]
    if pad_mode == "same":
        return launch(g, w_rot, None, K3_PAD["same"], torch.float32)
    buf = launch(g, w_rot, None, K3_FULL, torch.float32)
    return buf[:n * h * wd * c].view(n, h, wd, c)


def conv3x3s_dgrad_torch(g: torch.Tensor, w: torch.Tensor,
                         pad_mode: str = "same") -> torch.Tensor:
    """Plain version of the slab conv's data gradient, f32 [N, H, W, C]."""
    return _dgrad(g, w, pad_mode, lambda a, k: conv3x3s_torch(
        a, k, torch.zeros(k.shape[-1], device=a.device), "same",
        torch.float32))


def conv3x3s_dgrad(g: torch.Tensor, w: torch.Tensor,
                   pad_mode: str = "same") -> torch.Tensor:
    """Data gradient of conv3x3s: g [N, H, W, O] (bf16 on the card), w
    [3, 3, C, O] -> dx [N, H, W, C] f32; K8a with an f32 output, in one
    call under either padding (the reflect fold as conv3x3_dgrad's)."""
    if not use_kernel(g, w):
        _check_pad(pad_mode)
        return conv3x3s_dgrad_torch(g, w, pad_mode)
    return _dgrad_launch(g, w, pad_mode, _launch_k8a)


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


def k3b_plan(n: int, h: int, wd: int, c8: int, o8: int,
             max_per: int | None = None) -> tuple[int, int]:
    """(splits, chunk) of K3b's split-K for x [N, H, W, c8], g [N, H, W,
    o8] (multiples of 8): the N H ceil(W / 64) units of 64 columns of a
    row cut into runs of `chunk` / 64 units, at most K3B_TARGET_BLOCKS
    blocks over the card with a block per 64 x 64 tile of dW, or runs of
    at most `max_per` units where that is given.  Fixed by the shapes
    alone, so a rerun adds in the same order."""
    splits, per = _split_units(n * h * -(-wd // K3B_UNIT),
                               -(-c8 // K3B_CT) * -(-o8 // K3B_CT),
                               K3B_TARGET_BLOCKS, max_per)
    return splits, per * K3B_UNIT


def k8b_plan(n: int, h: int, wd: int, c8: int, o8: int,
             max_per: int | None = None) -> tuple[int, int]:
    """(splits, per) of K8b's split-K for x [N, H, W, c8], g [N, H, W, o8]
    (multiples of 8): the N H ceil(W / 64) units of 64 columns of a row
    (K3b's) cut into runs of `per` units, at most K8B_TARGET_BLOCKS blocks
    (one wave at three an SM) with a block per band dy x 64 channels x 64
    outputs, or runs of at most `max_per` units where that is given.
    Fixed by the shapes alone, so a rerun adds in the same order."""
    return _split_units(n * h * -(-wd // K3B_UNIT),
                        3 * -(-c8 // K3B_CT) * -(-o8 // K3B_CT),
                        K8B_TARGET_BLOCKS, max_per)


def _split_units(units: int, tiles: int, target: int,
                 max_per: int | None = None) -> tuple[int, int]:
    """(splits, per): `units` cut into runs of `per`, as many runs as fit
    `target` blocks of `tiles` each (at least one), none empty, none
    longer than `max_per` where that is given."""
    want = max(1, min(units, target // tiles))
    per = -(-units // want)
    if max_per is not None:
        per = min(per, max_per)
    return -(-units // per), per


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor,
                  pad_mode: str = "same") -> torch.Tensor:
    """Weight gradient of conv3x3: x [N, H, W, C] and g [N, H, W, O], both
    bf16 on the card -> dW [3, 3, C, O] f32 (K3b, deterministic).  C and O
    not multiples of 8 are padded with zero channels (a copy of x or g)."""
    if not use_kernel(x, g):
        return conv3x3_wgrad_torch(x, g, pad_mode)
    return _wgrad_launch("conv3x3_wgrad", "rnr_conv3x3_wgrad", conv3x3_wgrad,
                         k3b_plan, x, g, pad_mode)


def _wgrad_launch(lib: str, symbol: str, counter, plan, x: torch.Tensor,
                  g: torch.Tensor, pad_mode: str) -> torch.Tensor:
    """One launch of K3b or K8b (its split sum included), `symbol` of
    csrc/`lib`.cu with the two ints of `plan`; counts in
    `counter.launches`.  C and O not multiples of 8 are padded with zero
    channels (a copy of x or g).  f32 x and g: six launches, `f32_by_six`,
    each in runs of at most F32_WGRAD_PER units."""
    _check_pad(pad_mode)
    if x.dtype == torch.float32 and g.dtype == torch.float32:
        def short(*shape):
            return plan(*shape, max_per=F32_WGRAD_PER)
        return f32_by_six(
            lambda xp, gp, _: _wgrad_launch(lib, symbol, counter, short, xp,
                                            gp, pad_mode), x, g)
    n, h, wd, c = x.shape
    o = g.shape[-1]
    _check_reflect(pad_mode, h, wd)
    _require_bf16(x, "x")
    _require_bf16(g, "g")
    c8, o8 = round8(c), round8(o)
    xb = pad_channels(x.contiguous(), c8)
    gb = pad_channels(g.contiguous(), o8)
    require(xb, "x", torch.bfloat16, (n, h, wd, c8))
    require(gb, "g", torch.bfloat16, (n, h, wd, o8))
    splits, run = plan(n, h, wd, c8, o8)
    dw = torch.empty((3, 3, c8, o8), dtype=torch.float32, device=x.device)
    part = (torch.empty(splits * 9 * c8 * o8, dtype=torch.float32,
                        device=x.device) if splits > 1 else dw)
    f = _build.fn(lib, symbol, 4, 8)
    counter.launches += 1
    check_launch(f(xb.data_ptr(), gb.data_ptr(), part.data_ptr(),
                   dw.data_ptr(), n, h, wd, c8, o8,
                   K3_PAD[pad_mode], splits, run, stream_of(xb)), symbol)
    return dw if (c8, o8) == (c, o) else dw[:, :, :c, :o].contiguous()


def conv3x3s_wgrad(x: torch.Tensor, g: torch.Tensor,
                   pad_mode: str = "same") -> torch.Tensor:
    """Weight gradient of conv3x3s: x [N, H, W, C] and g [N, H, W, O],
    both bf16 on the card -> dW [3, 3, C, O] f32 (K8b, deterministic)."""
    _check_pad(pad_mode)
    if not use_kernel(x, g):
        return conv3x3s_wgrad_torch(x, g, pad_mode)
    return _wgrad_launch("conv3x3_slab_wgrad", "rnr_conv3x3s_wgrad",
                         conv3x3s_wgrad, k8b_plan, x, g, pad_mode)


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
            return conv3x3_fwd(x, w, b, pad_mode)
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
    differentiable in x, w and b.  The kernels take bf16 activations,
    f32 ones by `f32_by_three` (`f32_by_six` for dW)."""
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
