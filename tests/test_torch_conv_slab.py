"""Port parity of the U-Net's 3x3 slab conv vs rnr_tpu: the plain versions
of K8a (forward and f32-output data gradient) and K8b (weight gradient),
and the autograd Function `conv3x3s`; and the kernels' tiling on the host:
their plans (`k8a_plan`, `k8b_plan`) and float64 emulations of
csrc/conv3x3_slab.cu and csrc/conv3x3_slab_wgrad.cu block by block,
against the plain versions.

rnr_tpu's conv3x3s / _conv3x3_slab_fwd_impl / _conv3x3_slab_wgrad_impl
run their Pallas kernels in interpret mode; on the CPU the port's
wrappers run the plain versions (written in the slab formulation) and
launch nothing.  Gradients are held against jax.grad through rnr_tpu's
custom VJP.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnr_tpu.ops import conv_pallas as jcp
from rnr_tpu_torch.ops import conv_cuda as cc

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (C, O, H, W): odd everything, and the smallest H that reflect takes
SHAPES = [(5, 7, 9, 13), (8, 4, 2, 6)]


def _inputs(seed, c, o, h, wd, n=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, wd, c)).astype(np.float32)
    w = (rng.standard_normal((3, 3, c, o)) / np.sqrt(9 * c)).astype(
        np.float32)
    b = rng.standard_normal(o).astype(np.float32)
    return x, w, b


def _tol(want: np.ndarray, dtype: str) -> float:
    """f32: 1e-5 of the largest magnitude (f32 sums in another order).
    bf16: both sides sum bf16 products in f32 and round once, so a value
    may round to its neighbour: one bf16 step (2^-7 of the leading power
    of two) at the largest magnitude."""
    scale = float(np.abs(want).max())
    if dtype == "float32":
        return 1e-5 * scale
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


@pytest.mark.parametrize("c,o,h,wd", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("pad_mode", ["same", "reflect"])
def test_slab_plain_matches_conv3x3s(pad_mode, dtype, c, o, h, wd):
    """conv3x3s_torch against rnr_tpu's conv3x3s (interpret mode) in the
    activation dtype, and against the tap-wise plain version."""
    x, w, b = _inputs(c * 10 + o + h, c, o, h, wd)
    jdt, tdt = DTYPES[dtype]
    want = np.asarray(jcp.conv3x3s(jnp.asarray(x).astype(jdt),
                                   jnp.asarray(w), jnp.asarray(b), pad_mode,
                                   False, 0.2, True).astype(jnp.float32))
    xt = torch.from_numpy(x).to(tdt)
    got = cc.conv3x3s_torch(xt, torch.from_numpy(w), torch.from_numpy(b),
                            pad_mode)
    assert got.dtype == tdt and got.shape == (2, h, wd, o)
    tol = _tol(want, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
    tap = cc.conv3x3_torch(xt, torch.from_numpy(w), torch.from_numpy(b),
                           pad_mode)
    np.testing.assert_allclose(got.float().numpy(), tap.float().numpy(),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("pad_mode", ["same", "reflect"])
def test_slab_plain_f32_output_matches_slab_impl(pad_mode):
    """bf16 activations, f32 output (the data gradient's form): against
    _conv3x3_slab_fwd_impl(out_dtype=f32, interpret=True), to 1e-5 of
    max (bf16 products are exact, f32 sums in another order); and the
    bf16 output is that f32 output rounded once."""
    x, w, b = _inputs(31, 5, 7, 9, 13)
    want = np.asarray(jcp._conv3x3_slab_fwd_impl(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w), jnp.asarray(b),
        pad_mode=pad_mode, out_dtype=jnp.float32, interpret=True))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    args = (xt, torch.from_numpy(w), torch.from_numpy(b), pad_mode)
    got = cc.conv3x3s_fwd(*args, torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=_tol(want, "float32"))
    np.testing.assert_array_equal(got.to(torch.bfloat16).float().numpy(),
                                  cc.conv3x3s_fwd(*args).float().numpy())
    assert cc.conv3x3s.launches == 0


@pytest.mark.parametrize("c,o,h,wd", SHAPES)
@pytest.mark.parametrize("pad_mode", ["same", "reflect"])
def test_slab_wgrad_plain_matches_slab_wgrad_impl(pad_mode, c, o, h, wd):
    """conv3x3s_wgrad_torch against _conv3x3_slab_wgrad_impl(interpret=
    True) on bf16 x and g (exact products, f32 sums in another order: 1e-5
    of max), and against the tap-wise plain weight gradient."""
    x, _, _ = _inputs(c + o + h, c, o, h, wd)
    g = np.random.default_rng(h * wd).standard_normal(
        (2, h, wd, o)).astype(np.float32)
    xb, gb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, g))
    want = np.asarray(jcp._conv3x3_slab_wgrad_impl(xb, gb, pad_mode=pad_mode,
                                                   interpret=True))
    xt, gt = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, g))
    got = cc.conv3x3s_wgrad(xt, gt, pad_mode)
    assert got.dtype == torch.float32 and got.shape == (3, 3, c, o)
    tol = _tol(want, "float32")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    np.testing.assert_allclose(
        got.numpy(), cc.conv3x3_wgrad_torch(xt, gt, pad_mode).numpy(),
        rtol=0, atol=tol)
    assert cc.conv3x3s_wgrad.launches == 0


@pytest.mark.parametrize("pad_mode", ["same", "reflect"])
def test_conv3x3s_grads_match_jax_grad(pad_mode):
    """dx, dw and db of sum(conv3x3s(x, w, b) * g) against jax.grad through
    rnr_tpu's custom VJP (interpret mode), f32, each scaled by its largest
    magnitude and held to 1e-5 (f32 sums in another order)."""
    x, w, b = _inputs(7 + len(pad_mode), 5, 7, 9, 13)
    g = np.random.default_rng(8).standard_normal((2, 9, 13, 7)).astype(
        np.float32)
    want = jax.grad(
        lambda x_, w_, b_: jnp.sum(jcp.conv3x3s(x_, w_, b_, pad_mode, False,
                                                0.2, True) * g),
        argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    y = cc.conv3x3s(*ts, pad_mode)
    assert y.shape == (2, 9, 13, 7)
    (y * torch.from_numpy(g)).sum().backward()
    for t, ref, what in zip(ts, want, ("dx", "dw", "db")):
        ref = np.asarray(ref)
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(t.grad.numpy() / scale, ref / scale,
                                   rtol=0, atol=1e-5, err_msg=what)


def test_conv3x3s_backward_rounds_where_rnr_tpu_does():
    """bf16 activations: dx is the f32-output slab conv of g with the
    rotated, io-transposed kernel (reflect fold included), rounded once
    to bf16; dw is K8b's f32 sum, returned in f32; db the f32 sum of g."""
    x, w, b = _inputs(17, 8, 16, 6, 10, n=1)
    g = torch.from_numpy(np.random.default_rng(18).standard_normal(
        (1, 6, 10, 16)).astype(np.float32)).to(torch.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    cc.conv3x3s(xt, wt, bt, "reflect").backward(g)
    assert xt.grad.dtype == torch.bfloat16 and wt.grad.dtype == torch.float32
    want_dx = cc.conv3x3s_dgrad_torch(g, torch.from_numpy(w), "reflect")
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  want_dx.to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(
        wt.grad.numpy(),
        cc.conv3x3s_wgrad_torch(xt.detach(), g, "reflect").numpy())
    np.testing.assert_array_equal(bt.grad.numpy(),
                                  g.float().sum(dim=(0, 1, 2)).numpy())


def test_slab_pad_mode_is_checked():
    x, w, b = (torch.from_numpy(a) for a in _inputs(3, 4, 4, 6, 6))
    with pytest.raises(ValueError, match="pad_mode"):
        cc.conv3x3s(x, w, b, "zeros")
    with pytest.raises(ValueError, match="pad_mode"):
        cc.conv3x3s_wgrad(x, x, "wrap")


# ---- K8a / K8b tiling on the host (csrc/conv3x3_slab.cu,
#      conv3x3_slab_wgrad.cu), emulated in float64

# the 14 3x3 convs of a 512^2 frame (C, O, H), and the data gradients'
# transposed (O, C) of each
FRAME = [(108, 64, 512), (64, 64, 512), (128, 640, 256), (640, 128, 256),
         (128, 128, 256), (256, 256, 128), (512, 512, 64), (512, 512, 32),
         (512, 512, 32), (512, 512, 64), (256, 256, 128), (128, 128, 256),
         (64, 64, 512), (128, 78, 512)]


def _r8(k):
    return -(-k // 8) * 8


def _out_row(pad, img, row, j, n, h, wd):
    """conv3x3_common.cuh's out_row: the output row of grid position
    (row, j), or -1."""
    if pad != 2:
        return (img * h + row) * wd + j if j < wd else -1
    if j >= wd + 2:
        return -1
    if 1 <= row <= h and 1 <= j <= wd:
        return (img * h + row - 1) * wd + j - 1
    k = (j if row == 0 else wd + 2 + j if row == h + 1
         else 2 * (wd + 2) + row - 1 if j == 0 else 2 * (wd + 2) + h + row - 1)
    return n * h * wd + img * cc.ring_len(h, wd) + k


def _fold(y, n, h, wd):
    """fold_ring_kernel on the pad-2 buffer y [N H W + N R, C]: dx's
    border lines += the ring, in _dgrad's order of adds -> dx."""
    c = y.shape[-1]
    dx = y[:n * h * wd].reshape(n, h, wd, c).copy()
    ring = y[n * h * wd:].reshape(n, cc.ring_len(h, wd), c)
    top, bot = ring[:, :wd + 2], ring[:, wd + 2:2 * (wd + 2)]
    left = ring[:, 2 * (wd + 2):2 * (wd + 2) + h]
    right = ring[:, 2 * (wd + 2) + h:]
    for a in range(h):
        for b in range(wd):
            v = dx[:, a, b]
            if a == 1:
                v = v + top[:, b + 1]
            if a == h - 2:
                v = v + bot[:, b + 1]
            if b == 1:
                v = v + left[:, a]
            if b == wd - 2:
                v = v + right[:, a]
            if a == 1 and b == 1:
                v = v + top[:, 0]
            if a == 1 and b == wd - 2:
                v = v + top[:, wd + 1]
            if a == h - 2 and b == 1:
                v = v + bot[:, 0]
            if a == h - 2 and b == wd - 2:
                v = v + bot[:, wd + 1]
            dx[:, a, b] = v
    return dx


def _k8a_emulate(x, w, b, pad, plan):
    """csrc/conv3x3_slab.cu's arithmetic in float64, tile by tile.  A row
    tile's unit (c0, dy) stages input row i + dy - 1 - ext from column j0
    - 1 - ext (zeros outside, reflect rows by index and patched columns)
    and the packed weights' blocks (dy, dx = 0, 1, 2) of the weight map
    (zeros past C8 and O8); the dx block's products read the band from
    row dx into accumulator dx.  Under pad 2 row tiles take the grid's W
    + 2 columns, or with ring tiles (plan[2]) its columns 1 .. W, and
    ring tiles its columns 0 and W + 1: per unit c0
    the column strip of x's column 0 (W - 1) from the strip's first row -
    2, tap dy reading it from row dy with the weights (dy, dx = 2 (0)),
    all into accumulator 0.  The epilogue adds (Y0 + Y1) + Y2 + b and
    stores to out_row's rows.  Returns the kernel's output buffer [rows,
    O]."""
    bn, wgs, ring = plan
    n, h, wd, c = x.shape
    o = w.shape[-1]
    c64 = -(-_r8(c) // 64) * 64
    o_pad = -(-o // bn) * bn + 64
    xp = np.zeros((n, h, wd, c64))
    xp[..., :c] = x
    wv = np.zeros((3, 3, c64, o_pad))
    wv[:, :, :c, :o] = w
    ext = 1 if pad == 2 else 0
    ho, bm = h + 2 * ext, 64 * wgs
    seg = bm + 2
    rows = n * h * wd + (n * cc.ring_len(h, wd) if pad == 2 else 0)
    y = np.full((rows, o), np.nan)

    def store(acc, dest, o0):
        v = (acc[0] + acc[1]) + acc[2]
        for m, d in enumerate(dest):
            if d >= 0:
                k = min(bn, o - o0)
                y[d, o0:o0 + k] = v[m, :k] + (0 if b is None
                                              else b[o0:o0 + k])

    for img in range(n):
        for o0 in range(0, o, bn):
            j_lo, j_hi = (1, wd) if ring else (0, wd - 1 + 2 * ext)
            for row in range(ho):                       # row tiles
                for j0 in range(j_lo, j_hi + 1, bm):
                    dest = [_out_row(pad, img, row, j0 + m, n, h, wd)
                            if j0 + m <= j_hi else -1 for m in range(bm)]
                    acc = np.zeros((3, bm, bn))
                    for u in range(c64 // 64 * 3):
                        c0, dy = u // 3 * 64, u % 3
                        xr = row + dy - 1 - ext
                        if pad == 1:
                            xr = -xr if xr < 0 else (
                                2 * h - 2 - xr if xr >= h else xr)
                        band = np.zeros((seg, 64))
                        for q in range(seg):
                            col = j0 - 1 - ext + q
                            if 0 <= xr < h and 0 <= col < wd:
                                band[q] = xp[img, xr, col, c0:c0 + 64]
                        if pad == 1 and j0 == 0:
                            band[0] = band[2]
                        t_right = wd - j0 + 1
                        if pad == 1 and t_right < seg:
                            band[t_right] = band[t_right - 2]
                        for dx in range(3):
                            acc[dx] += (band[dx:dx + bm]
                                        @ wv[dy, dx, c0:c0 + 64, o0:o0 + bn])
                    store(acc, dest, o0)
            for side in (0, 1) if ring else ():         # ring tiles
                j, xc, dx = (wd + 1, wd - 1, 0) if side else (0, 0, 2)
                for r0 in range(0, ho, bm):
                    dest = [_out_row(pad, img, r0 + m, j, n, h, wd)
                            if r0 + m < ho else -1 for m in range(bm)]
                    acc = np.zeros((3, bm, bn))
                    for c0 in range(0, c64, 64):
                        strip = np.zeros((seg, 64))
                        for q in range(seg):
                            xr = r0 - 2 + q
                            if 0 <= xr < h:
                                strip[q] = xp[img, xr, xc, c0:c0 + 64]
                        for dy in range(3):
                            acc[0] += (strip[dy:dy + bm]
                                       @ wv[dy, dx, c0:c0 + 64, o0:o0 + bn])
                    store(acc, dest, o0)
    assert not np.isnan(y).any()         # every output written
    return y


@pytest.mark.parametrize("n,h,wd,c,o", [(1, 512, 512, 108, 64),
                                        (2, 7, 9, 5, 77), (1, 9, 70, 8, 640)]
                         + [(1, hh, hh, cc_, oo) for cc_, oo, hh in FRAME])
@pytest.mark.parametrize("full", [False, True])
def test_k8a_plan_takes_bn_and_warpgroups_by_the_shapes(n, h, wd, c, o,
                                                        full):
    """BN 80 only where one tile of 80 holds O (O = 78), else 64; two
    warpgroups only where a grid row has more than 64 columns and the row
    tiles of 128 columns fill the card (never at the 32^2 and 64^2
    levels' forward), one otherwise; ring tiles only for the reflect
    dgrad's full correlation, where tiles over its W + 2 columns compute
    at least 1.5x the columns of tiles over W (the 128^2 and 256^2
    levels, not 512^2); the same plan on every call."""
    bn, wgs, ring = cc.k8a_plan(n, h, wd, o, full)
    assert bn == (80 if 64 < _r8(o) <= 80 else 64)
    ho, wo = (h + 2, wd + 2) if full else (h, wd)
    blocks = -(-wo // 128) * n * ho * -(-o // bn)
    assert wgs == (2 if wo > 64 and blocks >= cc.SMS else 1)
    if not full and wd <= 64:
        assert wgs == 1
    bm = 64 * wgs
    assert ring == int(full and 2 * -(-wo // bm) >= 3 * -(-wd // bm))
    if full and (n, h, wd) == (1, 256, 256):
        assert ring == 1
    if full and (n, h, wd) == (1, 512, 512):
        assert ring == 0
    assert cc.k8a_plan(n, h, wd, o, full) == (bn, wgs, ring)


K8A_CASES = [  # (n, h, wd, c, o, (bn, wgs) or None: the plan's)
    (2, 5, 9, 5, 7, None), (1, 4, 13, 108, 78, None),
    (1, 3, 70, 13, 78, (80, 2)), (2, 4, 66, 16, 9, (64, 2)),
    (1, 3, 130, 8, 70, (64, 2)), (1, 2, 5, 64, 130, None),
    (1, 6, 64, 72, 8, None), (1, 70, 6, 8, 9, None)]


@pytest.mark.parametrize("n,h,wd,c,o,plan", K8A_CASES)
@pytest.mark.parametrize("pad_mode", ["same", "reflect"])
def test_k8a_tiling_computes_the_plain_conv(n, h, wd, c, o, plan, pad_mode):
    """K8a's decomposition (units, tensor-map coordinates, the dx
    descriptor moves, the three-accumulator sum, reflect patches, out_row)
    emulated in float64 with its plan or the (bn, wgs) given (one and two
    warpgroups, W + 2 across a tile's 64 or 128 columns, C = 108 and O =
    78, ragged C and O, several output tiles) gives conv3x3s_torch's
    output within 1e-5 of its max (the plain version sums in float32): a
    band row, weight block or patch out of place moves an output by a
    product, orders of magnitude more."""
    rng = np.random.default_rng(n * h * wd + c * o)
    x = rng.standard_normal((n, h, wd, c))
    w = rng.standard_normal((3, 3, c, o)) / np.sqrt(9 * c)
    b = rng.standard_normal(o)
    plan = (*plan, 0) if plan else cc.k8a_plan(n, h, wd, o, False)
    pad = cc.K3_PAD[pad_mode]
    got = _k8a_emulate(x, w, b, pad, plan).reshape(n, h, wd, o)
    want = cc.conv3x3s_torch(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b), pad_mode,
                             torch.float64).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n,h,wd,c,o,plan", K8A_CASES)
@pytest.mark.parametrize("pad_mode", ["same", "reflect"])
def test_k8a_dgrad_tiling_computes_the_plain_dgrad(n, h, wd, c, o, plan,
                                                   pad_mode):
    """K8a's data gradient as its one C call computes it, in float64: the
    rotated, io-transposed kernel on g with zero padding, or under reflect
    the full correlation on the (H + 2) x (W + 2) grid (g's 2-pixel zero
    ring read as TMA's zeros; row tiles over all W + 2 columns, and row
    tiles over 1 .. W with ring tiles for columns 0 and W + 1), interior
    to dx and ring beside it by out_row, then fold_ring_kernel's fold;
    against conv3x3s_dgrad_torch within 1e-5 of its max."""
    rng = np.random.default_rng(n * h * wd + c * o + 1)
    g = rng.standard_normal((n, h, wd, o))
    w = rng.standard_normal((3, 3, c, o)) / np.sqrt(9 * c)
    w_rot = w[::-1, ::-1].transpose(0, 1, 3, 2)
    full = pad_mode == "reflect"
    bn, wgs, _ = cc.k8a_plan(n, h, wd, c, full)
    wgs = plan[1] if plan else wgs
    want = cc.conv3x3s_dgrad_torch(torch.from_numpy(g), torch.from_numpy(w),
                                   pad_mode).numpy()
    for ring in (0, 1) if full else (0,):
        y = _k8a_emulate(g, w_rot, None, 2 if full else 0, (bn, wgs, ring))
        got = _fold(y, n, h, wd) if full else y.reshape(n, h, wd, c)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n,h,wd,c8,o8", [
    (1, 512, 512, 112, 64), (1, 512, 512, 64, 64), (1, 256, 256, 128, 640),
    (1, 256, 256, 640, 128), (1, 128, 128, 256, 256), (1, 64, 64, 512, 512),
    (1, 32, 32, 512, 512), (1, 512, 512, 128, 80), (2, 512, 512, 64, 64),
    (1, 128, 128, 64, 64), (2, 7, 9, 8, 16), (2, 1, 1, 8, 8)])
def test_k8b_plan_covers_every_unit_in_fixed_runs(n, h, wd, c8, o8):
    """Every unit of 64 columns of a row in exactly one split, no split
    empty, runs of whole units in order; at most K8B_TARGET_BLOCKS blocks
    (one wave at three blocks an SM) where K is split, and as many splits
    as fit it; the same plan on every call."""
    splits, per = cc.k8b_plan(n, h, wd, c8, o8)
    units = n * h * -(-wd // 64)
    assert per >= 1 and splits * per >= units > (splits - 1) * per
    tiles = 3 * -(-c8 // 64) * -(-o8 // 64)
    assert splits == 1 or splits * tiles <= cc.K8B_TARGET_BLOCKS
    want = max(1, min(units, cc.K8B_TARGET_BLOCKS // tiles))
    assert want >= splits >= -(-want // 2)
    assert cc.k8b_plan(n, h, wd, c8, o8) == (splits, per)


def _k8b_emulate(x, g, reflect, plan):
    """csrc/conv3x3_slab_wgrad.cu's arithmetic in float64: a block (band
    dy, 64 channels, 64 outputs, split) walks its run of units (image,
    row i, 64 columns from j0): xp's row i + dy - 1 from column j0 - 1 (66
    slab columns; zeros outside, reflect rows by index and patched
    columns) and g's columns j0 .. j0 + 63 (zeros past W); the dx block
    adds band rows dx .. dx + 63 (transposed) times the g tile; partials
    per split, summed in split order."""
    splits, per = plan
    n, h, wd, c = x.shape
    o = g.shape[-1]
    c64, o64 = -(-_r8(c) // 64) * 64, -(-_r8(o) // 64) * 64
    xp = np.zeros((n, h, wd, c64))
    xp[..., :c] = x
    gp = np.zeros((n, h, wd + 64, o64))
    gp[:, :, :wd, :o] = g
    cpr = -(-wd // 64)
    units = n * h * cpr
    parts = np.zeros((splits, 3, 3, c64, o64))
    for s in range(splits):
        for u in range(s * per, min(s * per + per, units)):
            img, rem = divmod(u, h * cpr)
            i, jt = divmod(rem, cpr)
            j0 = jt * 64
            gt = gp[img, i, j0:j0 + 64]
            for dy in range(3):
                row = i + dy - 1
                if reflect:
                    row = -row if row < 0 else (
                        2 * h - 2 - row if row >= h else row)
                band = np.zeros((66, c64))
                for q in range(66):
                    col = j0 - 1 + q
                    if 0 <= row < h and 0 <= col < wd:
                        band[q] = xp[img, row, col]
                if reflect and j0 == 0:
                    band[0] = band[2]
                if reflect and j0 + 64 >= wd:
                    band[wd - j0 + 1] = band[wd - j0 - 1]
                for dx in range(3):
                    parts[s, dy, dx] += band[dx:dx + 64].T @ gt
    dw = parts[0]
    for s in range(1, splits):
        dw = dw + parts[s]
    return dw[:, :, :c, :o]


@pytest.mark.parametrize("n,h,wd,c,o,plan", [
    (2, 5, 9, 5, 7, None), (1, 4, 13, 108, 78, None),
    (2, 3, 70, 13, 9, None), (1, 3, 130, 8, 70, (3, 3)),
    (2, 4, 64, 16, 8, (3, 3)), (1, 2, 66, 72, 16, (4, 1)),
    (1, 2, 5, 64, 130, None)])
@pytest.mark.parametrize("pad_mode", ["same", "reflect"])
def test_k8b_tiling_computes_the_plain_wgrad(n, h, wd, c, o, plan,
                                             pad_mode):
    """K8b's decomposition (units of 64 columns, the band and g tile's
    tensor-map coordinates, the dx descriptor moves, reflect patches, the
    split runs and their order) emulated in float64 with its plan or the
    (splits, per) given gives conv3x3s_wgrad_torch's dW within 1e-5 of its
    max, at odd C / O / H / W and C = 108, O = 78."""
    rng = np.random.default_rng(n * h * wd + c * o + 2)
    x = rng.standard_normal((n, h, wd, c))
    g = rng.standard_normal((n, h, wd, o))
    plan = plan or cc.k8b_plan(n, h, wd, _r8(c), _r8(o))
    got = _k8b_emulate(x, g, pad_mode == "reflect", plan)
    want = cc.conv3x3s_wgrad_torch(torch.from_numpy(x), torch.from_numpy(g),
                                   pad_mode).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
