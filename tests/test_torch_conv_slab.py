"""Port parity of the U-Net's 3x3 slab conv vs rnr_tpu: the plain versions
of K8a (forward and f32-output data gradient) and K8b (weight gradient),
and the autograd Function `conv3x3s`.

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
