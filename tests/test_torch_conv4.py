"""Port parity of the U-Net's 4x4 stride-2 pair vs rnr_tpu: the plain
versions of K6 (down4, convt4) and K8's 4x4 pair (down4s, convt4s), their
four autograd.Functions, and group norm.

rnr_tpu's down4 / convt4 / down4s / convt4s run their Pallas kernels in
interpret mode; on the CPU the port's wrappers run the plain versions
(`down4_torch`, `convt4_torch`, one per function, for both formulations),
and launch nothing.  Gradients are held against jax.grad through
rnr_tpu's custom VJPs.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnr_tpu.ops import conv_pallas as jcp
from rnr_tpu_torch.models.unet import GroupNorm
from rnr_tpu_torch.ops import conv4_cuda as c4

torch.set_num_threads(2)

CO = [(4, 5), (5, 7), (7, 4)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, shape, c, o):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape + (c,)).astype(np.float32)
    w = (rng.standard_normal((4, 4, c, o)) / np.sqrt(16 * c)).astype(
        np.float32)
    return x, w


def _tol(want: np.ndarray, dtype: str) -> float:
    """f32: 1e-5 of the largest magnitude (f32 sums in another order).
    bf16: both sides sum bf16 products in f32 and round once, so a value
    may round to its neighbour: one bf16 step (2^-7 of the leading power
    of two) at the largest magnitude."""
    scale = float(np.abs(want).max())
    if dtype == "float32":
        return 1e-5 * scale
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


@pytest.mark.parametrize("c,o", CO)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("pad_mode", ["same", "reflect"])
def test_down4_plain_matches_down4_and_down4s(pad_mode, dtype, c, o):
    """15 x 16 (odd H): rnr_tpu's kernels and the port give H//2 rows."""
    x, w = _inputs(c * 10 + o, (1, 15, 16), c, o)
    jdt, tdt = DTYPES[dtype]
    xj, wj = jnp.asarray(x).astype(jdt), jnp.asarray(w)
    got = c4.down4_torch(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                         pad_mode)
    assert got.dtype == tdt and got.shape == (1, 7, 8, o)
    for fn in (jcp.down4, jcp.down4s):
        want = np.asarray(fn(xj, wj, pad_mode, True).astype(jnp.float32))
        assert want.shape == (1, 7, 8, o)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=_tol(want, dtype),
                                   err_msg=fn.__name__)


@pytest.mark.parametrize("c,o", CO)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_convt4_plain_matches_convt4_and_convt4s(dtype, c, o):
    x, w = _inputs(c * 10 + o + 1, (1, 15, 16), c, o)
    jdt, tdt = DTYPES[dtype]
    xj, wj = jnp.asarray(x).astype(jdt), jnp.asarray(w)
    got = c4.convt4_torch(torch.from_numpy(x).to(tdt), torch.from_numpy(w))
    assert got.dtype == tdt and got.shape == (1, 30, 32, o)
    for fn in (jcp.convt4, jcp.convt4s):
        want = np.asarray(fn(xj, wj, True).astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=_tol(want, dtype),
                                   err_msg=fn.__name__)


def test_plain_versions_write_the_asked_output_dtype():
    x, w = _inputs(3, (2, 8, 6), 5, 4)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    for y in (c4.down4_fwd(xb, torch.from_numpy(w), "reflect",
                           torch.float32),
              c4.convt4s_fwd(xb, torch.from_numpy(w), torch.float32)):
        assert y.dtype == torch.float32
    # the f32 output is the bf16 one before its rounding
    f32 = c4.convt4_fwd(xb, torch.from_numpy(w), torch.float32)
    np.testing.assert_array_equal(
        f32.to(torch.bfloat16).float().numpy(),
        c4.convt4_fwd(xb, torch.from_numpy(w)).float().numpy())
    assert c4.down4.launches == c4.convt4.launches == 0
    assert c4.down4s.launches == c4.convt4s.launches == 0


# (name, port function, rnr_tpu function, takes pad_mode)
FUNCTIONS = [("down4", c4.down4, jcp.down4, True),
             ("down4s", c4.down4s, jcp.down4s, True),
             ("convt4", c4.convt4, jcp.convt4, False),
             ("convt4s", c4.convt4s, jcp.convt4s, False)]


@pytest.mark.parametrize("pad_mode", ["same", "reflect"])
@pytest.mark.parametrize("name,port,ref,padded", FUNCTIONS,
                         ids=[f[0] for f in FUNCTIONS])
def test_autograd_functions_match_jax_grad(name, port, ref, padded,
                                           pad_mode):
    """dx and dw of sum(f(x, w) * g) against jax.grad through rnr_tpu's
    custom VJPs (interpret mode), f32, each scaled by its largest
    magnitude as tests/test_conv_pallas.py does and held to 1e-5 (f32
    sums in another order).  The transpose convs
    have no padding mode: both values run the same case."""
    x, w = _inputs(len(name) + len(pad_mode), (2, 8, 12), 5, 7)
    pm = (pad_mode,) if padded else ()
    rng = np.random.default_rng(9)
    out_shape = (2, 4, 6, 7) if padded else (2, 16, 24, 7)
    g = rng.standard_normal(out_shape).astype(np.float32)
    jx, jw = jax.grad(
        lambda x_, w_: jnp.sum(ref(x_, w_, *pm, True) * g),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = port(xt, wt, *pm)
    assert y.shape == out_shape
    (y * torch.from_numpy(g)).sum().backward()
    for got, want, what in ((xt.grad, jx, "dx"), (wt.grad, jw, "dw")):
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy() / scale, want / scale,
                                   rtol=0, atol=1e-5, err_msg=what)


@pytest.mark.parametrize("name,port", [("down4", c4.down4),
                                       ("down4s", c4.down4s)])
def test_down_backward_rounds_where_rnr_tpu_does(name, port):
    """bf16 activations under "same": dx is the f32-output transpose conv
    of g with the flipped, io-swapped kernel, rounded once to bf16; dw is
    the bf16 conv's weight gradient (rounded to bf16), returned in f32,
    within one bf16 step of the f32 one."""
    x, w = _inputs(11, (1, 8, 8), 8, 16)
    rng = np.random.default_rng(12)
    g = torch.from_numpy(rng.standard_normal((1, 4, 4, 16)).astype(
        np.float32)).to(torch.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    port(xt, wt, "same").backward(g)
    assert xt.grad.dtype == torch.bfloat16 and wt.grad.dtype == torch.float32
    w_dx = torch.from_numpy(w).flip(0, 1).transpose(2, 3)     # [4, 4, O, C]
    want_dx = c4.convt4_torch(g, w_dx, torch.float32).to(torch.bfloat16)
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  want_dx.float().numpy())
    assert torch.equal(wt.grad, wt.grad.to(torch.bfloat16).float())
    xf = xt.detach().float().requires_grad_()
    wf = torch.from_numpy(w).to(torch.bfloat16).float().requires_grad_()
    c4.down4_torch(xf, wf, "same").backward(g.float())
    dw = wf.grad.numpy()
    np.testing.assert_allclose(wt.grad.numpy(), dw, rtol=0,
                               atol=_tol(dw, "bfloat16"))


def test_down4_same_backward_needs_even_sizes():
    """At odd sizes rnr_tpu's VJP fails in both pad modes (its XLA convs
    give ceil(H/2) rows against the forward's H//2).  Under "same" the
    port's transpose conv would give 2 (H//2) rows, so it raises with the
    reason; under reflect the plain conv's gradient takes any size."""
    x, w = _inputs(5, (1, 15, 16), 4, 4)
    xt = torch.from_numpy(x).requires_grad_()
    with pytest.raises(ValueError, match="even H and W"):
        c4.down4(xt, torch.from_numpy(w), "same").sum().backward()
    c4.down4s(xt, torch.from_numpy(w), "reflect").sum().backward()
    assert xt.grad.shape == xt.shape


def test_pad_mode_is_checked():
    x, w = _inputs(6, (1, 8, 8), 4, 4)
    with pytest.raises(ValueError, match="pad_mode"):
        c4.down4(torch.from_numpy(x), torch.from_numpy(w), "zeros")
    with pytest.raises(ValueError, match="pad_mode"):
        c4.down4s_fwd(torch.from_numpy(x), torch.from_numpy(w), "wrap")


# ------------------------------------------------------------ group norm


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("c", [16, 48])
def test_group_norm_matches_flax(dtype, c):
    """flax nn.GroupNorm(num_groups=None, group_size=16): epsilon 1e-6,
    f32 statistics, and an f32 output for bf16 input too.  Held to 1e-5
    of the largest magnitude (f32 sums in another order)."""
    rng = np.random.default_rng(c)
    x = (2.0 + 3.0 * rng.standard_normal((2, 6, 5, c))).astype(np.float32)
    scale = (1 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(c)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    ref = fnn.GroupNorm(num_groups=None, group_size=16)
    want = ref.apply({"params": {"scale": scale, "bias": bias}},
                     jnp.asarray(x).astype(jdt))
    gn = GroupNorm(c)
    with torch.no_grad():
        gn.scale.copy_(torch.from_numpy(scale))
        gn.bias.copy_(torch.from_numpy(bias))
        got = gn(torch.from_numpy(x).to(tdt))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
    with pytest.raises(ValueError, match="group size"):
        GroupNorm(c + 8)
