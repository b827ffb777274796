"""Port parity of the backward passes: the plain versions of K1b (SH fan
backward), K2b (mipmap scatter), K3's data gradient and K3b (conv weight
gradient) vs rnr_tpu, and the autograd.Functions that bind them.

The JAX side runs its Pallas kernels in interpret mode where it has one
(sh_shade_fan, scatter_taps, conv3x3), as its own tests do, and its XLA
formulations elsewhere.  Inputs are made with NumPy from a seed and handed
to both packages.  On the CPU every wrapper takes its plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnr_tpu.ops.conv_pallas import conv3x3 as jax_conv3x3
from rnr_tpu.ops.interpolate import interpolate_bilinear as jax_interp
from rnr_tpu.ops.sh_pallas import sh_shade_fan as jax_sh_shade_fan
from rnr_tpu.ops.texture_pallas import _chunk_coords, _chunk_values
from rnr_tpu.ops.texture_pallas import _xla_scatter_taps
from rnr_tpu.ops.texture_pallas import mipmap_sample as jax_mipmap_sample
from rnr_tpu.ops.texture_pallas import scatter_taps as jax_scatter_taps
from rnr_tpu_torch.models.rays import RaySampler
from rnr_tpu_torch.ops.conv_cuda import (conv3x3, conv3x3_dgrad_torch,
                                         conv3x3_torch, conv3x3_wgrad,
                                         conv3x3_wgrad_torch)
from rnr_tpu_torch.ops.sh_cuda import (sh_shade_fan, sh_shade_fan_bwd,
                                       sh_shade_fan_bwd_torch,
                                       sh_shade_fan_torch)
from rnr_tpu_torch.ops.texture_cuda import (level_coords, mipmap_sample,
                                            mipmap_sample_torch,
                                            mipmap_scatter,
                                            scatter_taps_torch)
from rnr_tpu_torch.synthetic import build_batch

torch.set_num_threads(2)


def _max(a) -> float:
    return float(np.abs(np.asarray(a, np.float32)).max())


# ---------------------------------------------------------------- K1b


def _fan_case(seed):
    """8 x 16 pixels of the synthetic sphere, random unit view
    directions, R = 5 + 5 rays."""
    rng = np.random.default_rng(seed)
    b = build_batch(16, 64)
    tbn = b["TBN_map"][:, :8]
    alpha = b["alpha_map"][:, :8]
    vdt = rng.standard_normal((1, 8, 16, 3))
    vdt = (vdt / np.linalg.norm(vdt, axis=-1, keepdims=True)).astype(np.float32)
    spec, diff = RaySampler(2, 2, 5.0, "reflect"), RaySampler(2, 2, 10.0,
                                                              "diffuse")
    pivots = np.concatenate([spec.pivots_dir.T, diff.pivots_dir.T]
                            ).astype(np.float32)
    lt = rng.uniform(0, 2, (1, 8, 16, 10, 3)).astype(np.float32)
    gs = rng.standard_normal((1, 8, 16, 3)).astype(np.float32)
    gd = rng.standard_normal((1, 8, 16, 3)).astype(np.float32)
    return tbn, vdt, alpha, lt, pivots, gs, gd


@pytest.mark.parametrize("lmax", [2, 10])
@pytest.mark.parametrize("lt_dtype", ["float32", "bfloat16"])
def test_sh_fan_bwd_plain_matches_jax_vjp(lmax, lt_dtype):
    """d rays_lt and d coeff of the plain K1b against jax.vjp of the
    interpret-mode sh_shade_fan.  Both sides rebuild the fan and the
    ladder in f32 and sum in f32 in another order: d coeff to 1e-4 x its
    max, d rays_lt to 1e-5 x max in f32 and to one bf16 rounding step
    (2^-8 relative, 2^-7 x max for a flip) in bf16."""
    tbn, vdt, alpha, lt, pivots, gs, gd = _fan_case(lmax)
    coeff = (0.5 * np.random.default_rng(7).standard_normal(
        ((lmax + 1) ** 2, 3))).astype(np.float32)
    jdt = jnp.dtype(lt_dtype)
    ltj = jnp.asarray(lt).astype(jdt)
    _, vjp = jax.vjp(
        lambda l_, c_: jax_sh_shade_fan(jnp.asarray(tbn), jnp.asarray(vdt),
                                        jnp.asarray(alpha), l_, c_,
                                        jnp.asarray(pivots), lmax, 5, True),
        ltj, jnp.asarray(coeff))
    jdlt, jdcf = vjp((jnp.asarray(gs), jnp.asarray(gd)))
    tdt = getattr(torch, lt_dtype)
    t = [torch.from_numpy(a) for a in (tbn, vdt, alpha)]
    ltt = torch.from_numpy(np.array(ltj.astype(jnp.float32))).to(tdt)
    dlt, dcf = sh_shade_fan_bwd(*t, ltt, torch.from_numpy(coeff),
                                torch.from_numpy(pivots),
                                torch.from_numpy(gs), torch.from_numpy(gd),
                                lmax, 5)
    assert dlt.dtype == tdt and dcf.dtype == torch.float32
    want_dlt = np.asarray(jdlt.astype(jnp.float32))
    got_dlt = dlt.float().numpy()
    scale = _max(want_dlt)
    assert scale > 1e-2 and _max(jdcf) > 1e-2      # not vacuous
    tol = 1e-5 if lt_dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got_dlt, want_dlt, rtol=0, atol=tol * scale)
    np.testing.assert_allclose(dcf.numpy(), np.asarray(jdcf), rtol=0,
                               atol=1e-4 * _max(jdcf))
    assert sh_shade_fan_bwd.launches == 0


def test_sh_fan_function_backward_is_the_plain_backward():
    """Through the autograd.Function on CPU tensors: the gradients are
    exactly those of sh_shade_fan_bwd_torch, and agree with autograd
    through the plain forward (f32, 1e-5 x max); the G-buffer inputs get
    none."""
    tbn, vdt, alpha, lt, pivots, gs, gd = _fan_case(3)
    coeff = (0.5 * np.random.default_rng(8).standard_normal((9, 3))).astype(
        np.float32)
    g = [torch.from_numpy(a).requires_grad_() for a in (tbn, vdt, alpha)]
    lt_t = torch.from_numpy(lt).requires_grad_()
    cf_t = torch.from_numpy(coeff).requires_grad_()
    piv = torch.from_numpy(pivots)
    s, d = sh_shade_fan(*g, lt_t, cf_t, piv, 2, 5)
    (s * torch.from_numpy(gs) + d * torch.from_numpy(gd)).sum().backward()
    want_lt, want_cf = sh_shade_fan_bwd_torch(
        *[x.detach() for x in g], lt_t.detach(), cf_t.detach(), piv,
        torch.from_numpy(gs), torch.from_numpy(gd), 2, 5)
    assert torch.equal(lt_t.grad, want_lt) and torch.equal(cf_t.grad, want_cf)
    assert all(x.grad is None for x in g)
    lt2 = torch.from_numpy(lt).requires_grad_()
    cf2 = torch.from_numpy(coeff).requires_grad_()
    s2, d2 = sh_shade_fan_torch(*[x.detach() for x in g], lt2, cf2, piv, 2, 5)
    (s2 * torch.from_numpy(gs) + d2 * torch.from_numpy(gd)).sum().backward()
    for a, e in ((lt_t.grad, lt2.grad), (cf_t.grad, cf2.grad)):
        np.testing.assert_allclose(a.numpy(), e.numpy(), rtol=0,
                                   atol=1e-5 * _max(e))


# ---------------------------------------------------------------- K2b

SIZES = (64, 32, 16, 8)


def _scatter_case(seed, hw=32):
    """uv over [0, 1] with the edges, a row outside [0, 1], and a block
    of pixels all at uv = 0 (the uncovered pixels of a G-buffer, which
    share one corner texel of every level)."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(0, 1, (1, hw, hw, 2)).astype(np.float32)
    uv[0, 0, :8] = [[0, 0], [1, 1], [0, 1], [1, 0], [1, 0.5], [0.5, 1],
                    [0.25, 0], [0, 0.75]]
    uv[0, 1, :4] = [[-0.1, 0.5], [1.1, 0.5], [0.5, -0.2], [0.5, 1.3]]
    uv[0, 8:24, 8:24] = 0.0
    g = rng.standard_normal((1, hw, hw, 24)).astype(np.float32)
    return uv, g


def test_scatter_plain_matches_xla_scatter_taps():
    """One level, f32: the plain scatter against rnr_tpu's XLA scatter
    (same taps, same f32 products; sums in another order: 1e-6 x max)."""
    uv, g = _scatter_case(0)
    for s in SIZES:
        x, y = level_coords(torch.from_numpy(uv), s)
        got = scatter_taps_torch(x, y, torch.from_numpy(g), s).numpy()
        want = np.asarray(_xla_scatter_taps(
            jnp.asarray(x.numpy()), jnp.asarray(y.numpy()), jnp.asarray(g),
            s, s))
        assert _max(want) > 1.0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * _max(want))


def test_mipmap_backward_matches_jax_grad_of_xla_path():
    """Every level's gradient through the port's autograd.Function (the
    plain K2b on CPU) against jax.vjp of the f32 XLA texture path
    (interpolate per level, summed), 1e-6 x max."""
    uv, g = _scatter_case(1)
    rng = np.random.default_rng(2)
    levels = [rng.standard_normal((s, s, 24)).astype(np.float32)
              for s in SIZES]

    def jax_fwd(*texs):
        out = None
        for tex in texs:
            s = tex.shape[0]
            x = jnp.asarray(uv)[..., 0] * (s - 1)
            y = (s - 1) - jnp.asarray(uv)[..., 1] * (s - 1)
            v = jax_interp(tex, x, y)
            out = v if out is None else out + v
        return out

    _, vjp = jax.vjp(jax_fwd, *[jnp.asarray(t) for t in levels])
    want = vjp(jnp.asarray(g))
    tex_t = [torch.from_numpy(t).requires_grad_() for t in levels]
    uv_t = torch.from_numpy(uv).requires_grad_()
    out = mipmap_sample(tex_t, uv_t)
    np.testing.assert_allclose(
        out.detach().numpy(),
        mipmap_sample_torch([t.detach() for t in tex_t], uv_t.detach()).numpy(),
        rtol=0, atol=0)
    (out * torch.from_numpy(g)).sum().backward()
    assert uv_t.grad is None                      # uv is data
    for t, w in zip(tex_t, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6 * _max(w))
    assert mipmap_sample.launches == 0 and mipmap_scatter.launches == 0


def test_scatter_plain_matches_jax_scatter_taps_interpret():
    """Against the TPU kernel run in interpret mode, which rounds w * g to
    bf16 before its matmul (texture_pallas.py:163): 8 bits, so each term
    is off by up to 2^-9 of itself, and the errors of the many terms on
    one texel (the uv = 0 corner collects 256) add: 1e-2 x max."""
    uv, g = _scatter_case(3)
    gc = _chunk_values(jnp.asarray(g), block=32)
    for s in SIZES:
        x, y = level_coords(torch.from_numpy(uv), s)
        xc, yc = _chunk_coords(jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
                               block=32)
        want, overflow = jax_scatter_taps(xc, yc, gc, s, s, interpret=True)
        assert int(overflow) == 0
        got = scatter_taps_torch(x, y, torch.from_numpy(g), s).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=1e-2 * _max(want))


def test_mipmap_backward_matches_jax_pallas_interpret_vjp():
    """The level gradients of the whole custom VJP of rnr_tpu's Pallas
    mipmap_sample (interpret mode) vs the port's, at the same bf16-product
    tolerance."""
    uv, g = _scatter_case(4)
    rng = np.random.default_rng(5)
    levels = [rng.standard_normal((s, s, 24)).astype(np.float32)
              for s in SIZES]
    _, vjp = jax.vjp(lambda *t: jax_mipmap_sample(t, jnp.asarray(uv), True),
                     *[jnp.asarray(t) for t in levels])
    want = vjp(jnp.asarray(g))
    got = mipmap_scatter(torch.from_numpy(uv), torch.from_numpy(g), SIZES)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-2 * _max(w))


# ---------------------------------------------------------------- K3 dgrad, K3b


@pytest.mark.parametrize("pad_mode", ["same", "reflect"])
@pytest.mark.parametrize("c", [5, 64])
def test_conv3x3_backward_matches_jax_interpret_vjp(pad_mode, c):
    """dx (K3 on rotated weights + the reflect fold), dW (K3b) and db of
    the port's conv3x3 (CPU: the plain versions) against jax.vjp of
    rnr_tpu's Pallas conv3x3 in interpret mode, bf16 activations.  Both
    multiply bf16 operands exactly and add in f32 in another order: dW
    and db to 1e-4 x max; dx is rounded to bf16 at the end on both sides,
    so one rounding flip (2^-7 x max) is allowed."""
    rng = np.random.default_rng(c)
    o = 12
    x = rng.standard_normal((1, 16, 24, c)).astype(np.float32)
    w = (rng.standard_normal((3, 3, c, o)) / np.sqrt(9 * c)).astype(np.float32)
    b = rng.standard_normal(o).astype(np.float32)
    g = rng.standard_normal((1, 16, 24, o)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    gj = jnp.asarray(g).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda x_, w_, b_: jax_conv3x3(x_, w_, b_, pad_mode,
                                                     False, 0.2, True),
                     xj, jnp.asarray(w), jnp.asarray(b))
    jdx, jdw, jdb = vjp(gj)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y = conv3x3(xt, wt, bt, pad_mode)
    y.backward(torch.from_numpy(np.array(gj.astype(jnp.float32))).to(
        torch.bfloat16))
    assert xt.grad.dtype == torch.bfloat16 and wt.grad.dtype == torch.float32
    want_dx = np.asarray(jdx.astype(jnp.float32))
    np.testing.assert_allclose(xt.grad.float().numpy(), want_dx, rtol=0,
                               atol=2 ** -7 * _max(want_dx))
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw), rtol=0,
                               atol=1e-4 * _max(jdw))
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(jdb), rtol=0,
                               atol=1e-4 * _max(jdb))
    assert conv3x3.launches == 0 and conv3x3_wgrad.launches == 0


@pytest.mark.parametrize("pad_mode", ["same", "reflect"])
def test_conv3x3_backward_structure_matches_autograd_f32(pad_mode):
    """In f32 the rotated-weight dgrad with the exact reflect-pad adjoint
    and the per-tap wgrad equal autograd through the plain forward (to
    f32 rounding, 1e-5 x max), including W = H + 2 and the corners."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((2, 6, 8, 5)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 5, 7)).astype(np.float32))
    b = torch.zeros(7)
    g = torch.from_numpy(rng.standard_normal((2, 6, 8, 7)).astype(np.float32))
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    conv3x3_torch(xa, wa, b, pad_mode).backward(g)
    dx = conv3x3_dgrad_torch(g, w, pad_mode)
    dw = conv3x3_wgrad_torch(x, g, pad_mode)
    np.testing.assert_allclose(dx.numpy(), xa.grad.numpy(), rtol=0,
                               atol=1e-5 * _max(xa.grad))
    np.testing.assert_allclose(dw.numpy(), wa.grad.numpy(), rtol=0,
                               atol=1e-5 * _max(wa.grad))
