"""The port's fixed-order sums against rnr_tpu, on the CPU.

The card runs the training and eval paths bit for bit the same every
time: K2b sums in 64-bit fixed point, the reflect pad's adjoint and the
bilinear resize's are fixed-order folds and products, rasterize_opt sums
its edge terms per face in pixel order.  These tests hold each of those
forms to rnr_tpu (JAX on the CPU, f32) on inputs made with NumPy from a
seed:

- `reflect_pad1` (NCHW, by 1): its forward equals F.pad's, its backward
  jax.vjp of jnp.pad(mode="reflect");
- the U-Net's reflect convs: down4 / down4s against rnr_tpu's custom
  VJPs (interpret mode), and the "xla" route's Conv (reflect_pad1, then
  F.conv2d) against lax.conv on jnp.pad's reflection;
- `resize_bilinear`'s backward (mipmap flattening, the albedo prior)
  against jax.vjp of jax.image.resize;
- K2b's fixed-point rule (`grid_exponent`): no int64 overflow where every
  pixel weighs 1 on one texel, the grid at most 4x finer than that needs,
  and `mipmap_scatter_fixed_torch` within its stated bound of the exact
  sum and of rnr_tpu's f32 scatter;
- rasterize_opt's backward against rnr_tpu's custom VJP, and bit-equal
  under a permutation of the faces' order;
- the fresh weights of `init_rnr_params`: every parameter the same for
  one seed whatever the global RNG did before, nn.Linear's biases zero
  as flax Dense's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rnr_tpu.ops import conv_pallas as jcp
from rnr_tpu.ops import edge_grad as jeg
from rnr_tpu.ops.texture_pallas import _xla_scatter_taps
from rnr_tpu_torch.models.unet import Conv
from rnr_tpu_torch.ops import conv4_cuda as c4
from rnr_tpu_torch.ops.conv_cuda import reflect_pad1
from rnr_tpu_torch.ops.edge_grad import rasterize_opt
from rnr_tpu_torch.ops.interpolate import bilinear_taps, resize_bilinear
from rnr_tpu_torch.ops.texture_cuda import (grid_exponent, level_coords,
                                            mipmap_scatter_fixed_torch,
                                            scatter_rounding_bound,
                                            scatter_taps_torch)

torch.set_num_threads(2)


def _rng(seed):
    return np.random.default_rng(seed)


def _scaled_close(got, want, atol):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               rtol=0, atol=atol)


# ------------------------------------------------------------ reflect pad


@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 4, 2, 2),
                                   (1, 16, 32, 8)])
def test_reflect_pad1_matches_jnp_pad_and_its_vjp(shape):
    """Forward bit-equal to F.pad(mode="reflect"); backward (the interior,
    then the edges, then the corners) against jax.vjp of rnr_tpu's
    jnp.pad(mode="reflect"), f32: each element a sum of at most four
    terms, 1e-6 of the largest."""
    x = _rng(1).standard_normal(shape).astype(np.float32)
    g = _rng(2).standard_normal(shape[:2] + (shape[2] + 2, shape[3] + 2)
                                ).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    y = reflect_pad1(xt)
    assert torch.equal(y, F.pad(torch.from_numpy(x), (1, 1, 1, 1),
                                mode="reflect"))
    y.backward(torch.from_numpy(g))
    _, vjp = jax.vjp(lambda a: jnp.pad(
        a, ((0, 0), (0, 0), (1, 1), (1, 1)), mode="reflect"), jnp.asarray(x))
    _scaled_close(xt.grad.numpy(), vjp(jnp.asarray(g))[0], 1e-6)


@pytest.mark.parametrize("hw", [(4, 4), (6, 10), (16, 8)])
@pytest.mark.parametrize("name,port,ref", [("down4", c4.down4, jcp.down4),
                                           ("down4s", c4.down4s,
                                            jcp.down4s)])
def test_down4_reflect_gradients_match_rnr_tpus_vjp(name, port, ref, hw):
    """dx and dw of sum(down(x, w, "reflect") * g): the plain conv's
    backward on the ring-padded input, then the fixed-order adjoint of
    the ring, against jax.grad through rnr_tpu's custom VJP (interpret
    mode), f32, 1e-5 of the largest."""
    h, w_ = hw
    rng = _rng(h * w_ + len(name))
    x = rng.standard_normal((2, h, w_, 5)).astype(np.float32)
    w = (0.3 * rng.standard_normal((4, 4, 5, 6))).astype(np.float32)
    g = rng.standard_normal((2, h // 2, w_ // 2, 6)).astype(np.float32)
    jx, jw = jax.grad(lambda a, b: jnp.sum(ref(a, b, "reflect", True) * g),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    (port(xt, wt, "reflect") * torch.from_numpy(g)).sum().backward()
    _scaled_close(xt.grad.numpy(), jx, 1e-5)
    _scaled_close(wt.grad.numpy(), jw, 1e-5)


@pytest.mark.parametrize("k,stride", [(3, 1), (4, 2)])
def test_xla_route_reflect_conv_matches_lax_conv(k, stride):
    """The "xla" route's Conv under reflect padding (reflect_pad1, then
    F.conv2d) against lax.conv on rnr_tpu's jnp.pad reflection: output
    1e-5, dx and dw 1e-5 of their largest, f32."""
    rng = _rng(10 * k)
    x = rng.standard_normal((2, 8, 12, 4)).astype(np.float32)
    w = (0.3 * rng.standard_normal((k, k, 4, 5))).astype(np.float32)
    conv = Conv(4, 5, k, stride, pad_mode="reflect", use_bias=False,
                backend="xla")
    conv.kernel.data = torch.from_numpy(w)
    out_hw = (8 // stride, 12 // stride)
    g = rng.standard_normal((2, *out_hw, 5)).astype(np.float32)

    def jconv(a, b):
        ap = jnp.pad(a, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="reflect")
        return jax.lax.conv_general_dilated(
            ap, b, (stride, stride), "VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    want, vjp = jax.vjp(jconv, jnp.asarray(x), jnp.asarray(w))
    jx, jw = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    y = conv(xt)
    _scaled_close(y.detach().numpy(), want, 1e-5)
    (y * torch.from_numpy(g)).sum().backward()
    _scaled_close(xt.grad.numpy(), jx, 1e-5)
    _scaled_close(conv.kernel.grad.numpy(), jw, 1e-5)


# ------------------------------------------------------- bilinear resize


@pytest.mark.parametrize("n,m", [(4, 16), (16, 32), (32, 128), (8, 512)])
def test_resize_bilinear_backward_matches_jax_image_resize(n, m):
    """The mipmap flattening's upsample (half-pixel, edge-clamped): its
    forward against jax.image.resize, its backward (the interpolation
    matrices' products) against jax.vjp of it, f32, 1e-5 of the
    largest."""
    rng = _rng(n * m)
    x = rng.standard_normal((n, n, 6)).astype(np.float32)
    g = rng.standard_normal((m, m, 6)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jax.image.resize(a, (m, m, 6),
                                                   "bilinear"),
                        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = resize_bilinear(xt, (m, m))
    _scaled_close(y.detach().numpy(), want, 1e-6)
    y.backward(torch.from_numpy(g))
    _scaled_close(xt.grad.numpy(), vjp(jnp.asarray(g))[0], 1e-5)


# ------------------------------------------------------------ K2b's grid


@pytest.mark.parametrize("gmax", [1.0, 3e-5, 7e4, 1e-40])
@pytest.mark.parametrize("pixels", [1, 1000, 512 * 512, 512 * 512 + 1,
                                    4 * 1024 * 1024])
def test_k2b_grid_leaves_no_overflow_at_the_worst_case(pixels, gmax):
    """grid_exponent's k: P pixels all of weight 1 on one texel, each g
    at M = max|g| (the most a texel's sum can reach, P * M), stay below
    2^62 on the grid 2^-k with their P roundings of half a unit, and,
    for an M of f32's normal range, the grid is at most 4x finer than
    that needs (P * M * 2^k >= 2^60; a subnormal M takes the exponent
    -126, a coarser grid)."""
    k = grid_exponent(gmax, pixels)
    m = float(np.float32(gmax))
    q = round(m * 2.0 ** k)            # one tap, rounded onto the grid
    total = pixels * q
    assert total < 2 ** 62
    if m >= 2.0 ** -126:
        assert pixels * m * 2.0 ** k >= 2 ** 60
    assert abs(q - m * 2.0 ** k) <= 0.5


def test_k2b_worst_case_sum_through_the_emulation():
    """Every pixel of a 512^2 frame on the uv = 0 corner texel (weight 1
    at every level), g = M everywhere: the fixed-point sum of P * M, in
    int64 with no overflow, equals P * M to f32 rounding."""
    uv = torch.zeros((1, 512, 512, 2))
    g = torch.full((1, 512, 512, 2), 3.0e4)
    sizes = (8, 4)
    got = mipmap_scatter_fixed_torch(uv, g, sizes)
    want = np.float32(512 * 512 * 3.0e4)
    for s, a in zip(sizes, got):
        assert float(a[s - 1, 0, 0]) == want
        assert float(a.abs().sum()) == 2 * want


def _scatter_case(seed, hw=32):
    """uv over [0, 1] with its edges, a row outside [0, 1] and a block of
    pixels at uv = 0 (the uncovered pixels of a G-buffer); g [1, hw, hw,
    24] of a wide range of magnitudes."""
    rng = _rng(seed)
    uv = rng.uniform(0, 1, (1, hw, hw, 2)).astype(np.float32)
    uv[0, 0, :4] = [[0, 0], [1, 1], [0, 1], [1, 0]]
    uv[0, 1, :4] = [[-0.1, 0.5], [1.1, 0.5], [0.5, -0.2], [0.5, 1.3]]
    uv[0, 8:20, 8:20] = 0.0
    g = (rng.standard_normal((1, hw, hw, 24))
         * 10.0 ** rng.uniform(-4, 2, (1, hw, hw, 1))).astype(np.float32)
    return uv, g


@pytest.mark.parametrize("seed", [0, 1])
def test_k2b_fixed_point_within_its_bound(seed):
    """mipmap_scatter_fixed_torch per level: within (its taps) x half a
    grid step (scatter_rounding_bound) + one f32 rounding of the exact
    sum of the f32-exact products (float64), and within 1e-5 x the sum of
    each texel's |terms| + that bound of rnr_tpu's f32 scatter
    (_xla_scatter_taps)."""
    uv, g = _scatter_case(seed)
    sizes = (64, 32, 16, 8)
    uvt, gt = torch.from_numpy(uv), torch.from_numpy(g)
    got = mipmap_scatter_fixed_torch(uvt, gt, sizes)
    grid = scatter_rounding_bound(uvt, gt, sizes)
    for s, a, q in zip(sizes, got, grid):
        x, y = level_coords(uvt, s)
        exact = torch.zeros((s * s, 24), dtype=torch.float64)
        mag = torch.zeros((s * s, 24), dtype=torch.float64)
        for idx, w in bilinear_taps(x.reshape(-1), y.reshape(-1), s, s):
            t = w.double()[:, None] * gt.reshape(-1, 24).double()
            exact.index_add_(0, idx, t)
            mag.index_add_(0, idx, t.abs())
        exact, mag = exact.reshape(s, s, 24), mag.reshape(s, s, 24)
        ulp = torch.abs(exact.float()).double() * 2.0 ** -24
        assert bool(((a.double() - exact).abs() <= q + ulp * 1.01).all())
        want = np.asarray(_xla_scatter_taps(
            jnp.asarray(x.numpy()), jnp.asarray(y.numpy()), jnp.asarray(g),
            s, s))
        d = np.abs(a.numpy().astype(np.float64) - want)
        assert (d <= 1e-5 * mag.numpy() + q.numpy() + 1e-30).all()
        plain = scatter_taps_torch(x, y, gt, s).double()
        assert bool(((a.double() - plain).abs()
                     <= 1e-5 * mag + q + 1e-30).all())


# ------------------------------------------------------------ rasterize_opt


def _mesh(seed=0, f=24):
    """Random faces over the screen at depths 1.5-4, one partly off
    screen: several faces a pixel."""
    rng = _rng(seed)
    c = rng.uniform(-0.8, 0.8, (1, f, 1, 2))
    xy = c + rng.uniform(-0.5, 0.5, (1, f, 3, 2))
    xy[0, 0] += 0.9
    z = rng.uniform(1.5, 4.0, (1, f, 3, 1))
    return np.concatenate([xy, z], -1).astype(np.float32)


@pytest.mark.parametrize("s", [32, 37])
def test_rasterize_opt_backward_matches_rnr_tpu_and_ignores_face_order(s):
    """The faces' and textures' gradients of a random weighting of rgb,
    alpha and depth against rnr_tpu's custom VJP (1e-4 of the largest),
    and bit-equal, face for face, when the faces (and their textures)
    come in another order: each face's terms are summed in pixel order."""
    f = _mesh(5, 30)
    nf = f.shape[1]
    rng = _rng(6)
    tex = rng.uniform(0, 1, (1, nf, 2, 2, 2, 3)).astype(np.float32)
    w3 = torch.from_numpy(rng.uniform(0.2, 1, (1, 3, s, s)).astype(
        np.float32))
    w1 = torch.from_numpy(rng.uniform(0.2, 1, (1, s, s)).astype(np.float32))
    kw = dict(near=0.0, far=100.0)

    def run(order):
        ft = torch.tensor(f[:, order], requires_grad=True)
        tt = torch.tensor(tex[:, order], requires_grad=True)
        o = rasterize_opt(ft, tt, s, **kw)
        ((o["rgb"] * w3).sum() + (o["alpha"] * w1).sum()
         + (o["depth"] * w1).sum() * 1e-3).backward()
        inv = np.argsort(order)
        return ft.grad[:, inv], tt.grad[:, inv]

    gf, gt = run(np.arange(nf))
    pf, pt = run(_rng(7).permutation(nf))
    assert torch.equal(gf, pf) and torch.equal(gt, pt)

    def jloss(x, t):
        o = jeg.rasterize_opt(x, t, s, **kw)
        return (jnp.sum(o["rgb"] * w3.numpy()) + jnp.sum(o["alpha"]
                                                         * w1.numpy())
                + jnp.sum(o["depth"] * w1.numpy()) * 1e-3)

    jf, jt = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(f),
                                             jnp.asarray(tex))
    _scaled_close(gf.numpy(), jf, 1e-4)
    _scaled_close(gt.numpy(), jt, 1e-4)


# ------------------------------------------------------------ fresh weights


def test_init_rnr_params_is_the_same_draw_whatever_the_global_rng():
    """Two models built with the same seed, the global torch RNG reseeded
    differently before each (as a new process seeds it), carry the same
    bits; the GCN's nn.Linear biases are zero, as flax Dense's."""
    from rnr_tpu_torch.models.rnr import RNRModel
    from rnr_tpu_torch.synthetic import build_config
    from rnr_tpu_torch.train.steps import init_rnr_params
    cfg = build_config(img_size=32, tex_size=32, lmax=2, nf0=4, num_down=2,
                       gcn_blocks=2, num_azi=2, num_polar=1)
    models = []
    for global_seed in (1, 2):
        torch.manual_seed(global_seed)
        models.append(init_rnr_params(RNRModel(cfg, 256, device="cpu"), 0))
    a, b = (dict(m.state_dict()) for m in models)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    biases = [n for n, m in models[0].named_modules()
              if isinstance(m, torch.nn.Linear) and m.bias is not None]
    assert biases
    for n in biases:
        assert not bool(a[f"{n}.bias"].any()), n
