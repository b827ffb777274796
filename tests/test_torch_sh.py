"""Port parity: SH basis and the K1 twin (fan-fused SH shading) vs rnr_tpu.

The JAX side runs the Pallas sh_shade_fan in interpret mode, as its own
tests do; inputs are made with NumPy from a seed and handed to both.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnr_tpu.models.rays import RaySampler as JaxRaySampler
from rnr_tpu.ops.sh import evaluate_sh_basis as jax_basis
from rnr_tpu.ops.sh_pallas import sh_shade_fan as jax_sh_shade_fan
from rnr_tpu_torch.models.rays import RaySampler, build_fan_channels
from rnr_tpu_torch.ops.sh import evaluate_sh_basis
from rnr_tpu_torch.ops.sh_cuda import (fan_basis_scale, fan_bwd_partials,
                                       fan_coeff, sh_shade_fan,
                                       sh_shade_bwd_torch,
                                       sh_shade_fan_bwd_torch,
                                       sh_shade_fan_torch, sh_shade_torch)
from rnr_tpu_torch.synthetic import build_batch

torch.set_num_threads(2)


def _unit(rng, shape):
    d = rng.standard_normal(shape + (3,))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def test_evaluate_sh_basis_lmax10_matches_jax():
    rng = np.random.default_rng(0)
    d = _unit(rng, (500,))
    # the poles and the equator, where the azimuth guard and st = 0 act
    d[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 1, 0]]
    want = np.asarray(jax_basis(10, jnp.asarray(d)))
    got = evaluate_sh_basis(10, torch.from_numpy(d)).numpy()
    assert got.shape == (500, 121)
    # same f32 ops in the same order; the lmax-10 values reach ~2
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def _fan_inputs(rng, size):
    b = build_batch(size, 64)
    tbn = b["TBN_map"]
    vdt = _unit(rng, (1, size, size))
    alpha = b["alpha_map"]
    spec, diff = RaySampler(2, 1, 5.0, "reflect"), RaySampler(2, 1, 10.0,
                                                              "diffuse")
    pivots = np.concatenate([spec.pivots_dir.T, diff.pivots_dir.T]
                            ).astype(np.float32)[:5]       # R = 3 + 2
    lt = rng.uniform(0, 2, (1, size, size, 5, 3)).astype(np.float32)
    coeff = (0.5 * rng.standard_normal((25, 3))).astype(np.float32)
    return tbn, vdt, alpha, lt, coeff, pivots


@pytest.mark.parametrize("lt_dtype", ["float32", "bfloat16"])
def test_sh_shade_fan_twin_matches_jax_interpret(lt_dtype):
    rng = np.random.default_rng(2)
    tbn, vdt, alpha, lt, coeff, pivots = _fan_inputs(rng, 16)
    jdt = jnp.dtype(lt_dtype)
    js, jd = jax_sh_shade_fan(
        jnp.asarray(tbn), jnp.asarray(vdt), jnp.asarray(alpha),
        jnp.asarray(lt).astype(jdt), jnp.asarray(coeff), jnp.asarray(pivots),
        4, 3, True)
    tdt = getattr(torch, lt_dtype)
    ts, td = sh_shade_fan(
        torch.from_numpy(tbn), torch.from_numpy(vdt),
        torch.from_numpy(alpha), torch.from_numpy(lt).to(tdt),
        torch.from_numpy(coeff), torch.from_numpy(pivots), 4, 3)
    assert float(np.abs(np.asarray(js)).max()) > 0.1   # not vacuous
    # f32 fan and radiance on both sides from the same rays_lt values;
    # 1e-4, the tolerance rnr_tpu's own kernel tests use
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-4)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-4)
    assert sh_shade_fan.launches == 0   # CPU tensors never launch


def test_ray_sampler_pivots_and_fan_channels_match_jax():
    rng = np.random.default_rng(3)
    for mode, interval in (("reflect", 5.0), ("diffuse", 10.0)):
        np.testing.assert_allclose(
            RaySampler(6, 2, interval, mode).pivots_dir,
            JaxRaySampler(6, 2, interval, mode).pivots_dir, rtol=0, atol=0)
    from rnr_tpu.models.rays import build_fan_channels as jax_fan
    tbn, vdt, alpha, _, _, pivots = _fan_inputs(rng, 8)
    jn, jr = jax_fan(jnp.asarray(tbn), jnp.asarray(vdt), jnp.asarray(alpha),
                     jnp.asarray(pivots), 3)
    tn, tr = build_fan_channels(torch.from_numpy(tbn), torch.from_numpy(vdt),
                                torch.from_numpy(alpha),
                                torch.from_numpy(pivots), 3)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=0, atol=2e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=2e-6)


def test_twin_equals_wrapper_on_cpu():
    rng = np.random.default_rng(4)
    args = [torch.from_numpy(a) for a in _fan_inputs(rng, 8)]
    a = sh_shade_fan(*args, 4, 3)
    b = sh_shade_fan_torch(*args, 4, 3)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ------------------------------------ K1 / K1b's scaled ladder (csrc/sh_fan.cu)


def _rec_k(l, m):
    """k(l, m) of the kernels' scaled recurrence, rounded to f32."""
    return np.float32(((l - 1) ** 2 - m * m) / (4 * (l - 1) ** 2 - 1))


def _scaled_orders(lmax, d):
    """The kernels' walk of direction d [..., 3] (f32 torch): per order m
    the powers (Tc_m, Ts_m) and the scaled ladder values r(l, m) for l =
    m..lmax, in their order of operations."""
    x, y, z = d.unbind(-1)
    ct = z.clamp(-1.0, 1.0)
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    r2 = x * x + y * y
    inv = torch.where(r2 > 0, torch.rsqrt(torch.where(r2 > 0, r2, 1.0)), 0.0)
    t1c = torch.where(r2 > 0, st * (x * inv), st)
    t1s = st * (y * inv)
    tc, ts = torch.ones_like(ct), torch.zeros_like(ct)
    for m in range(lmax + 1):
        if m == 1:
            tc, ts = t1c, t1s
        elif m > 1:
            tc, ts = tc * t1c - ts * t1s, tc * t1s + ts * t1c
        rs = [torch.ones_like(ct)]
        if m < lmax:
            rs.append(ct)
        for l in range(m + 2, lmax + 1):
            rs.append(ct * rs[-1] - _rec_k(l, m) * rs[-2])
        yield m, tc, ts, rs


def _scaled_basis(lmax, d):
    """basis[b] = scale[b] * r(l, m) * T_m, as K1b sums it into d coeff."""
    scale = torch.tensor(fan_basis_scale(lmax), dtype=d.dtype)
    out = torch.zeros(d.shape[:-1] + ((lmax + 1) ** 2,), dtype=d.dtype)
    for m, tc, ts, rs in _scaled_orders(lmax, d):
        for i, r in enumerate(rs):
            l = m + i
            out[..., l * l + l + m] = r * tc
            if m > 0:
                out[..., l * l + l - m] = r * ts
    return out * scale


def _scaled_radiance(lmax, d, cf_s):
    """rad = sum over m of Tc_m A_m + Ts_m B_m, A_m = sum_l coeff'(l, m)
    r(l, m) (B_m: the -m rows), with the scaled coefficients cf_s."""
    rad = None
    for m, tc, ts, rs in _scaled_orders(lmax, d):
        a = sum(r[..., None] * cf_s[(m + i) ** 2 + m + i + m]
                for i, r in enumerate(rs))
        if m == 0:
            rad = a
            continue
        b = sum(r[..., None] * cf_s[(m + i) ** 2 + m + i - m]
                for i, r in enumerate(rs))
        rad = rad + tc[..., None] * a + ts[..., None] * b
    return rad


def _sh_fan_args(rng, size, lmax, n=1):
    """Fan inputs at n x size^2, R = 5 + 3 rays, alpha 0 on the
    G-buffer's background, and two output gradients."""
    b = build_batch(size, 64, n)
    vdt = _unit(rng, (n, size, size))
    spec, diff = RaySampler(2, 2, 5.0, "reflect"), RaySampler(2, 1, 10.0,
                                                              "diffuse")
    pivots = np.concatenate([spec.pivots_dir.T, diff.pivots_dir.T]
                            ).astype(np.float32)         # R = 5 + 3
    lt = rng.uniform(0, 2, (n, size, size, 8, 3)).astype(np.float32)
    coeff = (0.5 * rng.standard_normal(((lmax + 1) ** 2, 3))).astype(
        np.float32)
    g = rng.standard_normal((2, n, size, size, 3)).astype(np.float32)
    return [torch.from_numpy(a) for a in (b["TBN_map"], vdt, b["alpha_map"],
                                          lt, coeff, pivots, g[0], g[1])]


@pytest.mark.parametrize("lmax", [1, 2, 10])
def test_fan_scaled_basis_matches_basis(lmax):
    """scale * r(l, m) * T_m is the basis, the zero vector (ct 0, st 1,
    azimuth (1, 0)) and the poles included (f32, 2e-6)."""
    d = _unit(np.random.default_rng(lmax), (400,))
    d[:4] = [[0, 0, 0], [0, 0, 1], [0, 0, -1], [1, 0, 0]]
    d = torch.from_numpy(d)
    want = evaluate_sh_basis(lmax, d)
    got = _scaled_basis(lmax, d)
    assert float(want[0].abs().max()) > 0.1   # the zero vector's values
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("lmax", [2, 10])
def test_fan_scaled_forward_reproduces_plain(lmax):
    """fan_coeff's scaled coefficients folded per order (K1's order of
    operations) give sh_shade_fan_torch within K1's unit-test tolerance,
    1e-4 x max + 1e-6 (f32; another order of sums)."""
    tbn, vdt, al, lt, coeff, pivots, _, _ = _sh_fan_args(
        np.random.default_rng(10 + lmax), 12, lmax)
    r_spec = 5
    rays = build_fan_channels(tbn, vdt, al, pivots, r_spec)[1]
    cf_s = fan_coeff(coeff, lmax)
    acc_s = acc_d = 0.0
    for r in range(rays.shape[-1]):
        v = lt[..., r, :] * _scaled_radiance(lmax, rays[..., r], cf_s)
        if r < r_spec:
            acc_s = acc_s + v
        else:
            acc_d = acc_d + v
    got_s, got_d = acc_s * (al / r_spec), acc_d * (al / 3)
    want_s, want_d = sh_shade_fan_torch(tbn, vdt, al, lt, coeff, pivots,
                                        lmax, r_spec)
    for got, want in ((got_s, want_s), (got_d, want_d)):
        tol = 1e-4 * float(want.abs().max()) + 1e-6
        assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("lmax", [2, 10])
def test_fan_scaled_backward_reproduces_plain(lmax):
    """K1b's order: d rays_lt = rad * gsel from the per-order fold, d coeff
    = scale * sum of r(l, m) * T_m * rays_lt * gsel; against
    sh_shade_fan_bwd_torch within K1b's tolerances (d coeff 1e-4 x max,
    f32 d rays_lt 1e-5 x max)."""
    tbn, vdt, al, lt, coeff, pivots, gs, gd = _sh_fan_args(
        np.random.default_rng(20 + lmax), 12, lmax, n=2)
    r_spec = 5
    rays = build_fan_channels(tbn, vdt, al, pivots, r_spec)[1]
    cf_s = fan_coeff(coeff, lmax)
    scale = torch.tensor(fan_basis_scale(lmax), dtype=torch.float32)
    ws, wd = al / r_spec, al / 3
    dlt = torch.empty_like(lt)
    dcs = torch.zeros_like(coeff)
    for r in range(rays.shape[-1]):
        gsel = gs * ws if r < r_spec else gd * wd
        d = rays[..., r]
        dlt[..., r, :] = _scaled_radiance(lmax, d, cf_s) * gsel
        ltg = lt[..., r, :] * gsel
        dcs += torch.einsum("nhwb,nhwc->bc", _scaled_basis(lmax, d) / scale,
                            ltg)
    dcoeff = dcs * scale[:, None]
    want_l, want_c = sh_shade_fan_bwd_torch(tbn, vdt, al, lt, coeff, pivots,
                                            gs, gd, lmax, r_spec)
    assert float((dcoeff - want_c).abs().max()) <= 1e-4 * float(
        want_c.abs().max())
    assert float((dlt - want_l).abs().max()) <= 1e-5 * float(
        want_l.abs().max())


@pytest.mark.parametrize("n_pix,lmax", [(576, 2), (1152, 10), (262144, 10),
                                        (524288, 10), (1, 1)])
def test_fan_bwd_partials_one_row_per_block(n_pix, lmax):
    """K1b's partials: (lmax+1)^2 * 3 floats per block of 64 pixels, the
    last block ragged."""
    blocks = (n_pix + 63) // 64
    assert fan_bwd_partials(n_pix, lmax) == blocks * 3 * (lmax + 1) ** 2


def test_fan_coeff_scales_rows():
    """fan_coeff: coeff rows times fan_basis_scale, f32; the scale of
    (0, 0) is 1 / sqrt(4 pi) and of (1, +-1) sqrt(2) * sqrt(3/2) / sqrt(4
    pi), the diagonal's constant and sqrt 2."""
    coeff = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (121, 3)).astype(np.float32))
    scale = fan_basis_scale(10)
    k0 = 1 / math.sqrt(4 * math.pi)
    assert math.isclose(scale[0], k0, rel_tol=1e-15)
    assert math.isclose(scale[1], math.sqrt(3.0) * k0, rel_tol=1e-15)
    assert math.isclose(scale[3], math.sqrt(3.0) * k0, rel_tol=1e-15)
    assert math.isclose(scale[2], math.sqrt(3.0) * k0, rel_tol=1e-15)
    got = fan_coeff(coeff, 10)
    assert got.dtype == torch.float32 and got.shape == (121, 3)
    torch.testing.assert_close(
        got, coeff * torch.tensor(scale, dtype=torch.float32)[:, None],
        rtol=0, atol=0)


# ------------------- K5 on materialised rays: the same ladder (csrc/sh_shade.cu)


def k5_emulate(rays_dir, rays_lt, alpha, coeff, lmax, r_spec, dtype):
    """K5's forward in `dtype`: per ray the direction as stored (widened,
    not renormalised), the scaled ladder folded per order into fan_coeff's
    coefficients, rays_lt * radiance summed per fan, then times alpha /
    r_spec (or / max(R - r_spec, 1)) once per pixel."""
    r_total = rays_dir.shape[-1]
    cf_s = fan_coeff(coeff, lmax).to(dtype)
    acc_s = acc_d = torch.zeros(rays_lt.shape[:-2] + (3,), dtype=dtype)
    for r in range(r_total):
        d = rays_dir[..., r].to(dtype)
        v = rays_lt[..., r, :].to(dtype) * _scaled_radiance(lmax, d, cf_s)
        if r < r_spec:
            acc_s = acc_s + v
        else:
            acc_d = acc_d + v
    al = alpha.to(dtype)
    return acc_s * (al / r_spec), acc_d * (al / max(r_total - r_spec, 1))


def _k5_rays(rng, size, r_total):
    """rays_dir [1, size, size, 3, R] in bf16: unit directions rounded to
    bf16 (not exactly unit), a quarter of them scaled by 0.9 to 1.1, the
    poles, and the zero vector at the masked pixels (alpha 0), as the fan
    builder leaves them; rays_lt in bf16; alpha."""
    d = _unit(rng, (1, size, size, r_total))
    d *= rng.choice([1.0, 1.0, 1.0, 0.9, 1.1], d.shape[:-1] + (1,))
    d[0, 0, 0, :2] = [[0, 0, 1], [0, 0, -1]]
    alpha = np.ones((1, size, size, 1), np.float32)
    alpha[0, -2:, :] = 0.0
    d[0, -2:, :] = 0.0
    rays_dir = torch.from_numpy(np.moveaxis(d, -1, -2).copy()).to(
        torch.bfloat16)                                   # [1, s, s, 3, R]
    lt = torch.from_numpy(rng.uniform(0, 2, (1, size, size, r_total, 3))
                          .astype(np.float32)).to(torch.bfloat16)
    return rays_dir, lt, torch.from_numpy(alpha)


@pytest.mark.parametrize("lmax", list(range(11)))
@pytest.mark.parametrize("r_spec", [1, 13, 26])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k5_scaled_forward_on_materialised_rays(lmax, r_spec, dtype):
    """K5's order of operations (the scaled ladder, the per-order fold,
    alpha / r_spec once per pixel) on stored bf16 rays of 13 + 13 rays:
    non-unit directions, the poles and zero directions at masked pixels;
    against sh_shade_torch within kernels_shade's tolerance, 1e-4 x max +
    1e-5; masked pixels exactly 0."""
    rng = np.random.default_rng(100 * lmax + r_spec)
    rd, lt, al = _k5_rays(rng, 6, 26)
    coeff = torch.from_numpy((0.3 * rng.standard_normal(
        ((lmax + 1) ** 2, 3))).astype(np.float32))
    got = k5_emulate(rd, lt, al, coeff, lmax, r_spec, dtype)
    want = sh_shade_torch(rd, lt, al, coeff, lmax, r_spec)
    masked = al[..., 0] == 0
    for g, w_ in zip(got, want):
        g = g.float()
        assert g.shape == w_.shape
        assert float((g - w_).abs().max()) <= (
            1e-4 * float(w_.abs().max()) + 1e-5)
        assert bool((g[masked] == 0).all())


# csrc/sh_bwd.cuh: warps a block splits the orders between, pixels a
# block, even powers a K5b chunk stores at most (T_2 .. T_8)
K5B_WARPS = 4
K5B_PIXELS = 64
K5B_POWERS = 4


def _order_owner(lmax):
    """csrc/sh_bwd.cuh order_owner: the warp of each order, taken by
    falling cost (the lowest order on a tie), each to the least loaded
    warp so far (the lowest on a tie)."""
    def cost(m):
        return 8 * (lmax + 1) if m == 0 else 14 * (lmax + 1 - m) + 8
    load, owner = [0] * K5B_WARPS, {}
    for _ in range(lmax + 1):
        m = max((o for o in range(lmax + 1) if o not in owner),
                key=lambda o: (cost(o), -o))
        w = min(range(K5B_WARPS), key=lambda i: (load[i], i))
        owner[m] = w
        load[w] += cost(m)
    return owner


def _next_power(tc, ts, t1c, t1s):
    return tc * t1c - ts * t1s, tc * t1s + ts * t1c


def k5b_emulate(rays_dir, rays_lt, alpha, coeff, gs, gd, lmax, r_spec,
                dtype):
    """K5b (csrc/sh_shade.cu on csrc/sh_bwd.cuh) in `dtype`, in its order of
    operations: (d rays_lt in rays_lt's dtype, d coeff).

    Per pixel gsel = g * (alpha / r_spec) (or / max(R - r_spec, 1)); per
    ray the direction as stored, ct and T_1, the build's chain of products
    storing T_2 .. T_2k (k = min(lmax / 2, 4)), and ltg = rays_lt * gsel.
    Each order m takes T_m from the stored T_2k below it by the same chain
    (T_9 and T_10 from T_8), walks its ladder r(l, m) with the scaled
    coefficients and folds its radiance part into its warp's (order_owner:
    rad = Tc A + (Ts B + rad), orders ascending); d rays_lt = the warps'
    parts added in warp order, times gsel.  d coeff: each lane of a block
    of 64 pixels sums r(l, m) * (T_m * ltg) over its pixels lane and lane +
    32, ray by ray; the 32 lanes are added in lane order into the block's
    partial; the partials are added per lane over blocks lane, lane + 32,
    ... and then by an xor tree, as sum_fan_partials does, and scaled."""
    r_total = rays_dir.shape[-1]
    n_pix = alpha.numel()
    blocks = -(-n_pix // K5B_PIXELS)
    pad = blocks * K5B_PIXELS - n_pix

    def flat(t, tail):   # [n_pix, *tail] in dtype, zero past the pixels
        t = t.reshape((n_pix,) + tail).to(dtype)
        return torch.cat([t, t.new_zeros((pad,) + tail)])

    rd = flat(rays_dir, (3, r_total))
    lt = flat(rays_lt, (r_total, 3))
    al = flat(alpha, ())
    gsel_s = flat(gs, (3,)) * (al / r_spec)[:, None]
    gsel_d = flat(gd, (3,)) * (al / max(r_total - r_spec, 1))[:, None]
    cf_s = fan_coeff(coeff, lmax).to(dtype)
    owner = _order_owner(lmax)
    npow = min(lmax // 2, K5B_POWERS)
    nb = (lmax + 1) ** 2
    n_all = blocks * K5B_PIXELS
    dlt = torch.empty((n_all, r_total, 3), dtype=rays_lt.dtype)
    dc = torch.zeros((blocks, 32, nb, 3), dtype=dtype)
    one, zero = torch.ones(n_all, dtype=dtype), torch.zeros(n_all,
                                                            dtype=dtype)
    for r in range(r_total):
        x, y, z = rd[:, 0, r], rd[:, 1, r], rd[:, 2, r]
        ct = z.clamp(-1.0, 1.0)
        st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
        r2 = x * x + y * y
        inv = torch.where(r2 > 0, torch.rsqrt(torch.where(r2 > 0, r2, 1.0)),
                          0.0)
        t1c = torch.where(r2 > 0, st * (x * inv), st)
        t1s = st * (y * inv)
        gsel = gsel_s if r < r_spec else gsel_d
        ltg = lt[:, r] * gsel
        stored, tc, ts = {}, t1c, t1s
        for m in range(2, 2 * npow + 1):
            tc, ts = _next_power(tc, ts, t1c, t1s)
            if m % 2 == 0:
                stored[m // 2] = (tc, ts)
        rad = [torch.zeros((n_all, 3), dtype=dtype)
               for _ in range(K5B_WARPS)]
        contrib = torch.zeros((n_all, nb, 3), dtype=dtype)
        for m in range(lmax + 1):
            if m < 2:
                tc, ts = (one, zero) if m == 0 else (t1c, t1s)
            else:
                k = min(m // 2, npow)
                tc, ts = stored[k]
                for _ in range(2 * k, m):
                    tc, ts = _next_power(tc, ts, t1c, t1s)
            cl, sl = tc[:, None] * ltg, ts[:, None] * ltg
            a = cf_s[m * m + 2 * m].expand(n_all, 3)
            b = cf_s[m * m].expand(n_all, 3)
            contrib[:, m * m + 2 * m] = cl
            if m > 0:
                contrib[:, m * m] = sl
            r0, r1 = one, ct
            for l in range(m + 1, lmax + 1):
                if l > m + 1:
                    r0, r1 = r1, ct * r1 - _rec_k(l, m) * r0
                rv = r1[:, None]
                a = cf_s[l * l + l + m] * rv + a
                contrib[:, l * l + l + m] = rv * cl
                if m > 0:
                    b = cf_s[l * l + l - m] * rv + b
                    contrib[:, l * l + l - m] = rv * sl
            w = owner[m]
            rad[w] = (rad[w] + a if m == 0
                      else tc[:, None] * a + (ts[:, None] * b + rad[w]))
        total = rad[0]
        for w in range(1, K5B_WARPS):
            total = total + rad[w]
        dlt[:, r] = (total * gsel).to(rays_lt.dtype)
        halves = contrib.reshape(blocks, 2, 32, nb, 3)
        dc = dc + halves[:, 0]
        dc = dc + halves[:, 1]
    part = torch.zeros((blocks, nb, 3), dtype=dtype)
    for lane in range(32):
        part = part + dc[:, lane]
    acc = torch.zeros((32, nb, 3), dtype=dtype)
    for k in range(blocks):
        acc[k % 32] = acc[k % 32] + part[k]
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[torch.arange(32) ^ o]
    scale = torch.tensor(fan_basis_scale(lmax), dtype=dtype)
    return (dlt[:n_pix].reshape(rays_lt.shape), acc[0] * scale[:, None])


@pytest.mark.parametrize("lmax", list(range(11)))
@pytest.mark.parametrize("r_spec", [1, 13, 26])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k5b_scaled_backward_on_materialised_rays(lmax, r_spec, dtype):
    """K5b's order of operations (k5b_emulate: K1b's backward on stored
    rays, T_9 and T_10 from the stored T_8, the per-order fold summed in
    warp order, d coeff summed per lane, lane order and block order) on
    stored bf16 rays of 13 + 13 rays over 100 pixels (two blocks, the
    second partly dead): non-unit directions, the poles and zero
    directions at masked pixels.  Against sh_shade_bwd_torch within
    kernels_shade's tolerances (d coeff 1e-4 x max, d rays_lt 2^-7 x max
    after the bf16 rounding); masked pixels' d rays_lt exactly 0."""
    rng = np.random.default_rng(1000 + 100 * lmax + r_spec)
    rd, lt, al = _k5_rays(rng, 10, 26)
    coeff = torch.from_numpy((0.3 * rng.standard_normal(
        ((lmax + 1) ** 2, 3))).astype(np.float32))
    gs, gd = (torch.from_numpy(rng.standard_normal((1, 10, 10, 3)).astype(
        np.float32)) for _ in range(2))
    dlt, dcoeff = k5b_emulate(rd, lt, al, coeff, gs, gd, lmax, r_spec, dtype)
    want_l, want_c = sh_shade_bwd_torch(rd, lt, al, coeff, gs, gd, lmax,
                                        r_spec)
    assert dlt.shape == want_l.shape and dcoeff.shape == want_c.shape
    assert dlt.dtype == want_l.dtype
    assert float((dcoeff.float() - want_c).abs().max()) <= 1e-4 * float(
        want_c.abs().max())
    assert float((dlt.float() - want_l.float()).abs().max()) <= 2 ** -7 * (
        float(want_l.float().abs().max()))
    masked = al[..., 0] == 0
    assert bool((dlt[masked] == 0).all())
