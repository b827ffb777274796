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
from rnr_tpu_torch.ops.sh import evaluate_sh_basis, ladder_constants
from rnr_tpu_torch.ops.sh_cuda import sh_shade_fan, sh_shade_fan_torch
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


def _kernel_ladder(lmax, d):
    """The CUDA kernel's ladder walk (csrc/sh_fan.cu), in NumPy f32: it
    consumes `ladder_constants` in order and advances the azimuth with m."""
    f = np.float32
    lad = [f(v) for v in ladder_constants(lmax)]
    x, y, z = (d[..., i].astype(f) for i in range(3))
    ct = np.clip(z, -1, 1)
    st = np.sqrt(np.maximum(f(1) - ct * ct, 0))
    r2 = x * x + y * y
    inv = np.where(r2 > 0, 1 / np.sqrt(np.where(r2 > 0, r2, 1)), 0).astype(f)
    c1 = np.where(r2 > 0, x * inv, 1).astype(f)
    s1 = (y * inv).astype(f)
    out = np.zeros(d.shape[:-1] + ((lmax + 1) ** 2,), f)
    sqrt2 = f(math.sqrt(2.0))

    def put(l, m, q, cm, sm):
        if m == 0:
            out[..., l * l + l] = q
        else:
            out[..., l * l + l + m] = sqrt2 * q * cm
            out[..., l * l + l - m] = sqrt2 * q * sm

    k = 0
    cm, sm = np.ones_like(x), np.zeros_like(x)
    q_diag = np.full_like(x, f(1 / math.sqrt(4 * math.pi)))
    for m in range(lmax + 1):
        if m == 1:
            cm, sm = c1, s1
        elif m > 1:
            cm, sm = cm * c1 - sm * s1, sm * c1 + cm * s1
        if m > 0:
            q_diag = lad[k] * st * q_diag
            k += 1
        put(m, m, q_diag, cm, sm)
        if m < lmax:
            q_lm1, q_l = q_diag, lad[k] * ct * q_diag
            k += 1
            put(m + 1, m, q_l, cm, sm)
            for l in range(m + 2, lmax + 1):
                a, b = lad[k], lad[k + 1]
                k += 2
                q_l, q_lm1 = a * (ct * q_l - b * q_lm1), q_l
                put(l, m, q_l, cm, sm)
    assert k == len(lad)
    return out


@pytest.mark.parametrize("lmax", [4, 10])
def test_kernel_ladder_table_reproduces_basis(lmax):
    """The constant table the CUDA kernel reads, walked as the kernel
    walks it, gives the JAX basis (f32, 2e-6)."""
    d = _unit(np.random.default_rng(1), (300,))
    want = np.asarray(jax_basis(lmax, jnp.asarray(d)))
    np.testing.assert_allclose(_kernel_ladder(lmax, d), want, rtol=0,
                               atol=2e-6)


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
