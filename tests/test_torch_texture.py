"""Port parity: bilinear gather, the K2 twin (mipmap gather) and the
TextureMapper module vs rnr_tpu."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnr_tpu.models.texture import TextureMapper as JaxTextureMapper
from rnr_tpu.ops.interpolate import interpolate_bilinear as jax_interp
from rnr_tpu.ops.texture_pallas import mipmap_sample as jax_mipmap_sample
from rnr_tpu_torch.convert import load_jax_variables
from rnr_tpu_torch.models.texture import TextureMapper
from rnr_tpu_torch.ops.interpolate import interpolate_bilinear
from rnr_tpu_torch.ops.texture_cuda import mipmap_sample, mipmap_sample_torch

torch.set_num_threads(2)

SIZES = (64, 32, 16, 8)


def _levels(rng, ch=24):
    # random around the JAX init (ones / 0.01): a constant texture would
    # make every comparison below pass whatever the taps
    return [(0.5 + 0.5 * rng.standard_normal((s, s, ch))).astype(np.float32)
            for s in SIZES]


def _uv(rng, h, w):
    uv = rng.uniform(0, 1, (1, h, w, 2)).astype(np.float32)
    # the edges 0 and 1 (weight-anchor fix-up) and a row outside [0, 1]
    uv[0, 0, :8] = [[0, 0], [1, 1], [0, 1], [1, 0], [1, 0.5], [0.5, 1],
                    [0.25, 0], [0, 0.75]]
    uv[0, 1, :4] = [[-0.1, 0.5], [1.1, 0.5], [0.5, -0.2], [0.5, 1.3]]
    return uv


def test_interpolate_bilinear_matches_jax():
    rng = np.random.default_rng(0)
    data = rng.standard_normal((9, 7, 5)).astype(np.float32)
    x = rng.uniform(-1.5, 7.5, (200,)).astype(np.float32)
    y = rng.uniform(-1.5, 9.5, (200,)).astype(np.float32)
    x[:6] = [0, 6, 6, 0, 3, 6]
    y[:6] = [0, 8, 0, 8, 8, 4]
    want = np.asarray(jax_interp(jnp.asarray(data), jnp.asarray(x),
                                 jnp.asarray(y)))
    got = interpolate_bilinear(torch.from_numpy(data), torch.from_numpy(x),
                               torch.from_numpy(y)).numpy()
    # identical f32 ops; out-of-range samples are exactly zero on both
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.all(got[(x < 0) | (x > 6) | (y < 0) | (y > 8)] == 0)


def test_mipmap_twin_matches_f32_level_sum():
    """The f32 XLA path the JAX model takes off the TPU: interpolate per
    level (v flipped), summed; tight f32 tolerance."""
    rng = np.random.default_rng(1)
    levels, uv = _levels(rng), _uv(rng, 32, 32)
    want = None
    for tex in levels:
        s = tex.shape[0]
        x = uv[..., 0] * (s - 1)
        y = (s - 1) - uv[..., 1] * (s - 1)
        v = np.asarray(jax_interp(jnp.asarray(tex), jnp.asarray(x),
                                  jnp.asarray(y)))
        want = v if want is None else want + v
    got = mipmap_sample_torch([torch.from_numpy(t) for t in levels],
                              torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_mipmap_twin_matches_jax_pallas_interpret():
    """Against the TPU kernel run in interpret mode.  That kernel rounds
    the texture to bf16 (texture_pallas.py:412-417), which the port does
    not copy: tolerance 2e-2 for values of ~2 summed over four levels
    (bf16 keeps 8 bits, ~4e-3 relative per texel)."""
    rng = np.random.default_rng(2)
    levels, uv = _levels(rng), _uv(rng, 64, 64)
    want = np.asarray(jax_mipmap_sample(
        tuple(jnp.asarray(t) for t in levels), jnp.asarray(uv), True))
    got = mipmap_sample([torch.from_numpy(t) for t in levels],
                        torch.from_numpy(uv)).numpy()
    assert got.shape == (1, 64, 64, 24)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    assert mipmap_sample.launches == 0   # CPU tensors never launch


@pytest.mark.parametrize("apply_sh", [True, False])
def test_texture_mapper_matches_jax(apply_sh):
    rng = np.random.default_rng(3)
    uv = _uv(rng, 16, 16)
    sh = rng.standard_normal((1, 16, 16, 9)).astype(np.float32)
    jm = JaxTextureMapper(texture_size=64, texture_num_ch=24,
                          mipmap_level=4, apply_sh=apply_sh)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(uv),
                                    jnp.asarray(sh), 6))["params"]
    params = {k: np.asarray(v) + rng.standard_normal(v.shape).astype(
        np.float32) for k, v in params.items()}
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(uv),
                               jnp.asarray(sh), 6))
    tm = load_jax_variables(TextureMapper(64, 24, 4, apply_sh),
                            {"params": params})
    got = tm(torch.from_numpy(uv), torch.from_numpy(sh), 6).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
