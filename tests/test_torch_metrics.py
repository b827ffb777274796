"""Port parity of the image metrics: `ops/metrics.py` (psnr, ssim,
masked_err_metrics) and `utils/eval_metrics.py` (psnr_np,
compute_err_metrics[_batch]) against rnr_tpu's, on the same NumPy
inputs.  Both sides compute in f32 (the host metrics in float64 around an
f32 SSIM); the tolerances below are f32 rounding of sums in another
order."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from rnr_tpu.ops import metrics as jm
from rnr_tpu.utils import eval_metrics as je
from rnr_tpu_torch.ops import metrics as tm
from rnr_tpu_torch.utils import eval_metrics as te

torch.set_num_threads(2)


def _pair(seed, shape=(2, 40, 52, 3)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 255, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 20, shape), 0, 255).astype(np.float32)
    mask = (rng.uniform(size=shape[:3] + (1,)) > 0.3).astype(np.float32)
    return a, b, mask


@pytest.mark.parametrize("masked", [False, True])
def test_psnr_matches_jax(masked):
    """psnr to 1e-4 dB; identical images give 100 on both sides."""
    a, b, mask = _pair(0)
    m = mask if masked else None
    j = float(jm.psnr(jnp.asarray(a), jnp.asarray(b),
                      None if m is None else jnp.asarray(m)))
    t = float(tm.psnr(torch.from_numpy(a), torch.from_numpy(b),
                      None if m is None else torch.from_numpy(m)))
    assert abs(t - j) <= 1e-4, (t, j)
    assert float(tm.psnr(torch.from_numpy(a), torch.from_numpy(a))) == 100.0


def test_masked_err_metrics_matches_jax():
    a, b, mask = _pair(1)
    j = jm.masked_err_metrics(jnp.asarray(a), jnp.asarray(b),
                              jnp.asarray(mask))
    t = tm.masked_err_metrics(torch.from_numpy(a), torch.from_numpy(b),
                              torch.from_numpy(mask))
    for k in j:
        assert abs(float(t[k]) - float(j[k])) <= 1e-5 * max(
            abs(float(j[k])), 1.0), k


@pytest.mark.parametrize("shape", [(2, 40, 52, 3), (1, 9, 14, 3),
                                   (1, 8, 30, 3)])
def test_ssim_matches_jax(shape):
    """Gaussian SSIM, including windows shrunk below 11 (odd and even
    smaller sides): within 1e-5 of rnr_tpu's."""
    a, b, _ = _pair(2, shape)
    j = float(jm.ssim(jnp.asarray(a), jnp.asarray(b)))
    t = float(tm.ssim(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(t - j) <= 1e-5, (t, j)


def _ssim64(i1, i2, data_range=255.0, win=11):
    """rnr_tpu's float64 SSIM oracle (tests/test_ops_core.py): the same
    window, exactly normalised, and the same clamps."""
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    k = np.asarray(jm._gaussian_kernel(win, 1.5), np.float64)
    k /= k.sum()

    def blur(x):
        y = ndi.convolve1d(x, k, axis=1, mode="constant")
        y = ndi.convolve1d(y, k, axis=2, mode="constant")
        h = win // 2
        return y[:, h:-h, h:-h, :]

    i1, i2 = i1.astype(np.float64), i2.astype(np.float64)
    mu1, mu2 = blur(i1), blur(i2)
    s1 = np.maximum(blur(i1 * i1) - mu1 * mu1, 0)
    s2 = np.maximum(blur(i2 * i2) - mu2 * mu2, 0)
    bd = np.sqrt(s1 * s2)
    s12 = np.clip(blur(i1 * i2) - mu1 * mu2, -bd, bd)
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / (
        (mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))
    return float(m.mean())


@pytest.mark.parametrize("scale", [1e4, 1e5, 1e6])
def test_ssim_bounded_for_unclipped_magnitudes(scale):
    """The mean shift and clamps of rnr_tpu's SSIM (its
    test_ssim_bounded_for_unclipped_magnitudes, with its bounds):
    piecewise-constant images at magnitudes 1e4-1e6 stay in [-1, 1] and
    within 0.05 of the float64 oracle; near-identical constant images
    read above 0.9.  rnr_tpu's f32 value is held to the same oracle
    bound: the two f32 values differ by up to 1.7e-2 at 1e6 (the blurred
    squares cancel down to the contrast from |x| ~ scale, in another
    order of sums on each side), so they are not compared directly."""
    rng = np.random.default_rng(int(np.log10(scale)))
    blocks = [rng.standard_normal((1, 6, 6, 3)) * scale for _ in range(2)]
    a, b = (np.repeat(np.repeat(x, 16, 1), 16, 2).astype(np.float32)
            for x in blocks)
    t = float(tm.ssim(torch.from_numpy(a), torch.from_numpy(b)))
    j = float(jm.ssim(jnp.asarray(a), jnp.asarray(b)))
    assert -1.0001 <= t <= 1.0001, t
    oracle = _ssim64(a, b)
    assert abs(t - oracle) < 0.05, (t, oracle)
    assert abs(j - oracle) < 0.05, (j, oracle)
    const = np.full((1, 64, 64, 3), 9000.0, np.float32)
    assert float(tm.ssim(torch.from_numpy(const),
                         torch.from_numpy(const * 1.0001))) > 0.9


def test_psnr_np_matches_jax():
    a, b, mask = _pair(3, (1, 30, 20, 3))
    a, b, m3 = a[0], b[0], np.repeat(mask[0], 3, -1)
    assert te.psnr_np(a, b) == je.psnr_np(a, b)
    assert te.psnr_np(a, b, m3) == je.psnr_np(a, b, m3)
    assert te.psnr_np(a, a) == je.psnr_np(a, a) == 100.0


def test_compute_err_metrics_batch_matches_jax():
    """Every key, per image and mean, of compute_err_metrics_batch: the
    MAE / MSE / PSNR variants are the same float64 NumPy (equal to 1e-12
    relative), the SSIM variants within 1e-5; an empty mask gives NaN."""
    a, b, mask = _pair(4, (3, 48, 40, 3))
    mask[2] = 0.0
    j = je.compute_err_metrics_batch(a, b, mask)
    t = te.compute_err_metrics_batch(a, b, mask)
    assert set(t) == set(j)
    for k in j:
        jv, tv = np.asarray(j[k], np.float64), np.asarray(t[k], np.float64)
        assert np.array_equal(np.isnan(jv), np.isnan(tv)), k
        tol = 1e-5 if k.startswith("ssim") else 1e-12 * np.nanmax(
            np.abs(jv))
        np.testing.assert_allclose(tv[~np.isnan(tv)], jv[~np.isnan(jv)],
                                   rtol=0, atol=tol, err_msg=k)
