"""The four CUDA kernels of the port against their plain twins, on a GPU.

Marked `cuda`: every test skips (and counts as no pass) where
torch.cuda.is_available() is False, which is decided inside the fixture,
never at import.  On the GPU machine:  python -m pytest tests/test_torch_cuda.py -q
Small, odd shapes that the canonical frame does not reach (scalar
staging paths, ragged tiles, more than four texture levels); the slice
shapes are checked by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from rnr_tpu_torch.models.rays import RaySampler
from rnr_tpu_torch.ops.conv_cuda import conv3x3, conv3x3_torch
from rnr_tpu_torch.ops.knn_cuda import stratified_knn, stratified_knn_torch
from rnr_tpu_torch.ops.sh_cuda import sh_shade_fan, sh_shade_fan_torch
from rnr_tpu_torch.ops.texture_cuda import mipmap_sample, mipmap_sample_torch
from rnr_tpu_torch.synthetic import build_batch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _t(a, dev, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("lmax", [2, 10])
@pytest.mark.parametrize("lt_dtype", [torch.float32, torch.bfloat16])
def test_sh_shade_fan_kernel(dev, lmax, lt_dtype):
    rng = np.random.default_rng(lmax)
    b = build_batch(24, 64)
    spec, diff = RaySampler(2, 2, 5.0, "reflect"), RaySampler(2, 2, 10.0,
                                                              "diffuse")
    piv = np.concatenate([spec.pivots_dir.T, diff.pivots_dir.T]
                         ).astype(np.float32)                  # R = 5 + 5
    vdt = rng.standard_normal((1, 24, 24, 3)).astype(np.float32)
    vdt /= np.linalg.norm(vdt, axis=-1, keepdims=True)
    args = (_t(b["TBN_map"], dev), _t(vdt, dev), _t(b["alpha_map"], dev),
            _t(rng.uniform(0, 2, (1, 24, 24, 10, 3)).astype(np.float32), dev,
               lt_dtype),
            _t((0.5 * rng.standard_normal(((lmax + 1) ** 2, 3))).astype(
                np.float32), dev), _t(piv, dev), lmax, 5)
    n0 = sh_shade_fan.launches
    ks, kd = sh_shade_fan(*args)
    assert sh_shade_fan.launches == n0 + 1
    ts, td = sh_shade_fan_torch(*args)
    torch.cuda.synchronize()
    # f32 on both sides; FMA contraction and sum order differ
    for k, t in ((ks, ts), (kd, td)):
        tol = 1e-4 * float(t.abs().max()) + 1e-6
        assert float((k - t).abs().max()) <= tol


@pytest.mark.parametrize("ch,sizes", [(24, (64, 32, 16, 8)), (5, (16, 8)),
                                      (8, (32, 16, 8, 4, 2))])
def test_mipmap_gather_kernel(dev, ch, sizes):
    rng = np.random.default_rng(ch)
    texs = [_t(rng.standard_normal((s, s, ch)).astype(np.float32), dev)
            for s in sizes]
    uv = rng.uniform(-0.05, 1.05, (2, 16, 8, 2)).astype(np.float32)
    uv[0, 0, :4] = [[0, 0], [1, 1], [0, 1], [1, 0]]
    uv = _t(uv, dev)
    n0 = mipmap_sample.launches
    k = mipmap_sample(texs, uv)
    assert mipmap_sample.launches == n0 + -(-len(sizes) // 4)
    t = mipmap_sample_torch(texs, uv)
    torch.cuda.synchronize()
    assert float((k - t).abs().max()) <= 1e-5 * float(t.abs().max()) + 1e-6


@pytest.mark.parametrize("c,o", [(5, 12), (64, 78), (108, 64), (24, 640)])
@pytest.mark.parametrize("pad_mode", ["same", "reflect"])
def test_conv3x3_kernel(dev, c, o, pad_mode):
    rng = np.random.default_rng(c + o)
    x = _t(rng.standard_normal((2, 7, 9, c)).astype(np.float32), dev,
           torch.bfloat16)
    w = _t((rng.standard_normal((3, 3, c, o)) / np.sqrt(9 * c)).astype(
        np.float32), dev)
    b = _t(rng.standard_normal(o).astype(np.float32), dev)
    n0 = conv3x3.launches
    k = conv3x3(x, w, b, pad_mode)
    assert conv3x3.launches == n0 + 1 and k.dtype == torch.bfloat16
    t = conv3x3_torch(x, w, b, pad_mode)
    torch.cuda.synchronize()
    # bf16 output: at most a rounding step of the largest values
    assert float((k.float() - t.float()).abs().max()) <= (
        2 ** -7 * float(t.float().abs().max()))


def test_conv3x3_kernel_rejects_f32(dev):
    x = torch.zeros((1, 4, 4, 8), device=dev)
    with pytest.raises(TypeError):
        conv3x3(x, torch.zeros((3, 3, 8, 8), device=dev),
                torch.zeros(8, device=dev))


@pytest.mark.parametrize("v,c", [(700, 3), (1000, 64), (333, 130)])
def test_stratified_knn_kernel(dev, v, c):
    x = _t(np.random.default_rng(v).standard_normal((v, c)).astype(
        np.float32), dev)
    n0 = stratified_knn.launches
    k = stratified_knn(x, 16)
    assert stratified_knn.launches == n0 + 1
    t = stratified_knn_torch(x, 16)
    torch.cuda.synchronize()
    assert torch.equal(k, t)   # random features: no exact score ties
