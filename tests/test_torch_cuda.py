"""The CUDA kernels of the port against their plain versions, on a GPU.

Marked `cuda`: every test skips (and counts as no pass) where
torch.cuda.is_available() is False, which is decided inside the fixture,
never at import.  On the GPU machine:  python -m pytest tests/test_torch_cuda.py -q
Small, odd shapes that the canonical frame does not reach (scalar
staging paths, ragged tiles, more than four texture levels); the slice
shapes are checked by chip_smoke.py.  The backward kernels K1b (SH fan),
K5b (SH of materialised rays) and K3b (conv weight gradient) must also be
bitwise deterministic, and the rasterizer K7 bitwise equal to its plain
version.
"""

import numpy as np
import pytest
import torch

from rnr_tpu_torch.models.rays import RaySampler, build_fan_channels
from rnr_tpu_torch.ops.conv_cuda import (conv3x3, conv3x3_dgrad,
                                         conv3x3_dgrad_torch, conv3x3_torch,
                                         conv3x3_wgrad, conv3x3_wgrad_torch)
from rnr_tpu_torch.ops.knn_cuda import stratified_knn, stratified_knn_torch
from rnr_tpu_torch.ops.rasterize_cuda import (bin_faces, rasterize_tiled,
                                              rasterize_tiles,
                                              rasterize_tiles_torch)
from rnr_tpu_torch.ops.sh_cuda import (sh_shade, sh_shade_bwd,
                                       sh_shade_bwd_torch, sh_shade_fan,
                                       sh_shade_fan_bwd,
                                       sh_shade_fan_bwd_torch,
                                       sh_shade_fan_torch, sh_shade_torch)
from rnr_tpu_torch.ops.texture_cuda import (mipmap_sample, mipmap_sample_torch,
                                            mipmap_scatter,
                                            mipmap_scatter_torch)
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


def _sh_args(dev, lmax, lt_dtype, seed):
    rng = np.random.default_rng(seed)
    b = build_batch(24, 64)
    spec, diff = RaySampler(2, 2, 5.0, "reflect"), RaySampler(2, 2, 10.0,
                                                              "diffuse")
    piv = np.concatenate([spec.pivots_dir.T, diff.pivots_dir.T]
                         ).astype(np.float32)                  # R = 5 + 5
    vdt = rng.standard_normal((1, 24, 24, 3)).astype(np.float32)
    vdt /= np.linalg.norm(vdt, axis=-1, keepdims=True)
    return (_t(b["TBN_map"], dev), _t(vdt, dev), _t(b["alpha_map"], dev),
            _t(rng.uniform(0, 2, (1, 24, 24, 10, 3)).astype(np.float32), dev,
               lt_dtype),
            _t((0.5 * rng.standard_normal(((lmax + 1) ** 2, 3))).astype(
                np.float32), dev), _t(piv, dev),
            _t(rng.standard_normal((1, 24, 24, 3)).astype(np.float32), dev),
            _t(rng.standard_normal((1, 24, 24, 3)).astype(np.float32), dev))


@pytest.mark.parametrize("lmax", [2, 10])
@pytest.mark.parametrize("lt_dtype", [torch.float32, torch.bfloat16])
def test_sh_shade_fan_kernel(dev, lmax, lt_dtype):
    args = (*_sh_args(dev, lmax, lt_dtype, lmax)[:6], lmax, 5)
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


@pytest.mark.parametrize("lmax", [2, 10])
@pytest.mark.parametrize("lt_dtype", [torch.float32, torch.bfloat16])
def test_sh_shade_fan_bwd_kernel(dev, lmax, lt_dtype):
    args = _sh_args(dev, lmax, lt_dtype, lmax + 1)
    n0 = sh_shade_fan_bwd.launches
    kl, kc = sh_shade_fan_bwd(*args, lmax, 5)
    kl2, kc2 = sh_shade_fan_bwd(*args, lmax, 5)
    assert sh_shade_fan_bwd.launches == n0 + 2
    tl, tc = sh_shade_fan_bwd_torch(*args, lmax, 5)
    torch.cuda.synchronize()
    assert kl.dtype == lt_dtype and kc.dtype == torch.float32
    # d coeff: f32 sums over 5760 pixel-rays in another order
    assert float((kc - tc).abs().max()) <= 1e-4 * float(tc.abs().max())
    # d rays_lt: f32 radiance (FMA contraction), then the lt dtype
    tol = 1e-5 if lt_dtype == torch.float32 else 2 ** -7
    assert float((kl.float() - tl.float()).abs().max()) <= (
        tol * float(tl.float().abs().max()))
    # per-block partials summed in a fixed order: bitwise reproducible
    assert torch.equal(kc, kc2) and torch.equal(kl, kl2)


def _shade_args(dev, lmax, dtype, seed):
    """K5's operands from _sh_args: the fan's rays_dir (zero directions
    at the masked pixels), rays_lt, alpha, coeff in the ray dtype, and
    two output gradients; 24^2 pixels, R = 5 + 5."""
    tb, vd, al, lt, cf, piv, gs, gd = _sh_args(dev, lmax, dtype, seed)
    rd = build_fan_channels(tb, vd, al, piv, 5)[1].to(dtype)
    return rd, lt, al, cf, gs, gd


@pytest.mark.parametrize("lmax", [2, 10])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sh_shade_kernel(dev, lmax, dtype):
    rd, lt, al, cf, _, _ = _shade_args(dev, lmax, dtype, lmax + 2)
    masked = al[..., 0] == 0
    assert bool(masked.any())
    n0 = sh_shade.launches
    ks, kd = sh_shade(rd, lt, al, cf, lmax, 5)
    assert sh_shade.launches == n0 + 1
    ts, td = sh_shade_torch(rd, lt, al, cf, lmax, 5)
    torch.cuda.synchronize()
    # f32 on both sides from the same stored rays; FMA and sum order differ
    for k, t in ((ks, ts), (kd, td)):
        tol = 1e-4 * float(t.abs().max()) + 1e-6
        assert float((k - t).abs().max()) <= tol
        assert bool((k[masked] == 0).all())    # finite ladder at (0, 0, 0)


@pytest.mark.parametrize("lmax", [2, 10])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sh_shade_bwd_kernel(dev, lmax, dtype):
    args = _shade_args(dev, lmax, dtype, lmax + 3)
    n0 = sh_shade_bwd.launches
    kl, kc = sh_shade_bwd(*args, lmax, 5)
    kl2, kc2 = sh_shade_bwd(*args, lmax, 5)
    assert sh_shade_bwd.launches == n0 + 2
    tl, tc = sh_shade_bwd_torch(*args, lmax, 5)
    torch.cuda.synchronize()
    assert kl.dtype == dtype and kc.dtype == torch.float32
    assert float((kc - tc).abs().max()) <= 1e-4 * float(tc.abs().max())
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    assert float((kl.float() - tl.float()).abs().max()) <= (
        tol * float(tl.float().abs().max()))
    assert torch.equal(kc, kc2) and torch.equal(kl, kl2)


def test_sh_shade_kernel_rejects_mixed_ray_dtypes(dev):
    rd, lt, al, cf, _, _ = _shade_args(dev, 2, torch.bfloat16, 0)
    with pytest.raises(TypeError, match="rays_dir"):
        sh_shade(rd.float(), lt, al, cf, 2, 5)


@pytest.mark.parametrize("ch,sizes", [(24, (64, 32, 16, 8)), (5, (16, 8)),
                                      (8, (32, 16, 8, 4, 2))])
@pytest.mark.parametrize("one_texel", [False, True])
def test_mipmap_scatter_kernel(dev, ch, sizes, one_texel):
    rng = np.random.default_rng(ch)
    uv = rng.uniform(-0.05, 1.05, (2, 16, 8, 2)).astype(np.float32)
    uv[0, 0, :4] = [[0, 0], [1, 1], [0, 1], [1, 0]]
    if one_texel:                  # every pixel on the uv = 0 corner texel
        uv[:] = 0.0
    uv = _t(uv, dev)
    g = _t(rng.standard_normal((2, 16, 8, ch)).astype(np.float32), dev)
    n0 = mipmap_scatter.launches
    k = mipmap_scatter(uv, g, sizes)
    assert mipmap_scatter.launches == n0 + -(-len(sizes) // 4)
    t = mipmap_scatter_torch(uv, g, sizes)
    torch.cuda.synchronize()
    for a, b in zip(k, t):
        # f32 atomics in another order
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()) + 1e-6


@pytest.mark.parametrize("c,o", [(5, 12), (64, 78), (108, 64), (24, 640)])
@pytest.mark.parametrize("pad_mode", ["same", "reflect"])
def test_conv3x3_dgrad_and_wgrad_kernels(dev, c, o, pad_mode):
    rng = np.random.default_rng(c * o)
    h, w_ = 7, 9                   # W = H + 2
    x = _t(rng.standard_normal((2, h, w_, c)).astype(np.float32), dev,
           torch.bfloat16)
    g = _t(rng.standard_normal((2, h, w_, o)).astype(np.float32), dev,
           torch.bfloat16)
    w = _t((rng.standard_normal((3, 3, c, o)) / np.sqrt(9 * c)).astype(
        np.float32), dev)
    n0, m0 = conv3x3.launches, conv3x3_wgrad.launches
    kd = conv3x3_dgrad(g, w, pad_mode)
    kw = conv3x3_wgrad(x, g, pad_mode)
    kw2 = conv3x3_wgrad(x, g, pad_mode)
    assert conv3x3.launches == n0 + 1 and conv3x3_wgrad.launches == m0 + 2
    td = conv3x3_dgrad_torch(g, w, pad_mode)
    tw = conv3x3_wgrad_torch(x, g, pad_mode)
    torch.cuda.synchronize()
    assert kd.dtype == torch.float32 and kw.dtype == torch.float32
    # bf16 operands multiply exactly; f32 sums in another order
    assert float((kd - td).abs().max()) <= 1e-4 * float(td.abs().max())
    assert float((kw - tw).abs().max()) <= 1e-4 * float(tw.abs().max())
    assert torch.equal(kw, kw2)    # split-K partials, fixed order


def test_conv3x3_wgrad_kernel_deep_split(dev):
    """A K deep enough for many split-K slices (64 x 64 at 128^2)."""
    rng = np.random.default_rng(5)
    x = _t(rng.standard_normal((1, 128, 128, 64)).astype(np.float32), dev,
           torch.bfloat16)
    g = _t(rng.standard_normal((1, 128, 128, 64)).astype(np.float32), dev,
           torch.bfloat16)
    k = conv3x3_wgrad(x, g, "reflect")
    t = conv3x3_wgrad_torch(x, g, "reflect")
    torch.cuda.synchronize()
    assert float((k - t).abs().max()) <= 1e-4 * float(t.abs().max())
    assert torch.equal(k, conv3x3_wgrad(x, g, "reflect"))


def test_autograd_functions_launch_the_backward_kernels(dev):
    """On CUDA tensors the three autograd.Functions return gradients (no
    silent drop) through the backward kernels."""
    rng = np.random.default_rng(9)
    x = _t(rng.standard_normal((1, 8, 8, 16)).astype(np.float32), dev,
           torch.bfloat16).requires_grad_()
    w = _t(rng.standard_normal((3, 3, 16, 8)).astype(np.float32), dev
           ).requires_grad_()
    b = torch.zeros(8, device=dev, requires_grad=True)
    n0, m0 = conv3x3.launches, conv3x3_wgrad.launches
    conv3x3(x, w, b, "reflect").float().sum().backward()
    assert conv3x3.launches == n0 + 2 and conv3x3_wgrad.launches == m0 + 1
    assert x.grad is not None and w.grad is not None and b.grad is not None

    tb, vd, al, lt, cf, piv, _, _ = _sh_args(dev, 2, torch.bfloat16, 1)
    lt.requires_grad_()
    cf.requires_grad_()
    n0 = sh_shade_fan_bwd.launches
    s, d = sh_shade_fan(tb, vd, al, lt, cf, piv, 2, 5)
    (s.sum() + d.sum()).backward()
    assert sh_shade_fan_bwd.launches == n0 + 1
    assert lt.grad.dtype == torch.bfloat16 and cf.grad is not None

    rd, lt, al, cf, _, _ = _shade_args(dev, 2, torch.bfloat16, 2)
    lt.requires_grad_()
    cf.requires_grad_()
    n0 = sh_shade_bwd.launches
    s, d = sh_shade(rd, lt, al, cf, 2, 5)
    (s.sum() + d.sum()).backward()
    assert sh_shade_bwd.launches == n0 + 1
    assert lt.grad.dtype == torch.bfloat16 and cf.grad is not None

    texs = [torch.ones((s_, s_, 4), device=dev, requires_grad=True)
            for s_ in (8, 4)]
    uv = torch.rand((1, 4, 4, 2), device=dev)
    n0 = mipmap_scatter.launches
    mipmap_sample(texs, uv).sum().backward()
    assert mipmap_scatter.launches == n0 + 1
    assert all(t.grad is not None and float(t.grad.sum()) > 0 for t in texs)


def _raster_faces(rng, n, f):
    """Faces partly off screen, both windings, and degenerate ones (two
    corners equal, or three in a line), z in [1, 3]."""
    faces = rng.uniform(-1.2, 1.2, (n, f, 3, 3)).astype(np.float32)
    faces[..., 2] = rng.uniform(1.0, 3.0, (n, f, 3))
    faces[:, ::7, 2, :2] = faces[:, ::7, 1, :2]
    faces[:, 3::11, 2, :2] = 2 * faces[:, 3::11, 1, :2] - faces[:, 3::11, 0, :2]
    # small faces too, so that tiles hold many candidates of several sizes
    c = rng.uniform(-1, 1, (n, f // 2, 1, 2))
    faces[:, ::2, :, :2] = c + 0.1 * (faces[:, ::2, :, :2] - c)
    return faces


@pytest.mark.parametrize("s,n,f", [(96, 3, 300), (24, 1, 60), (64, 2, 700),
                                   (128, 1, 2000)])
def test_rasterize_tiles_kernel(dev, s, n, f):
    """K7 against its plain version on the card, bitwise, at sides that
    are not multiples of 128 (tiles min(32, S) x min(128, S)), N up to 3;
    the card's binning equals the CPU's."""
    faces = _raster_faces(np.random.default_rng(s + n), n, f)
    th, tw = min(32, s), min(128, s)
    table, ids, counts, overflow = bin_faces(_t(faces, dev), s, th, tw, 2048)
    n0 = rasterize_tiles.launches
    kd, ki = rasterize_tiles(table, ids, counts, s, th, tw, 0.0, 100.0)
    assert rasterize_tiles.launches == n0 + 1
    td, ti = rasterize_tiles_torch(table, ids, counts, s, th, tw, 0.0, 100.0)
    torch.cuda.synchronize()
    assert bool((ki >= 0).any()) and bool((ki < 0).any())
    assert torch.equal(ki, ti) and torch.equal(kd, td)
    cpu = bin_faces(torch.from_numpy(faces), s, th, tw, 2048)
    for a, b in zip((table, ids, counts, overflow), cpu):
        assert torch.equal(a.cpu(), b)


def test_rasterize_tiled_kernel_overflow(dev):
    """8 faces over the whole 32^2 screen in one 32x32 tile, cap 4: the
    first 4 ids render, overflow 4, bitwise equal to the plain version."""
    rng = np.random.default_rng(0)
    faces = rng.uniform(1.0, 2.0, (1, 8, 3, 3)).astype(np.float32)
    faces[..., :2] = np.array([[-0.9, -0.9], [0.9, -0.9], [0.0, 0.9]])
    faces[..., 2] = np.linspace(1, 2, 8)[None, :, None]
    n0 = rasterize_tiles.launches
    k = rasterize_tiled(_t(faces, dev), 32, far=10.0, tile_h=32, tile_w=32,
                        max_faces_per_tile=4)
    assert rasterize_tiles.launches == n0 + 1
    p = rasterize_tiled(torch.from_numpy(faces), 32, far=10.0, tile_h=32,
                        tile_w=32, max_faces_per_tile=4)
    assert int(k.overflow[0]) == 4 == int(p.overflow[0])
    assert torch.equal(k.face_index_map.cpu(), p.face_index_map)
    assert torch.equal(k.depth_map.cpu(), p.depth_map)
    fim = k.face_index_map
    assert set(fim[fim >= 0].unique().tolist()) == {0}
