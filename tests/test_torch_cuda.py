"""The CUDA kernels of the port against their plain versions, on a GPU.

Marked `cuda`: every test skips (and counts as no pass) where
torch.cuda.is_available() is False, which is decided inside the fixture,
never at import.  On the GPU machine:  python -m pytest tests/test_torch_cuda.py -q
Small, odd shapes that the canonical frame does not reach (scalar
staging paths, ragged tiles, more than four texture levels; K2 also on
adversarial uv (the G-buffer's at batch 2, the corner texel, a seam,
uv outside [0, 1], exact edges and NaN, a frame no tile divides), twice
bit-equal, uv and levels at unaligned offsets, and K2, K2b, K2, K2b on one
stream; K2b also at batch 2, across a uv seam and past its per-warp
box); the slice shapes are checked by chip_smoke.py.  K4 runs at V 700, 1000, 333 and 7500 and C
3, 64, 130 and 512, held to its plain version within f32 rounding
(knn_cuda.compare_picks) and bitwise across two runs, with ties between
duplicated vertices or zero rows going to the lower index.  The 4x4 pair of K6 and K8 is run
at odd channel counts, odd sizes and widths past one tile, with both
output types (bf16, and f32 as each serves the other's data gradient).
K3 and K3b run at shapes that straddle their tiles (W around the
tile's 64 positions, odd H, batch 2, ragged and wide C and O, both pad
modes) and K3's forward and dgrad must be bitwise deterministic.  The
3x3 slab pair (K8a forward and f32 data gradient, K8b weight
gradient) runs at odd C, O, H and W under both pad modes, at 512 -> 512
on 32^2 and 64 -> 64 on 128^2, every output twice bitwise equal, and P1 (the
GEMM chain) at section A's kinds of shape, odd ones and one of each BN
with w streamed, twice bitwise equal, and with w resident bitwise equal to
w streamed.  K1 and K1b (SH
fan) run at batch 2 with a pixel count no block divides, at 64 rays, with
no diffuse ray and at lmax 1, 2 and 10; K5 (SH of materialised rays) at
lmax 2 and 10 in bf16 and f32, and K5, K5b, K5, K5b back to back on one
stream (their shared constant bank); K1 and K1b keep their pinned digests
(chip_smoke.py K1_DIGESTS).  K1, K5, the backward kernels K1b,
K5b, K3b and K8b (conv weight gradients) must
also be bitwise deterministic, and the rasterizer K7 bitwise equal to its
plain version, also on faces at the edge of its cull's exactness
(synthetic.degenerate_faces) at 128^2 and 512^2.
"""

import ctypes

import numpy as np
import pytest
import torch

from rnr_tpu_torch.models.rays import RaySampler, build_fan_channels
from rnr_tpu_torch.ops import _build
from rnr_tpu_torch.ops import conv4_cuda as c4
from rnr_tpu_torch.ops import conv_cuda as cc
from rnr_tpu_torch.ops.conv_cuda import (conv3x3, conv3x3_dgrad,
                                         conv3x3_dgrad_torch, conv3x3_torch,
                                         conv3x3_wgrad, conv3x3_wgrad_torch)
from rnr_tpu_torch.ops.gemm_chain_cuda import gemm_chain, gemm_chain_torch
from rnr_tpu_torch.ops.knn_cuda import (compare_picks, stratified_knn,
                                        stratified_knn_torch)
from rnr_tpu_torch.ops.rasterize_cuda import (bin_faces, rasterize_tiled,
                                              rasterize_tiles,
                                              rasterize_tiles_torch)
from rnr_tpu_torch.ops.sh_cuda import (fan_bwd_partials, sh_shade,
                                       sh_shade_bwd,
                                       sh_shade_bwd_torch, sh_shade_fan,
                                       sh_shade_fan_bwd,
                                       sh_shade_fan_bwd_torch,
                                       sh_shade_fan_torch, sh_shade_torch)
from rnr_tpu_torch.ops.texture_cuda import (mipmap_sample, mipmap_sample_torch,
                                            mipmap_scatter,
                                            mipmap_scatter_torch)
from rnr_tpu_torch.synthetic import (build_batch, degenerate_faces,
                                     random_faces)

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


# K1 / K1b shapes: (N, H, W, R, r_spec); 24^2 is 576 pixels and 2 x 13 x 11
# is 286, which neither the forward's 128-pixel nor the backward's
# 64-pixel blocks divide; R = 64 (MAX_RAYS) on random pivots; r_spec = R
# (no diffuse ray, the divisor max(R - r_spec, 1))
FAN_CASES = {"24sq": (1, 24, 24, 10, 5), "n2_ragged": (2, 13, 11, 10, 5),
             "r64": (1, 24, 24, 64, 32), "all_spec": (1, 24, 24, 10, 10)}


def _fan_args(dev, case, lmax, lt_dtype, seed):
    """tbn, vdt, alpha (0 on the G-buffer's background), rays_lt, coeff,
    pivots, gs, gd of one FAN_CASES shape."""
    n, h, w, r_total, r_spec = FAN_CASES[case]
    rng = np.random.default_rng(seed)
    b = build_batch(max(h, w), 64, n)
    if r_total == 10:
        spec, diff = RaySampler(2, 2, 5.0, "reflect"), RaySampler(
            2, 2, 10.0, "diffuse")
        piv = np.concatenate([spec.pivots_dir.T, diff.pivots_dir.T])
    else:
        piv = rng.standard_normal((r_total, 3))
        piv[:, 2] = np.abs(piv[:, 2])
        piv /= np.linalg.norm(piv, axis=-1, keepdims=True)
    vdt = rng.standard_normal((n, h, w, 3)).astype(np.float32)
    vdt /= np.linalg.norm(vdt, axis=-1, keepdims=True)
    alpha = b["alpha_map"][:, :h, :w]
    assert (alpha == 0).any() and (alpha == 1).any()
    args = (_t(b["TBN_map"][:, :h, :w], dev), _t(vdt, dev), _t(alpha, dev),
            _t(rng.uniform(0, 2, (n, h, w, r_total, 3)).astype(np.float32),
               dev, lt_dtype),
            _t((0.5 * rng.standard_normal(((lmax + 1) ** 2, 3))).astype(
                np.float32), dev), _t(piv.astype(np.float32), dev),
            _t(rng.standard_normal((n, h, w, 3)).astype(np.float32), dev),
            _t(rng.standard_normal((n, h, w, 3)).astype(np.float32), dev))
    return args, r_spec


@pytest.mark.parametrize("case", list(FAN_CASES))
@pytest.mark.parametrize("lmax", [1, 2, 10])
@pytest.mark.parametrize("lt_dtype", [torch.float32, torch.bfloat16])
def test_sh_shade_fan_kernel(dev, case, lmax, lt_dtype):
    fan, r_spec = _fan_args(dev, case, lmax, lt_dtype, lmax)
    args = (*fan[:6], lmax, r_spec)
    n0 = sh_shade_fan.launches
    ks, kd = sh_shade_fan(*args)
    ks2, kd2 = sh_shade_fan(*args)
    assert sh_shade_fan.launches == n0 + 2
    ts, td = sh_shade_fan_torch(*args)
    torch.cuda.synchronize()
    # f32 on both sides; FMA contraction and sum order differ
    for k, t in ((ks, ts), (kd, td)):
        tol = 1e-4 * float(t.abs().max()) + 1e-6
        assert float((k - t).abs().max()) <= tol
    # each pixel's sums in ray order, no atomics: bitwise reproducible
    assert torch.equal(ks, ks2) and torch.equal(kd, kd2)
    if r_spec == fan[3].shape[3]:
        assert not bool(kd.any())   # no diffuse ray: the diffuse mean is 0


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


def _k2_uv(case: str) -> np.ndarray:
    """K2's adversarial uv: the G-buffer's at 128^2 and 512^2 (batch 2),
    every pixel on the corner texel, a seam across the object, random uv
    in [-0.05, 1.05], exact 0 and 1 with NaN entries, and a frame that is
    no multiple of the warp tile (36 x 100)."""
    rng = np.random.default_rng(len(case))
    if case.startswith("gbuffer"):
        return build_batch(int(case[7:]), 16, 2)["uv_map"]
    if case == "corner":
        return np.zeros((1, 64, 64, 2), np.float32)
    if case == "seam":
        uv = build_batch(128, 16, 1)["uv_map"]
        xs = np.arange(128, dtype=np.float32)
        u = np.where(xs < 67, 0.02 + np.abs(xs - 67) / 1280,
                     0.98 - np.abs(xs - 67) / 1280).astype(np.float32)
        uv[..., 0] = np.where((uv != 0).any(-1), u, uv[..., 0])
        return uv
    if case == "random":
        return rng.uniform(-0.05, 1.05, (2, 32, 32, 2)).astype(np.float32)
    if case == "edges_nan":
        uv = rng.uniform(0, 1, (1, 24, 40, 2)).astype(np.float32)
        uv[0, 1:3] = np.where(rng.uniform(size=(2, 40, 2)) < 0.5, 0.0, 1.0)
        uv[0, 5, :4] = [[np.nan, 0.5], [0.5, np.nan], [np.nan, np.nan],
                        [1, np.nan]]
        return uv
    return rng.uniform(-0.05, 1.05, (1, 36, 100, 2)).astype(np.float32)


K2_CASES = ["gbuffer128", "gbuffer512", "corner", "seam", "random",
            "edges_nan", "ragged"]


def _k2_check(k, t):
    """K2 against its plain version: NaN where it is NaN, else within
    1e-5 x max + 1e-6 (f32 both sides; FMA contraction only)."""
    assert torch.equal(k.isnan(), t.isnan())
    k, t = torch.nan_to_num(k), torch.nan_to_num(t)
    assert float((k - t).abs().max()) <= 1e-5 * float(t.abs().max()) + 1e-6


@pytest.mark.parametrize("case", K2_CASES)
@pytest.mark.parametrize("ch,levels", [(24, 4), (5, 5)])
def test_mipmap_gather_kernel_adversarial(dev, case, ch, levels):
    """Four levels from 512 (the 512^2 G-buffer) or 128 down, or five from
    32 down to 2 (a second launch that adds into the first's output)."""
    uv = _t(_k2_uv(case), dev)
    top = 512 if case == "gbuffer512" else 128
    sizes = [top >> k for k in range(4)] if levels == 4 else [32, 16, 8, 4, 2]
    rng = np.random.default_rng(ch)
    texs = [_t((0.5 + 0.5 * rng.standard_normal((s, s, ch))).astype(
        np.float32), dev) for s in sizes]
    n0 = mipmap_sample.launches
    k = mipmap_sample(texs, uv)
    assert mipmap_sample.launches == n0 + -(-len(sizes) // 4)
    k2 = mipmap_sample(texs, uv)
    t = mipmap_sample_torch(texs, uv)
    torch.cuda.synchronize()
    _k2_check(k, t)
    assert torch.equal(torch.nan_to_num(k), torch.nan_to_num(k2))


@pytest.mark.parametrize("uv_off,tex_off", [(1, 0), (0, 1), (1, 1)])
def test_mipmap_gather_kernel_misaligned_inputs(dev, uv_off, tex_off):
    """uv a contiguous view at an odd float offset (the kernel reads uv as
    float2: the wrapper copies it) and levels one float off 16 bytes (the
    scalar path), each against its plain version."""
    rng = np.random.default_rng(uv_off + 2 * tex_off)
    uv_np = rng.uniform(-0.05, 1.05, (2, 16, 24, 2)).astype(np.float32)
    uv = torch.empty(uv_np.size + uv_off, device=dev)[uv_off:].view(
        uv_np.shape)
    uv.copy_(_t(uv_np, dev))
    assert uv.is_contiguous() and uv.data_ptr() % 8 == 4 * uv_off
    texs = []
    for s in (32, 16, 8, 4, 2):
        t = torch.empty(s * s * 24 + tex_off, device=dev)[tex_off:].view(
            s, s, 24)
        t.copy_(_t(rng.standard_normal((s, s, 24)).astype(np.float32), dev))
        texs.append(t)
    k = mipmap_sample(texs, uv)
    t = mipmap_sample_torch(texs, uv)
    torch.cuda.synchronize()
    _k2_check(k, t)


def test_mipmap_gather_entry_refuses_misaligned_uv(dev):
    """K2's C entry returns cudaErrorInvalidValue for a uv base that is not
    8-byte aligned, and launches nothing."""
    f = _build.fn("mipmap_gather", "rnr_mipmap_gather", 6, 10)
    tex = torch.ones((8, 8, 4), device=dev)
    uv = torch.zeros(2 * 4 * 4 * 2 + 1, device=dev)
    out = torch.full((2, 4, 4, 4), 7.0, device=dev)
    rc = f(tex.data_ptr(), 0, 0, 0, uv.data_ptr() + 4, out.data_ptr(), 8, 0,
           0, 0, 1, 2, 4, 4, 4, 0, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 1   # cudaErrorInvalidValue
    assert bool((out == 7.0).all())


def test_mipmap_gather_and_scatter_interleaved_on_one_stream(dev):
    """K2, K2b, K2, K2b back to back on one stream, each against its plain
    version, on the G-buffer's uv at 128^2, batch 2."""
    uv = _t(_k2_uv("gbuffer128"), dev)
    rng = np.random.default_rng(15)
    sizes = (128, 64, 32, 16)
    texs = [_t(rng.standard_normal((s, s, 24)).astype(np.float32), dev)
            for s in sizes]
    g = _t(rng.standard_normal((2, 128, 128, 24)).astype(np.float32), dev)
    outs = []
    for _ in range(2):
        outs.append(mipmap_sample(texs, uv))
        outs.append(mipmap_scatter(uv, g, sizes))
    t = mipmap_sample_torch(texs, uv)
    tg = mipmap_scatter_torch(uv, g, sizes)
    m = mipmap_scatter_torch(uv, g.abs(), sizes)
    torch.cuda.synchronize()
    for k in outs[0::2]:
        _k2_check(k, t)
    for kg in outs[1::2]:
        for a, b, mm in zip(kg, tg, m):
            assert bool(((a - b).abs() <= 1e-5 * mm + 1e-7).all())


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


@pytest.mark.parametrize("c", [3, 64, 130, 512])
@pytest.mark.parametrize("v", [700, 1000, 333, 7500])
def test_stratified_knn_kernel(dev, v, c):
    """V not a multiple of the 128-row or 256-column tiles (all but none),
    C ragged (3, 130) or up to the widest (512): the picks equal the plain
    version's except at near-ties, where the two picks' scores in double
    lie within the sum of their f32 rounding bounds (the kernel sums its
    products on the tensor cores, the plain version through cuBLAS, each
    in its own order), and two runs are bit-equal."""
    x = _t(np.random.default_rng(v + c).standard_normal((v, c)).astype(
        np.float32), dev)
    n0 = stratified_knn.launches
    k = stratified_knn(x, 16)
    k2 = stratified_knn(x, 16)
    assert stratified_knn.launches == n0 + 2
    t = stratified_knn_torch(x, 16)
    torch.cuda.synchronize()
    assert k.shape == t.shape and k.dtype == torch.int32
    r = compare_picks(x, k, t)
    assert r["violations"] == []
    assert r["differ"] <= 1e-4 * k.numel()   # near-ties are rare
    assert torch.equal(k, k2)


@pytest.mark.parametrize("v", [1000, 7500])
def test_stratified_knn_kernel_ties_go_to_the_lower_index(dev, v):
    """Duplicated vertices (rows 2m and 2m + 1 equal): their scores tie
    exactly, and every pick is the lower of its pair, bit for bit."""
    half = np.random.default_rng(v).standard_normal((v // 2, 64)).astype(
        np.float32)
    x = _t(np.repeat(half, 2, axis=0), dev)
    k = stratified_knn(x, 16)
    torch.cuda.synchronize()
    assert bool((k % 2 == 0).all())
    assert compare_picks(x, k, stratified_knn_torch(x, 16))["violations"] == []


@pytest.mark.parametrize("c,shift", [(3, 1.0), (64, 3.0)])
def test_stratified_knn_kernel_relu_collapsed_features(dev, c, shift):
    """Features that collapse to zero after a ReLU: many all-zero rows,
    whose scores against any query are exactly 0, so the first of them in
    a stratum must win where one of them is the pick."""
    x = np.maximum(np.random.default_rng(c).standard_normal((1000, c))
                   - shift, 0.0).astype(np.float32)
    assert (x == 0).all(1).sum() > 100
    x = _t(x, dev)
    k = stratified_knn(x, 16)
    t = stratified_knn_torch(x, 16)
    torch.cuda.synchronize()
    r = compare_picks(x, k, t)
    assert r["violations"] == [] and r["differ"] == r["exact_ties"] + r[
        "near_ties"]
    zero = (x == 0).all(1).cpu().numpy()
    kk = k.cpu().numpy()
    picked_zero = zero[kk]
    assert picked_zero.any()
    for i, s in zip(*np.nonzero(picked_zero)):   # score 0: the first zero row
        assert kk[i, s] == 16 * s + int(np.argmax(zero[16 * s:16 * s + 16]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_stratified_knn_kernel_input_dtypes(dev, dtype):
    """Other types go through f32 (exactly): the same picks as the f32
    input."""
    x = _t(np.random.default_rng(9).standard_normal((500, 64)).astype(
        np.float32), dev).to(dtype)
    k = stratified_knn(x, 16)
    torch.cuda.synchronize()
    assert torch.equal(k, stratified_knn(x.float(), 16))


def test_stratified_knn_kernel_rejects_wide_features(dev):
    with pytest.raises(ValueError, match="C=513"):
        stratified_knn(torch.zeros((64, 513), device=dev), 16)


@pytest.mark.parametrize("case", list(FAN_CASES))
@pytest.mark.parametrize("lmax", [1, 2, 10])
@pytest.mark.parametrize("lt_dtype", [torch.float32, torch.bfloat16])
def test_sh_shade_fan_bwd_kernel(dev, case, lmax, lt_dtype):
    args, r_spec = _fan_args(dev, case, lmax, lt_dtype, lmax + 1)
    n0 = sh_shade_fan_bwd.launches
    kl, kc = sh_shade_fan_bwd(*args, lmax, r_spec)
    kl2, kc2 = sh_shade_fan_bwd(*args, lmax, r_spec)
    assert sh_shade_fan_bwd.launches == n0 + 2
    tl, tc = sh_shade_fan_bwd_torch(*args, lmax, r_spec)
    torch.cuda.synchronize()
    assert kl.dtype == lt_dtype and kc.dtype == torch.float32
    # d coeff: f32 sums over the pixel-rays in another order
    assert float((kc - tc).abs().max()) <= 1e-4 * float(tc.abs().max())
    # d rays_lt: f32 radiance (FMA contraction), then the lt dtype
    tol = 1e-5 if lt_dtype == torch.float32 else 2 ** -7
    assert float((kl.float() - tl.float()).abs().max()) <= (
        tol * float(tl.float().abs().max()))
    # per-block partials summed in a fixed order: bitwise reproducible
    assert torch.equal(kc, kc2) and torch.equal(kl, kl2)


@pytest.mark.parametrize("n_pix,lmax", [(576, 2), (286, 1), (262144, 10),
                                        (524288, 10), (1, 10)])
def test_fan_bwd_partials_matches_kernel(dev, n_pix, lmax):
    """The wrapper's partials size (fan_bwd_partials) is the one the
    kernel's C side computes from its block size, so the wrapper never
    hands K1b a buffer it refuses."""
    f = _build.load("sh_fan").rnr_sh_shade_fan_bwd_partials
    f.argtypes, f.restype = [ctypes.c_int] * 2, ctypes.c_int
    assert fan_bwd_partials(n_pix, lmax) == f(n_pix, lmax)


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
    ks2, kd2 = sh_shade(rd, lt, al, cf, lmax, 5)
    assert sh_shade.launches == n0 + 2
    ts, td = sh_shade_torch(rd, lt, al, cf, lmax, 5)
    torch.cuda.synchronize()
    # f32 on both sides from the same stored rays; FMA and sum order differ
    for k, t in ((ks, ts), (kd, td)):
        tol = 1e-4 * float(t.abs().max()) + 1e-6
        assert float((k - t).abs().max()) <= tol
        assert bool((k[masked] == 0).all())    # finite ladder at (0, 0, 0)
    assert torch.equal(ks, ks2) and torch.equal(kd, kd2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sh_shade_k5_k5b_interleaved_on_one_stream(dev, dtype):
    """K5 and K5b share one constant bank, each copying its coefficients
    on the stream before its launch: K5, K5b, K5, K5b queued back to back
    on one stream each equal their plain versions, and the two runs of
    each are bit-equal."""
    rd, lt, al, cf, gs, gd = _shade_args(dev, 10, dtype, 31)
    ks, kd = sh_shade(rd, lt, al, cf, 10, 5)
    kl, kc = sh_shade_bwd(rd, lt, al, cf, gs, gd, 10, 5)
    ks2, kd2 = sh_shade(rd, lt, al, cf, 10, 5)
    kl2, kc2 = sh_shade_bwd(rd, lt, al, cf, gs, gd, 10, 5)
    torch.cuda.synchronize()
    ts, td = sh_shade_torch(rd, lt, al, cf, 10, 5)
    tl, tc = sh_shade_bwd_torch(rd, lt, al, cf, gs, gd, 10, 5)
    for k, t in ((ks, ts), (kd, td), (ks2, ts), (kd2, td)):
        assert float((k - t).abs().max()) <= 1e-4 * float(t.abs().max()) + 1e-6
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    for l_, c_ in ((kl, kc), (kl2, kc2)):
        assert float((c_ - tc).abs().max()) <= 1e-4 * float(tc.abs().max())
        assert float((l_.float() - tl.float()).abs().max()) <= (
            tol * float(tl.float().abs().max()))
    assert torch.equal(ks, ks2) and torch.equal(kd, kd2)
    assert torch.equal(kl, kl2) and torch.equal(kc, kc2)


def test_sh_shade_fan_bwd_kernel_keeps_its_digest(dev):
    """K1b at chip_smoke.py's kernels-phase case (512^2, lmax 10, 13 + 13
    rays, bf16) gives, bit for bit, the output pinned in its K1_DIGESTS:
    sharing its backward with K5b kept K1b's arithmetic."""
    import chip_smoke as cs
    args, bargs = cs.k1_inputs(cs._gbuffer(cs.IMG),
                               np.random.default_rng(0))
    kl, kc = sh_shade_fan_bwd(*bargs)
    torch.cuda.synchronize()
    assert cs.digest(kl, kc) == cs.K1_DIGESTS["sh_shade_fan_bwd"]
    ks, kd = sh_shade_fan(*args)
    torch.cuda.synchronize()
    assert cs.digest(ks, kd) == cs.K1_DIGESTS["sh_shade_fan"]


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


def _scatter_check(uv, g, sizes):
    """K2b against its plain version, every texel within 1e-5 x the sum of
    its terms' magnitudes (f32 sums in another order)."""
    n0 = mipmap_scatter.launches
    k = mipmap_scatter(uv, g, sizes)
    assert mipmap_scatter.launches == n0 + -(-len(sizes) // 4)
    t = mipmap_scatter_torch(uv, g, sizes)
    m = mipmap_scatter_torch(uv, g.abs(), sizes)
    torch.cuda.synchronize()
    for a, b, mm in zip(k, t, m):
        assert bool(((a - b).abs() <= 1e-5 * mm + 1e-7).all())


@pytest.mark.parametrize("ch", [24, 5])
def test_mipmap_scatter_kernel_gbuffer_batch2(dev, ch):
    """The synthetic G-buffer's uv at batch 2 (half of each frame on the
    corner texel), 96^2: the pixel tiles of both images."""
    uv = _t(build_batch(96, 16, 2)["uv_map"], dev)
    g = _t(np.random.default_rng(ch).standard_normal((2, 96, 96, ch)).astype(
        np.float32), dev)
    _scatter_check(uv, g, (128, 64, 32, 16))


@pytest.mark.parametrize("col", [3, 8, 13])
def test_mipmap_scatter_kernel_seam_across_a_pixel_tile(dev, col):
    """u jumps from about 0.02 to 0.98 at column `col` (inside an 8-pixel
    tile at 3 and 13, on its edge at 8): a tile across it sees texels at
    both ends of every level."""
    rng = np.random.default_rng(col)
    h, w = 12, 24
    xs = np.arange(w, dtype=np.float32)
    u = np.where(xs < col, 0.02 + 0.001 * xs, 0.98 - 0.001 * xs)
    uv = np.stack([np.broadcast_to(u, (h, w)),
                   np.broadcast_to(np.linspace(0.1, 0.9, h)[:, None],
                                   (h, w))], -1)[None].astype(np.float32)
    g = rng.standard_normal((1, h, w, 24)).astype(np.float32)
    _scatter_check(_t(uv, dev), _t(g, dev), (256, 64, 16, 4))


def test_mipmap_scatter_kernel_window_overflow(dev):
    """Pixel tiles whose taps spread over more texels than a warp's box
    holds (u sweeping the whole texture across 8 pixels at 512^2), beside
    tiles that fit: both routes of the kernel in one launch."""
    h, w = 8, 32
    xs = np.arange(w, dtype=np.float32)
    u = np.where(xs < 16, (xs % 8) / 7.0, 0.5 + 0.002 * xs)
    uv = np.stack([np.broadcast_to(u, (h, w)),
                   np.broadcast_to(np.linspace(0.3, 0.31, h)[:, None],
                                   (h, w))], -1)[None].astype(np.float32)
    g = np.random.default_rng(0).standard_normal((1, h, w, 24)).astype(
        np.float32)
    _scatter_check(_t(uv, dev), _t(g, dev), (512, 256, 128, 64))


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


# (N, H, W, C, O) across K3's and K3b's tiles: 64 or 128 positions of the
# grid of pitch W + 2 (W + 2 below, at and just above 64), an odd H, batch
# 2 (tiles never straddle images), ragged and wide C and O (5, 45 / 77,
# 108 / 78, 640: zero-padded channels, BN 64, 80 and 128, several O tiles)
K3_TILE_SHAPES = [(2, 7, 9, 5, 77), (1, 63, 62, 45, 78), (2, 5, 63, 108, 45),
                  (1, 6, 64, 77, 640), (2, 4, 65, 640, 5),
                  (1, 63, 130, 64, 64), (2, 9, 30, 78, 108)]


@pytest.mark.parametrize("n,h,wd,c,o", K3_TILE_SHAPES)
@pytest.mark.parametrize("pad_mode", ["same", "reflect"])
def test_conv3x3_kernels_across_tiles(dev, n, h, wd, c, o, pad_mode):
    rng = np.random.default_rng(n * h * wd + c * o)
    x = _t(rng.standard_normal((n, h, wd, c)).astype(np.float32), dev,
           torch.bfloat16)
    g = _t(rng.standard_normal((n, h, wd, o)).astype(np.float32), dev,
           torch.bfloat16)
    w = _t((rng.standard_normal((3, 3, c, o)) / np.sqrt(9 * c)).astype(
        np.float32), dev)
    b = _t(rng.standard_normal(o).astype(np.float32), dev)
    n0, m0 = conv3x3.launches, conv3x3_wgrad.launches
    k = conv3x3(x, w, b, pad_mode)
    kd = conv3x3_dgrad(g, w, pad_mode)
    kw = conv3x3_wgrad(x, g, pad_mode)
    assert conv3x3.launches == n0 + 2 and conv3x3_wgrad.launches == m0 + 1
    t = conv3x3_torch(x, w, b, pad_mode)
    td = conv3x3_dgrad_torch(g, w, pad_mode)
    tw = conv3x3_wgrad_torch(x, g, pad_mode)
    torch.cuda.synchronize()
    assert k.shape == t.shape and kd.shape == td.shape and kw.shape == tw.shape
    # bf16 output: a rounding step of the largest values; dgrad, wgrad:
    # bf16 operands multiply exactly, f32 sums in another order
    assert float((k.float() - t.float()).abs().max()) <= (
        2 ** -7 * float(t.float().abs().max()))
    assert float((kd - td).abs().max()) <= 1e-4 * float(td.abs().max())
    assert float((kw - tw).abs().max()) <= 1e-4 * float(tw.abs().max())


@pytest.mark.parametrize("pad_mode", ["same", "reflect"])
def test_conv3x3_forward_and_dgrad_deterministic(dev, pad_mode):
    """K3's sums run in a fixed order: two runs are bit-equal (the
    forward, and the dgrad with its reflect ring fold)."""
    rng = np.random.default_rng(17)
    x = _t(rng.standard_normal((2, 96, 96, 64)).astype(np.float32), dev,
           torch.bfloat16)
    w = _t((rng.standard_normal((3, 3, 64, 128)) / 24).astype(np.float32),
           dev)
    b = _t(rng.standard_normal(128).astype(np.float32), dev)
    g = _t(rng.standard_normal((2, 96, 96, 128)).astype(np.float32), dev,
           torch.bfloat16)
    assert torch.equal(conv3x3(x, w, b, pad_mode), conv3x3(x, w, b, pad_mode))
    assert torch.equal(conv3x3_dgrad(g, w, pad_mode),
                       conv3x3_dgrad(g, w, pad_mode))


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


@pytest.mark.parametrize("s,n,f", [(96, 3, 300), (24, 1, 60), (64, 2, 700),
                                   (128, 1, 2000)])
def test_rasterize_tiles_kernel(dev, s, n, f):
    """K7 against its plain version on the card, bitwise, at sides that
    are not multiples of 128 (tiles min(32, S) x min(128, S)), N up to 3;
    the card's binning equals the CPU's."""
    faces = random_faces(np.random.default_rng(s + n), n, f)
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


@pytest.mark.parametrize("s", [128, 512])
def test_rasterize_tiles_kernel_degenerate_faces(dev, s):
    """K7 with its cull bitwise equal to its plain
    version on faces at the edge of exactness (synthetic.degenerate_faces:
    segments on pixel columns and rows, points, slivers, vertices at pixel
    centres and block boundaries, at +-1e12, +-inf and NaN, depth ties)
    among random ones."""
    rng = np.random.default_rng(s)
    faces = np.concatenate([degenerate_faces(rng, s),
                            random_faces(rng, 1, 600)], 1)
    th, tw = min(32, s), min(128, s)
    table, ids, counts, _ = bin_faces(_t(faces, dev), s, th, tw, 2048)
    n0 = rasterize_tiles.launches
    kd, ki = rasterize_tiles(table, ids, counts, s, th, tw, 0.0, 100.0)
    kd2, ki2 = rasterize_tiles(table, ids, counts, s, th, tw, 0.0, 100.0)
    assert rasterize_tiles.launches == n0 + 2
    td, ti = rasterize_tiles_torch(table, ids, counts, s, th, tw, 0.0, 100.0)
    torch.cuda.synchronize()
    assert bool((ki >= 0).any())
    assert torch.equal(ki, ti) and torch.equal(kd, td)
    assert torch.equal(ki, ki2) and torch.equal(kd, kd2)


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


# (kernel's wrapper, its counter, plain version, down conv?)
CONV4 = {"down4": (c4.down4_fwd, c4.down4, c4.down4_torch, True),
         "down4s": (c4.down4s_fwd, c4.down4s, c4.down4_torch, True),
         "convt4": (c4.convt4_fwd, c4.convt4, c4.convt4_torch, False),
         "convt4s": (c4.convt4s_fwd, c4.convt4s, c4.convt4_torch, False)}


@pytest.mark.parametrize("c,o,h,w", [(5, 7, 10, 12), (8, 16, 16, 16),
                                     (64, 72, 18, 34), (16, 24, 7, 150),
                                     (40, 130, 5, 9), (512, 512, 16, 16),
                                     (64, 64, 9, 63), (8, 16, 14, 14),
                                     (256, 64, 32, 32), (64, 128, 256, 128)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pad_mode", ["same", "reflect"])
@pytest.mark.parametrize("name", sorted(CONV4))
def test_conv4_kernels(dev, name, pad_mode, out_dtype, c, o, h, w):
    """Each 4x4 kernel against its plain version: bf16 output within one
    rounding step of the largest values (2^-7 of max), f32 output within
    1e-4 of max (bf16 products are exact, f32 sums in another order).
    The transpose convs have no padding mode.  512 -> 512 @16 and 256 ->
    64 @32 split K in every kernel; 64 -> 128 at 256 x 128 takes two
    consumer warpgroups."""
    fwd, counter, plain, down = CONV4[name]
    rng = np.random.default_rng(c + o + h + w)
    x = _t(rng.standard_normal((2, h, w, c)).astype(np.float32), dev,
           torch.bfloat16)
    wt = _t((rng.standard_normal((4, 4, c, o)) / np.sqrt(16 * c)).astype(
        np.float32), dev)
    args = (pad_mode,) if down else ()
    n0 = counter.launches
    k = fwd(x, wt, *args, out_dtype)
    assert counter.launches == n0 + 1 and k.dtype == out_dtype
    t = plain(x, wt, *args, out_dtype)
    torch.cuda.synchronize()
    assert k.shape == t.shape == ((2, h // 2, w // 2, o) if down
                                  else (2, 2 * h, 2 * w, o))
    rel = 2 ** -7 if out_dtype == torch.bfloat16 else 1e-4
    err = float((k.float() - t.float()).abs().max())
    assert err <= rel * float(t.float().abs().max()), err


@pytest.mark.parametrize("name", ["down4s", "convt4s", "down4", "convt4"])
@pytest.mark.parametrize("c,o,h", [(256, 512, 128), (512, 512, 32)])
def test_conv4s_kernels_are_bitwise_reproducible(dev, name, c, o, h):
    """K8's pair and K6 twice on the same inputs, bf16 and f32 out:
    bitwise equal (a fixed order of sums, split K's partials added in
    split order at 16^2 and 32^2), and within the plain version's
    tolerance."""
    fwd, counter, plain, down = CONV4[name]
    rng = np.random.default_rng(c + h)
    x = _t(rng.standard_normal((1, h, h, c)).astype(np.float32), dev,
           torch.bfloat16)
    wt = _t((rng.standard_normal((4, 4, c, o)) / np.sqrt(16 * c)).astype(
        np.float32), dev)
    args = ("reflect",) if down else ()
    for out_dtype in (torch.bfloat16, torch.float32):
        k1 = fwd(x, wt, *args, out_dtype)
        k2 = fwd(x, wt, *args, out_dtype)
        t = plain(x, wt, *args, out_dtype)
        torch.cuda.synchronize()
        assert torch.equal(k1, k2)
        rel = 2 ** -7 if out_dtype == torch.bfloat16 else 1e-4
        err = float((k1.float() - t.float()).abs().max())
        assert err <= rel * float(t.float().abs().max()), err


def test_conv4_kernels_reject_f32_activations(dev):
    x = torch.zeros((1, 8, 8, 8), device=dev)
    for fwd, *_ in CONV4.values():
        with pytest.raises(TypeError):
            fwd(x, torch.zeros((4, 4, 8, 8), device=dev))


@pytest.mark.parametrize("pad_mode", ["same", "reflect"])
def test_conv4_autograd_launches_their_dgrad_kernels(dev, pad_mode):
    """down4 / down4s: dx by K6's convt4 under "same", by the plain conv
    under reflect; convt4: dx by down4; convt4s: dx by down4s.  Gradients
    against the plain versions' autograd on the card: dx within one bf16
    step of its max, dw (the bf16 conv's, rounded to bf16) likewise."""
    rng = np.random.default_rng(21)
    xs = _t(rng.standard_normal((1, 16, 16, 24)).astype(np.float32), dev,
            torch.bfloat16)
    ws = _t((rng.standard_normal((4, 4, 24, 40)) / 8).astype(np.float32),
            dev)
    for name, (fwd, counter, plain, down) in CONV4.items():
        fn = getattr(c4, name)
        args = (pad_mode,) if down else ()
        x = xs.clone().requires_grad_()
        w = ws.clone().requires_grad_()
        before = {k: v[1].launches for k, v in CONV4.items()}
        y = fn(x, w, *args)
        g = torch.ones_like(y)
        y.backward(g)
        got = {k: v[1].launches - before[k] for k, v in CONV4.items()}
        dgrad = {"down4": "convt4" if pad_mode == "same" else None,
                 "down4s": "convt4" if pad_mode == "same" else None,
                 "convt4": "down4", "convt4s": "down4s"}[name]
        want = {k: int(k == name) + int(k == dgrad) for k in CONV4}
        assert got == want, (name, got)
        xr = xs.float().requires_grad_()
        wr = ws.to(torch.bfloat16).float().requires_grad_()
        plain(xr, wr, *args, torch.float32).backward(g.float())
        for a, r in ((x.grad, xr.grad), (w.grad, wr.grad)):
            err = float((a.float() - r).abs().max())
            assert err <= 2 ** -7 * float(r.abs().max()), (name, err)


# ------------------------------------------------ K8a / K8b: the 3x3 slab


@pytest.mark.parametrize("c,o,h,w", [(5, 12, 7, 9), (64, 78, 9, 70),
                                     (108, 64, 2, 33), (24, 640, 6, 16),
                                     (45, 77, 5, 130), (512, 512, 32, 32),
                                     (64, 64, 128, 128)])
@pytest.mark.parametrize("pad_mode", ["same", "reflect"])
def test_conv3x3s_kernels(dev, c, o, h, w, pad_mode):
    """K8a (bf16 output within one rounding step of max; f32 output and the
    f32 data gradient within 1e-4 of max: bf16 products are exact, f32
    sums in another order) and K8b (within 1e-4 of max) against their
    plain versions, each twice bitwise equal; K8a's forward within one
    rounding step of K3's.  512 -> 512 at 32^2 takes K8a's short-row plan
    (one warpgroup), 64 -> 64 at 128^2 K8b's deep split."""
    rng = np.random.default_rng(c + o + h + w)
    x = _t(rng.standard_normal((2, h, w, c)).astype(np.float32), dev,
           torch.bfloat16)
    g = _t(rng.standard_normal((2, h, w, o)).astype(np.float32), dev,
           torch.bfloat16)
    wt = _t((rng.standard_normal((3, 3, c, o)) / np.sqrt(9 * c)).astype(
        np.float32), dev)
    b = _t(rng.standard_normal(o).astype(np.float32), dev)
    n0, m0 = cc.conv3x3s.launches, cc.conv3x3s_wgrad.launches
    ky = cc.conv3x3s_fwd(x, wt, b, pad_mode)
    k32 = cc.conv3x3s_fwd(x, wt, b, pad_mode, torch.float32)
    kd = cc.conv3x3s_dgrad(g, wt, pad_mode)
    kw = cc.conv3x3s_wgrad(x, g, pad_mode)
    kw2 = cc.conv3x3s_wgrad(x, g, pad_mode)
    assert cc.conv3x3s.launches == n0 + 3
    assert cc.conv3x3s_wgrad.launches == m0 + 2
    # fixed orders of sums: a second run is bit-equal
    assert torch.equal(ky, cc.conv3x3s_fwd(x, wt, b, pad_mode))
    assert torch.equal(k32, cc.conv3x3s_fwd(x, wt, b, pad_mode,
                                            torch.float32))
    assert torch.equal(kd, cc.conv3x3s_dgrad(g, wt, pad_mode))
    k3 = conv3x3(x, wt, b, pad_mode)
    ty = cc.conv3x3s_torch(x, wt, b, pad_mode)
    t32 = cc.conv3x3s_torch(x, wt, b, pad_mode, torch.float32)
    td = cc.conv3x3s_dgrad_torch(g, wt, pad_mode)
    tw = cc.conv3x3s_wgrad_torch(x, g, pad_mode)
    torch.cuda.synchronize()
    assert ky.dtype == torch.bfloat16 and k32.dtype == kd.dtype == torch.float32
    for k, t, rel in ((ky.float(), ty.float(), 2 ** -7),
                      (ky.float(), k3.float(), 2 ** -7),
                      (k32, t32, 1e-4), (kd, td, 1e-4), (kw, tw, 1e-4)):
        assert k.shape == t.shape
        err = float((k - t).abs().max())
        assert err <= rel * float(t.abs().max()), err
    assert torch.equal(kw, kw2)    # split-K partials, fixed order


def test_conv3x3s_wgrad_kernel_deep_split(dev):
    """A K deep enough for many split-K slices (64 x 64 at 128^2)."""
    rng = np.random.default_rng(6)
    x = _t(rng.standard_normal((1, 128, 128, 64)).astype(np.float32), dev,
           torch.bfloat16)
    g = _t(rng.standard_normal((1, 128, 128, 64)).astype(np.float32), dev,
           torch.bfloat16)
    k = cc.conv3x3s_wgrad(x, g, "reflect")
    t = cc.conv3x3s_wgrad_torch(x, g, "reflect")
    torch.cuda.synchronize()
    assert float((k - t).abs().max()) <= 1e-4 * float(t.abs().max())
    assert torch.equal(k, cc.conv3x3s_wgrad(x, g, "reflect"))


def test_conv3x3s_autograd_launches_its_kernels(dev):
    """On CUDA tensors conv3x3s's backward returns every gradient through
    K8a (f32 out) and K8b, and launches neither K3 nor K3b; the gradients
    against the plain versions' autograd within one bf16 step of max."""
    rng = np.random.default_rng(10)
    xs = _t(rng.standard_normal((1, 12, 20, 16)).astype(np.float32), dev,
            torch.bfloat16)
    ws = _t((rng.standard_normal((3, 3, 16, 24)) / 12).astype(np.float32),
            dev)
    x, w = xs.clone().requires_grad_(), ws.clone().requires_grad_()
    b = torch.zeros(24, device=dev, requires_grad=True)
    before = (cc.conv3x3s.launches, cc.conv3x3s_wgrad.launches,
              conv3x3.launches, conv3x3_wgrad.launches)
    y = cc.conv3x3s(x, w, b, "reflect")
    gy = _t(rng.standard_normal(tuple(y.shape)).astype(np.float32), dev,
            torch.bfloat16)
    y.backward(gy)
    after = (cc.conv3x3s.launches, cc.conv3x3s_wgrad.launches,
             conv3x3.launches, conv3x3_wgrad.launches)
    assert tuple(a - c for a, c in zip(after, before)) == (2, 1, 0, 0)
    xr = xs.float().requires_grad_()
    wr = ws.to(torch.bfloat16).float().requires_grad_()
    br = torch.zeros(24, device=dev, requires_grad=True)
    cc.conv3x3s_torch(xr, wr, br, "reflect").backward(gy.float())
    for a, r in ((x.grad, xr.grad), (w.grad, wr.grad), (b.grad, br.grad)):
        err = float((a.float() - r).abs().max())
        assert err <= 2 ** -7 * float(r.abs().max()), err


def test_conv3x3s_kernels_reject_f32_activations(dev):
    x = torch.zeros((1, 4, 4, 8), device=dev)
    w, b = torch.zeros((3, 3, 8, 8), device=dev), torch.zeros(8, device=dev)
    with pytest.raises(TypeError):
        cc.conv3x3s_fwd(x, w, b)
    with pytest.raises(TypeError):
        cc.conv3x3s_wgrad(x, x)


# ------------------------------------------------------ P1: the GEMM chain


# (M, K, N, T): section A's kinds of shape at a small M (BN 64 with w
# resident, BN 128, BN 256 in two n tiles), odd sizes, and one of each BN
# with w streamed (BN 64 at K 128, BN 128 at N 72, BN 256 at N 256)
GEMM_CASES = [(1000, 64, 64, 9), (512, 192, 128, 9), (300, 512, 512, 4),
              (77, 13, 11, 2), (129, 40, 70, 3), (700, 128, 64, 9),
              (333, 72, 256, 9)]


def _gemm_inputs(dev, m, k, n, t):
    rng = np.random.default_rng(m + k + n + t)
    x = _t(rng.standard_normal((m, k)).astype(np.float32), dev,
           torch.bfloat16)
    w = _t((rng.standard_normal((t, k, n)) / np.sqrt(k * t)).astype(
        np.float32), dev, torch.bfloat16)
    return x, w


@pytest.mark.parametrize("m,k,n,t", GEMM_CASES)
def test_gemm_chain_kernel(dev, m, k, n, t):
    """P1 against its plain version: bf16 output within one rounding step
    of max (bf16 products exact, f32 sums in another order); two runs
    bitwise equal (no split K)."""
    x, w = _gemm_inputs(dev, m, k, n, t)
    n0 = gemm_chain.launches
    y = gemm_chain(x, w)
    y2 = gemm_chain(x, w)
    assert gemm_chain.launches == n0 + 2 and y.dtype == torch.bfloat16
    r = gemm_chain_torch(x, w)
    torch.cuda.synchronize()
    assert y.shape == r.shape == (m, n)
    err = float((y.float() - r.float()).abs().max())
    assert err <= 2 ** -7 * float(r.float().abs().max()), err
    assert torch.equal(y, y2)


@pytest.mark.parametrize("m,k,n,t", [(1000, 64, 64, 9), (77, 13, 11, 2)])
def test_gemm_chain_resident_w_is_bitwise_streamed_w(dev, m, k, n, t):
    """w resident in shared memory or streamed through its ring: the same
    products in the same order, so the same bits (the C entry called with
    gemm_chain_plan's plan and with residency forced off)."""
    from rnr_tpu_torch.ops.gemm_chain_cuda import gemm_chain_plan
    x, w = _gemm_inputs(dev, m, k, n, t)
    k8, n8 = cc.round8(k), cc.round8(n)
    xb = cc.pad_channels(x, k8)
    wb = torch.zeros((t, k8, n8), dtype=torch.bfloat16, device=dev)
    wb[:, :k, :n] = w
    on, off = gemm_chain_plan(m, k, n, t), gemm_chain_plan(m, k, n, t, False)
    assert on[2] == 1 and off[2] == 0
    f = _build.fn("gemm_chain", "rnr_gemm_chain", 3, 10)
    stream = torch.cuda.current_stream().cuda_stream
    ys = []
    for plan in (on, off):
        y = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
        assert f(xb.data_ptr(), wb.data_ptr(), y.data_ptr(), m, k8, n, t,
                 *plan, stream) == 0
        ys.append(y)
    torch.cuda.synchronize()
    assert torch.equal(ys[0], ys[1])
    assert torch.equal(ys[0], gemm_chain(x, w))
