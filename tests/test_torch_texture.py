"""Port parity: bilinear gather, the K2 twin (mipmap gather) and the
TextureMapper module vs rnr_tpu; a torch emulation of K2's thread order
(csrc/mipmap_gather.cu: warp tiles, taps handed from the pixel's lane,
channel windows, edge tiles, the second launch) against the plain
version, bit for bit, and the counts of what the taps touch
(chip_variants.gather_counts)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_variants import gather_counts, warp_tiles
from rnr_tpu.models.texture import TextureMapper as JaxTextureMapper
from rnr_tpu.ops.interpolate import interpolate_bilinear as jax_interp
from rnr_tpu.ops.texture_pallas import _xla_gather_taps
from rnr_tpu.ops.texture_pallas import mipmap_sample as jax_mipmap_sample
from rnr_tpu_torch.convert import load_jax_variables
from rnr_tpu_torch.models.texture import TextureMapper
from rnr_tpu_torch.ops import _build
from rnr_tpu_torch.ops.interpolate import bilinear_taps, interpolate_bilinear
from rnr_tpu_torch.ops.texture_cuda import (LEVELS_PER_LAUNCH, level_coords,
                                            mipmap_sample,
                                            mipmap_sample_torch,
                                            touched_texels)
from rnr_tpu_torch.synthetic import build_batch

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


# ---------------------------------------------------------------- K2's plan

def _seam(uv: np.ndarray, col: int) -> np.ndarray:
    """uv with a seam over the object: u from 0.02 rising left of `col`
    and from 0.98 falling right of it (chip_smoke.seam_uv's)."""
    w = uv.shape[2]
    xs = np.arange(w, dtype=np.float32)
    ramp = np.abs(xs - col) / w * 0.1
    u = np.where(xs < col, 0.02 + ramp, 0.98 - ramp).astype(np.float32)
    out = uv.copy()
    covered = (uv != 0).any(-1)
    out[..., 0] = np.where(covered, u, uv[..., 0])
    return out


def _edges_nan(rng) -> np.ndarray:
    """Random uv with exact 0 and 1 corners and edges, and NaN entries."""
    uv = rng.uniform(0, 1, (1, 24, 40, 2)).astype(np.float32)
    uv[0, 0, :8] = [[0, 0], [1, 1], [0, 1], [1, 0], [1, 0.5], [0.5, 1],
                    [0.25, 0], [0, 0.75]]
    uv[0, 1:3] = np.where(rng.uniform(size=(2, 40, 2)) < 0.5, 0.0, 1.0)
    uv[0, 5, :6] = [[np.nan, 0.5], [0.5, np.nan], [np.nan, np.nan],
                    [0, np.nan], [np.nan, 1], [1, np.nan]]
    return uv


# uv cases of K2's emulation: name -> (uv [N, H, W, 2] from a numpy
# generator, the side of the largest level)
UV_CASES = {
    "gbuffer64_b1": (lambda rng: build_batch(64, 16, 1)["uv_map"], 64),
    "gbuffer64_b2": (lambda rng: build_batch(64, 16, 2)["uv_map"], 64),
    "gbuffer128_b1": (lambda rng: build_batch(128, 16, 1)["uv_map"], 128),
    "gbuffer128_b2": (lambda rng: build_batch(128, 16, 2)["uv_map"], 128),
    "gbuffer512_b1": (lambda rng: build_batch(512, 16, 1)["uv_map"], 512),
    "gbuffer512_b2": (lambda rng: build_batch(512, 16, 2)["uv_map"], 512),
    "corner": (lambda rng: np.zeros((1, 64, 64, 2), np.float32), 64),
    "seam": (lambda rng: _seam(build_batch(128, 16, 1)["uv_map"], 67), 128),
    "random": (lambda rng: rng.uniform(-0.05, 1.05, (2, 32, 32, 2)).astype(
        np.float32), 64),
    "edges_nan": (_edges_nan, 32),
    "ragged_36x100": (lambda rng: rng.uniform(-0.05, 1.05, (1, 36, 100, 2))
                      .astype(np.float32), 64),
}


def _uv_case(name: str):
    make, side = UV_CASES[name]
    return torch.from_numpy(make(np.random.default_rng(len(name)))), side


def _texture_levels(rng, sizes, ch):
    return [torch.from_numpy((0.5 + 0.5 * rng.standard_normal((s, s, ch)))
                             .astype(np.float32)) for s in sizes]


def _kernel_constants() -> dict:
    """K2's thread-order constants as csrc/mipmap_gather.cu builds them."""
    src = (_build.CSRC / "mipmap_gather.cu").read_text()
    tile = re.search(r"constexpr int TW = (\d+), TH = (\d+);", src)
    warps = re.search(r"constexpr int WX = (\d+), WY = (\d+);", src)
    window = re.search(r"constexpr int WINDOW = (\d+);", src)
    return dict(tw=int(tile[1]), th=int(tile[2]), wx=int(warps[1]),
                wy=int(warps[2]), window=int(window[1]))


K2 = _kernel_constants()


def k2_emulate(textures, uv_map: torch.Tensor, vec: int):
    """K2's thread order in torch, one launch per LEVELS_PER_LAUNCH levels.
    Each warp's TW x TH tile (chip_variants.warp_tiles; a block's warps
    only group the tiles, so the tile order is the kernel's up to which
    block runs it); lane = row * TW + column works out its pixel's taps,
    with uv 0 and weight 0 past the frame's edge, and packs each level's
    00 texel and its clamped steps into a key; per window of VEC * WINDOW
    channels, item j * 32 + lane is group g of pixel p, stepped as the
    kernel steps them; each item takes its pixel's key and weights from
    lane p (the shuffles), decodes the four texels, sums each level's
    taps in the order 00, 10, 01, 11 and the levels in order, starting
    from the output where the launch accumulates, and stores only where
    its pixel lies in the frame.  The taps' coordinates and weights are
    bilinear_taps' (the plain version's), and the sums round each product
    on its own, so this checks the order, the indexing and the coverage,
    not the card's FMA roundings.  Returns the output and how many times
    each of its elements was stored."""
    tw, th = K2["tw"], K2["th"]
    n, h, w, _ = uv_map.shape
    ch = textures[0].shape[-1]
    live = warp_tiles(torch.ones((n, h, w), dtype=torch.bool), (tw, th))
    uvt = torch.where(live[..., None], warp_tiles(uv_map, (tw, th)), 0.0)
    n_tiles = live.shape[0]
    out = torch.full((n_tiles, 32, ch), float("nan"))
    stores = torch.zeros((n_tiles, 32, ch), dtype=torch.int64)
    lanes = torch.arange(32)
    for first in range(0, len(textures), LEVELS_PER_LAUNCH):
        grp = textures[first:first + LEVELS_PER_LAUNCH]
        keys, weights = [], []
        for tex in grp:
            s = tex.shape[0]
            x, y = level_coords(uvt, s)
            taps = bilinear_taps(x, y, s, s)
            t00, t10, t01 = (taps[k][0] for k in range(3))
            keys.append(t00 << 2 | (t01 - t00) << 1 | (t10 - t00) // s)
            weights.append(torch.stack(
                [wt * live.to(wt.dtype) for _, wt in taps], -1))
        for c0 in range(0, ch, vec * K2["window"]):
            groups = min(vec * K2["window"], ch - c0) // vec
            dp, dg = 32 // groups, 32 % groups
            p, g = lanes // groups, lanes % groups
            for _ in range(groups):
                assert bool((p < 32).all())
                ok = live[:, p]                                 # [T, 32]
                cols = c0 + g[:, None] * vec + torch.arange(vec)  # [32, VEC]
                at = (torch.arange(n_tiles)[:, None, None], p[None, :, None],
                      cols[None])                          # [T, 32, VEC]
                total = (torch.where(ok[..., None], out[at], 0.0) if first
                         else torch.zeros((n_tiles, 32, vec)))
                for tex, key, wk in zip(grp, keys, weights):
                    s = tex.shape[0]
                    flat = tex.reshape(s * s, ch)
                    kk, wt = key[:, p], wk[:, p]                # shuffles
                    t00, dx, dy = kk >> 2, kk >> 1 & 1, (kk & 1) * s
                    acc = torch.zeros((n_tiles, 32, vec))
                    for k, texel in enumerate(
                            (t00, t00 + dy, t00 + dx, t00 + dx + dy)):
                        acc = acc + flat[texel[..., None], cols] * wt[
                            ..., k, None]
                    total = total + acc
                out[at] = torch.where(ok[..., None], total, out[at])
                stores[at] += ok[..., None].long()
                p, g = p + dp, g + dg
                p, g = p + (g >= groups).long(), torch.where(
                    g >= groups, g - groups, g)
    hp, wp = -(-h // th) * th, -(-w // tw) * tw

    def untile(a):
        return (a.reshape(n, hp // th, wp // tw, th, tw, ch).transpose(2, 3)
                .reshape(n, hp, wp, ch)[:, :h, :w])
    return untile(out), untile(stores)


def test_k2_constants_are_the_kernels():
    """The emulation's tile is a warp's 32 pixels, the block's warps and
    channel window are the kernel's, and LEVELS_PER_LAUNCH is MAX_LEVELS
    of csrc/mipmap_common.cuh, whose tap arithmetic both texture kernels
    include (K2b's pixel tile is K2's)."""
    assert K2["tw"] * K2["th"] == 32 and (K2["tw"], K2["th"]) == (8, 4)
    assert K2["wx"] * K2["wy"] == 8 and K2["window"] == 8
    common = (_build.CSRC / "mipmap_common.cuh").read_text()
    levels = re.search(r"constexpr int MAX_LEVELS = (\d+);", common)
    assert int(levels[1]) == LEVELS_PER_LAUNCH
    for name in ("mipmap_gather.cu", "mipmap_scatter.cu"):
        text = (_build.CSRC / name).read_text()
        assert '#include "mipmap_common.cuh"' in text
        assert "level_taps(" in text and "__fmul_rn(" not in text


@pytest.mark.parametrize("case", list(UV_CASES))
@pytest.mark.parametrize("ch,levels,vec", [(24, 4, 4), (5, 5, 1),
                                           (40, 4, 4)])
def test_k2_emulation_is_bitwise_the_plain_version(case, ch, levels, vec):
    """K2's thread order (k2_emulate) gives mipmap_sample_torch bit for bit
    and stores every output element exactly once: four levels from the
    case's side down, or five from 32 down to 2 (the second launch adding
    into the first's output); 24 channels as float4 groups in one window,
    5 as single channels, 40 in two windows of 32 and 8."""
    uv, side = _uv_case(case)
    sizes = ([side >> k for k in range(4)] if levels == 4
             else [32, 16, 8, 4, 2])
    texs = _texture_levels(np.random.default_rng(ch), sizes, ch)
    want = mipmap_sample_torch(texs, uv)
    got, stores = k2_emulate(texs, uv, vec)
    assert got.shape == want.shape == (*uv.shape[:3], ch)
    assert bool((stores == -(-levels // LEVELS_PER_LAUNCH)).all())
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


@pytest.mark.parametrize("ch", [1, 3, 4, 8, 12, 20, 28, 32, 36, 60])
def test_k2_items_cover_each_pixel_and_group_once(ch):
    """Over channel counts that give 1 to 8 groups a window, one or more
    windows, both vector widths: each lane's items, stepped as the kernel
    steps them, visit every (pixel, channel) of a 36 x 100 frame exactly
    once per launch, also on the edge tiles."""
    rng = np.random.default_rng(ch)
    uv = torch.from_numpy(rng.uniform(0, 1, (1, 36, 100, 2)).astype(
        np.float32))
    texs = _texture_levels(rng, [8, 4], ch)
    got, stores = k2_emulate(texs, uv, 4 if ch % 4 == 0 else 1)
    assert bool((stores == 1).all())
    assert torch.equal(got, mipmap_sample_torch(texs, uv))


def test_touched_texels_counts_unique_taps():
    rng = np.random.default_rng(7)
    uv = rng.uniform(-0.1, 1.1, (2, 9, 13, 2)).astype(np.float32)
    uv[0, 0, 0] = [np.nan, 0.3]
    sizes = [16, 8, 4, 2, 1]
    got = touched_texels(torch.from_numpy(uv), sizes)
    for s, n in zip(sizes, got):
        x = np.float32(s - 1) * uv[..., 0]
        y = np.float32(s - 1) - uv[..., 1] * np.float32(s - 1)
        x0 = np.clip(np.floor(np.clip(np.nan_to_num(x, nan=-1), -1, s)),
                     0, s - 1).astype(int)
        y0 = np.clip(np.floor(np.clip(np.nan_to_num(y, nan=-1), -1, s)),
                     0, s - 1).astype(int)
        x1, y1 = np.minimum(x0 + 1, s - 1), np.minimum(y0 + 1, s - 1)
        want = {(a, b) for ys, xs in ((y0, x0), (y1, x0), (y0, x1), (y1, x1))
                for a, b in zip(ys.ravel(), xs.ravel())}
        assert n == len(want)


def test_gather_counts_of_the_canonical_frame():
    """The counts that K2's bound and PERF.md take, on the synthetic
    512^2 G-buffer over 4 levels 512..64 x 24 channels: the touched texels
    per level, the floor's bytes (uv, those texels, the output), the
    every-texel figure beside it, the bytes the taps ask of L1 and the
    covered pixels' boxes on 8 x 4 tiles."""
    uv = torch.from_numpy(build_batch(512, 16, 1)["uv_map"])
    r = gather_counts(uv, (512, 256, 128, 64), 24, tiles=((8, 4),))
    assert r["touched"] == [102380, 29060, 7750, 2014]
    assert r["floor_bytes"] == 512 * 512 * 26 * 4 + 141204 * 96
    assert r["all_texels_bytes"] == 512 * 512 * 26 * 4 + 348160 * 96
    assert r["l1_bytes"] == 512 * 512 * 16 * 96
    b = r["boxes"][((8, 4), 512)]
    assert b["p99"] == 297 and b["largest"] == 1343
    assert 0.03 < r["corner_share"][(8, 4)] < 0.035


@pytest.mark.parametrize("case", ["seam", "corner"])
def test_mipmap_twin_matches_xla_gather_taps(case):
    """The plain version against rnr_tpu's f32 XLA gather
    (`_xla_gather_taps`, the path off the TPU), summed over the levels, on
    the seam and every pixel on the corner texel."""
    uv, side = _uv_case(case)
    sizes = [side >> k for k in range(4)]
    texs = _texture_levels(np.random.default_rng(3), sizes, 24)
    n, h, w, _ = uv.shape
    want = None
    for t in texs:
        x, y = level_coords(uv, t.shape[0])
        v = np.asarray(_xla_gather_taps(
            jnp.asarray(x.reshape(n * h, w).numpy()),
            jnp.asarray(y.reshape(n * h, w).numpy()),
            jnp.asarray(t.numpy())))                    # [n*h, C, w]
        v = v.transpose(0, 2, 1).reshape(n, h, w, -1)
        want = v if want is None else want + v
    got = mipmap_sample_torch(texs, uv).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
