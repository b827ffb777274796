"""Port parity of projection and rasterization (K7's path) vs rnr_tpu.

The same seeded NumPy inputs go through rnr_tpu (JAX on the CPU, its
Pallas rasterizer in interpret mode, as tests/test_rasterize_pallas.py
runs it) and the port (CPU tensors: K7's plain version).  XLA on the CPU
contracts a*b + c into an FMA and the port does not, so continuous
outputs agree to a few ulps; the winners agree exactly on these inputs,
which hold no depth tie closer than that.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rnr_tpu.ops.rasterize as jr
from rnr_tpu.ops.projection import interp_vertex_attr as j_interp
from rnr_tpu.ops.projection import projection as j_projection
from rnr_tpu.ops.projection import vertices_to_faces as j_vertices_to_faces
from rnr_tpu.ops.rasterize_pallas import _bin_faces, rasterize_pallas
from rnr_tpu_torch.ops import _build
from rnr_tpu_torch.ops import projection as tproj
from rnr_tpu_torch.ops import rasterize as tr
from rnr_tpu_torch.ops.rasterize_cuda import (BLOCK, WARP_W, _untile,
                                              bin_faces, cull_keep,
                                              rasterize_tiled,
                                              rasterize_tiles_torch,
                                              tile_in_frame, tile_pixels)
from rnr_tpu_torch.synthetic import degenerate_faces, random_faces
from chip_variants import K7_SHAPES

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _random_faces(rng, num_faces):
    """Front-facing triangles inside the NDC box, z in [1, 3]."""
    faces = []
    while len(faces) < num_faces:
        tri = rng.uniform(-0.9, 0.9, (3, 2))
        area2 = ((tri[1, 0] - tri[0, 0]) * (tri[2, 1] - tri[0, 1])
                 - (tri[2, 0] - tri[0, 0]) * (tri[1, 1] - tri[0, 1]))
        if abs(area2) < 0.05:
            continue
        if area2 < 0:
            tri = tri[[0, 2, 1]]
        faces.append(np.concatenate([tri, rng.uniform(1.0, 3.0, (3, 1))], 1))
    return np.asarray(faces, np.float32)


def _camera(rng, n):
    ang = rng.uniform(-0.3, 0.3, (n, 3))
    rs = []
    for a in ang:
        cx, sx, cy, sy = np.cos(a[0]), np.sin(a[0]), np.cos(a[1]), np.sin(a[1])
        rs.append(np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
                  @ np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]]))
    k = np.tile(np.array([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]]), (n, 1, 1))
    k[:, 0, 0] += rng.uniform(-5, 5, n)
    t = np.concatenate([rng.uniform(-0.1, 0.1, (n, 2)),
                        rng.uniform(2.5, 3.0, (n, 1))], -1).reshape(n, 1, 3)
    return (k.astype(np.float32), np.stack(rs).astype(np.float32),
            t.astype(np.float32))


@pytest.mark.parametrize("crop", [False, True])
def test_projection_and_vertices_to_faces_match_jax(crop):
    rng = np.random.default_rng(1 + crop)
    n, v = 2, 50
    verts = rng.uniform(-0.5, 0.5, (n, v, 3)).astype(np.float32)
    k, r, t = _camera(rng, n)
    dist = (0.05 * rng.standard_normal((n, 5))).astype(np.float32)
    off = rng.uniform(-3, 3, (n, 2)).astype(np.float32) if crop else None
    sc = rng.uniform(0.8, 1.2, (n, 2)).astype(np.float32) if crop else None
    want = np.asarray(j_projection(
        *map(jnp.asarray, (verts, k, r, t, dist)), 64,
        None if off is None else jnp.asarray(off),
        None if sc is None else jnp.asarray(sc)))
    got = tproj.projection(*map(_t, (verts, k, r, t, dist)), 64,
                           None if off is None else _t(off),
                           None if sc is None else _t(sc)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    faces = rng.integers(0, v, (1, 30, 3)).astype(np.int32)
    want_f = np.asarray(j_vertices_to_faces(jnp.asarray(want),
                                                jnp.asarray(faces)))
    got_f = tproj.vertices_to_faces(_t(want), _t(faces)).numpy()
    np.testing.assert_array_equal(got_f, want_f)
    attrs = rng.standard_normal((n, v, 4)).astype(np.float32)
    fim = rng.integers(-1, 30, (n, 5, 6)).astype(np.int32)
    wm = rng.uniform(0, 1, (n, 5, 6, 3, 1)).astype(np.float32)
    fv = np.broadcast_to(faces, (n, 30, 3)).copy()
    np.testing.assert_allclose(
        tproj.interp_vertex_attr(_t(attrs), _t(fv), _t(fim), _t(wm)).numpy(),
        np.asarray(j_interp(*map(jnp.asarray,
                                                 (attrs, fv, fim, wm)))),
        rtol=0, atol=1e-6)


def test_face_inv_matrix_and_pixel_attrs_match_jax():
    rng = np.random.default_rng(3)
    faces = _random_faces(rng, 9)[None]
    faces[0, 8, 2, :2] = faces[0, 8, 1, :2]     # degenerate: den == 0
    p = 0.5 * (faces[..., :2] * 32 + 31)
    want = np.asarray(jr.face_inv_matrix(jnp.asarray(p)))
    got = tr.face_inv_matrix(_t(p)).numpy()
    np.testing.assert_allclose(got[0, :8], want[0, :8], rtol=1e-5, atol=1e-7)
    assert np.isfinite(got[0, 8]).all() == np.isfinite(want[0, 8]).all()
    np.testing.assert_allclose(got[0, 8], want[0, 8], rtol=1e-5)

    fim = np.asarray(jr.rasterize_face_index(jnp.asarray(faces[:, :8]), 32,
                                             far=100.0).face_index_map)
    jw, jz, jc = jr.pixel_attrs(jnp.asarray(faces[:, :8]), jnp.asarray(fim), 32)
    tw, tz, tc = tr.pixel_attrs(_t(faces[:, :8]), _t(fim), 32)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-5)


def test_oracle_matches_jax():
    rng = np.random.default_rng(4)
    faces = np.stack([_random_faces(rng, 11), _random_faces(rng, 11)])
    want = jr.rasterize_face_index(jnp.asarray(faces), 32, far=100.0,
                                   face_chunk=4)
    got = tr.rasterize_face_index(_t(faces), 32, far=100.0, face_chunk=4)
    np.testing.assert_array_equal(got.face_index_map.numpy(),
                                  np.asarray(want.face_index_map))
    np.testing.assert_array_equal(got.alpha_map.numpy(),
                                  np.asarray(want.alpha_map))
    np.testing.assert_allclose(got.depth_map.numpy(),
                               np.asarray(want.depth_map), rtol=1e-5)
    np.testing.assert_allclose(got.weight_map.numpy(),
                               np.asarray(want.weight_map), atol=1e-5)
    assert got.overflow is None


def _bin_both(faces, s, th, tw, cap):
    """The port's bin_faces against rnr_tpu's _bin_faces, per batch
    element: ids, counts and overflow equal, the table's rows equal to the
    binned face data up to the FMA rounding of face_inv."""
    table, ids, counts, overflow = bin_faces(_t(faces), s, th, tw, cap)
    for b in range(faces.shape[0]):
        data, jids, jcounts, jover = _bin_faces(jnp.asarray(faces[b]), s, th,
                                                tw, cap)
        np.testing.assert_array_equal(ids[b].numpy(), np.asarray(jids))
        np.testing.assert_array_equal(counts[b].numpy(), np.asarray(jcounts))
        assert int(overflow[b]) == int(jover)
        jids = np.asarray(jids)
        got = table[b].numpy()[np.maximum(jids, 0)]
        np.testing.assert_allclose(got[jids >= 0], np.asarray(data)[jids >= 0],
                                   rtol=1e-5, atol=1e-6)
    return table, ids, counts, overflow


@pytest.mark.parametrize("s,th,tw,n", [(64, 32, 32, 2), (64, 32, 64, 1),
                                       (96, 32, 96, 1)])
def test_tiled_matches_pallas_interpret(s, th, tw, n):
    rng = np.random.default_rng(s + th + n)
    faces = np.stack([_random_faces(rng, 14) for _ in range(n)])
    table, ids, counts, _ = _bin_both(faces, s, th, tw, 16)
    want = rasterize_pallas(jnp.asarray(faces), s, far=100.0, tile_h=th,
                            tile_w=tw, max_faces_per_tile=16, interpret=True)
    got = rasterize_tiled(_t(faces), s, far=100.0, tile_h=th, tile_w=tw,
                          max_faces_per_tile=16)
    np.testing.assert_array_equal(got.face_index_map.numpy(),
                                  np.asarray(want.face_index_map))
    np.testing.assert_array_equal(got.alpha_map.numpy(),
                                  np.asarray(want.alpha_map))
    np.testing.assert_allclose(got.depth_map.numpy(),
                               np.asarray(want.depth_map), rtol=1e-5)
    np.testing.assert_allclose(got.weight_map.numpy(),
                               np.asarray(want.weight_map), atol=1e-5)
    np.testing.assert_array_equal(got.overflow.numpy(),
                                  np.asarray(want.overflow))
    # the plain version's chunks are the kernel's candidate-by-candidate
    # walk: any chunk size gives the same bits
    one = rasterize_tiles_torch(table, ids, counts, s, th, tw, far=100.0,
                                chunk=1)
    many = rasterize_tiles_torch(table, ids, counts, s, th, tw, far=100.0,
                                 chunk=5)
    assert all(torch.equal(a, b) for a, b in zip(one, many))
    # and the tiled path renders what the oracle renders
    oracle = tr.rasterize_face_index(_t(faces), s, far=100.0, face_chunk=4)
    np.testing.assert_array_equal(got.face_index_map.numpy(),
                                  oracle.face_index_map.numpy())


def test_tile_overflow_drops_the_highest_ids_and_reports_them():
    """rnr_tpu's overflow case: 8 faces over the whole 32^2 screen, one
    32x32 tile, cap 4: faces 0..3 render, the nearest of them wins, and 4
    dropped candidates are reported."""
    rng = np.random.default_rng(0)
    faces = np.stack([_random_faces(rng, 1)[0] for _ in range(8)])
    faces[:, :, :2] = np.array([[-0.9, -0.9], [0.9, -0.9], [0.0, 0.9]])
    faces[:, :, 2] = np.linspace(1, 2, 8)[:, None]
    want = rasterize_pallas(jnp.asarray(faces[None]), 32, far=10.0,
                            tile_h=32, tile_w=32, max_faces_per_tile=4,
                            interpret=True)
    got = rasterize_tiled(_t(faces[None]), 32, far=10.0, tile_h=32,
                          tile_w=32, max_faces_per_tile=4)
    fim = got.face_index_map.numpy()
    assert int(got.overflow[0]) == 4 == int(np.asarray(want.overflow)[0])
    assert set(fim[fim >= 0].tolist()) == {0}
    assert (got.depth_map.numpy()[fim >= 0] == 1.0).all()
    np.testing.assert_array_equal(fim, np.asarray(want.face_index_map))
    np.testing.assert_array_equal(got.depth_map.numpy(),
                                  np.asarray(want.depth_map))
    big = rasterize_tiled(_t(faces[None]), 32, far=10.0, tile_h=32,
                          tile_w=32, max_faces_per_tile=8)
    assert int(big.overflow[0]) == 0


def test_offscreen_and_out_of_int32_faces_bin_as_in_jax():
    """Pixel coordinates beyond the int32 range (a vertex at 1e12 NDC,
    one at -inf, one NaN, as a face crossing the camera plane gives) and
    faces wholly off screen: bin_faces casts like XLA's saturating
    conversion, so every tile list, count and overflow equals rnr_tpu's,
    and the render agrees with the oracle's."""
    rng = np.random.default_rng(7)
    faces = _random_faces(rng, 10)
    # front facing, x of vertex 1 beyond int32: must reach the last tile
    # column (a wrapping cast would stop it at the first)
    faces[1] = [[-0.5, -0.5, 2.0], [1e12, -0.5, 2.0], [-0.5, 0.5, 2.0]]
    faces[2, 0, 0] = -1e12                # the first tile
    faces[3, 2, 1] = 1e12
    faces[4, 1, 0] = np.inf
    faces[5, 0, 1] = np.nan
    faces[6, :, 0] += 5.0                 # wholly off screen, right
    faces[7, :, 1] -= 5.0                 # wholly off screen, below
    faces = faces[None]
    _bin_both(faces, 64, 32, 32, 16)
    want = rasterize_pallas(jnp.asarray(faces), 64, far=100.0, tile_h=32,
                            tile_w=32, max_faces_per_tile=16, interpret=True)
    got = rasterize_tiled(_t(faces), 64, far=100.0, tile_h=32, tile_w=32,
                          max_faces_per_tile=16)
    np.testing.assert_array_equal(got.face_index_map.numpy(),
                                  np.asarray(want.face_index_map))
    ids = bin_faces(_t(faces), 64, 32, 32, 16)[1][0].numpy()
    assert 1 in ids[1] and 1 in ids[3]    # reaches the right column
    assert 6 not in ids and 7 not in ids


@pytest.mark.parametrize("s", [37, 131, 200])
def test_tiled_at_any_size_matches_the_oracle(s):
    """K7's plain version at frame sizes that 32 x 128 does not divide,
    on tiles cut by the frame's edge, against rnr_tpu's
    rasterize_face_index: face index and alpha equal, weights within
    1e-5 (test_oracle_matches_jax's)."""
    rng = np.random.default_rng(s)
    faces = np.stack([_random_faces(rng, 40), _random_faces(rng, 40)])
    want = jr.rasterize_face_index(jnp.asarray(faces), s, far=100.0)
    got = rasterize_tiled(_t(faces), s, far=100.0)
    assert int(got.overflow.sum()) == 0
    np.testing.assert_array_equal(got.face_index_map.numpy(),
                                  np.asarray(want.face_index_map))
    np.testing.assert_array_equal(got.alpha_map.numpy(),
                                  np.asarray(want.alpha_map))
    np.testing.assert_allclose(got.weight_map.numpy(),
                               np.asarray(want.weight_map), atol=1e-5)
    assert bool((got.face_index_map >= 0).any())


# ------------------------------------------------ K7's exact cull, emulated
#
# csrc/rasterize_tiles.cu drops a candidate for a block (and then for a
# warp) when one of its edges fails at both end rows against both end
# columns of the rectangle.  cull_keep computes that test in torch's f32
# elementwise operations, which round as the card does under -fmad=false.
# The walk below takes, per pixel, only the candidates its block and its
# warp keep, in list order; it must give the plain version's bits, and no
# dropped candidate may pass the inside test at any pixel of its
# rectangle, checked pixel by pixel with the plain expressions.


def _regions(th, tw, rh, rw):
    """The rectangle (rh x rw, row-major, clipped) of each pixel of a
    th x tw tile, pixels row-major."""
    r = torch.arange(th)[:, None] // rh
    c = torch.arange(tw)[None, :] // rw
    return (r * -(-tw // rw) + c).reshape(-1)


def _k7_emulate(table, ids, counts, s, th, tw, far, block):
    """K7 with its cull in blocks of `block` (rows, columns, rows a warp):
    (depth, idx) as rasterize_tiles_torch gives them, and the block and
    warp keep masks of cull_keep."""
    bh, bw, wh = block
    kb = cull_keep(table, ids, counts, s, th, tw, bh, bw)
    kw = cull_keep(table, ids, counts, s, th, tw, wh, WARP_W)
    # [N, T, K, P]: the candidate survives the pixel's block and warp
    keep = (kb[:, :, _regions(th, tw, bh, bw)]
            & kw[:, :, _regions(th, tw, wh, WARP_W)]).transpose(2, 3)
    n, n_t, _ = ids.shape
    xi, yi, xp, yp = (a[None, :, None, :]
                      for a in tile_pixels(s, th, tw, table.dtype, "cpu"))
    rows = torch.arange(n).reshape(n, 1, 1)
    depth = torch.full((n, n_t, th * tw), far)
    idx = torch.full((n, n_t, th * tw), -1, dtype=torch.int32)
    k_run = keep.shape[2]
    for k0 in range(0, k_run, 16):
        cid = ids[:, :, k0:min(k0 + 16, k_run)]
        d = table[rows, torch.clamp(cid, min=0).long()][..., None, :]
        x0, y0, z0 = d[..., 0], d[..., 1], d[..., 2]
        x1, y1, z1 = d[..., 3], d[..., 4], d[..., 5]
        x2, y2, z2 = d[..., 6], d[..., 7], d[..., 8]
        inside = (((yp - y0) * (x1 - x0) >= (xp - x0) * (y1 - y0))
                  & ((yp - y1) * (x2 - x1) >= (xp - x1) * (y2 - y1))
                  & ((yp - y2) * (x0 - x2) >= (xp - x2) * (y0 - y2)))
        w0 = torch.clamp(d[..., 9] * xi + d[..., 10] * yi + d[..., 11], 0, 1)
        w1 = torch.clamp(d[..., 12] * xi + d[..., 13] * yi + d[..., 14], 0, 1)
        w2 = torch.clamp(d[..., 15] * xi + d[..., 16] * yi + d[..., 17], 0, 1)
        wsum = w0 + w1 + w2
        wsum = torch.where(wsum == 0.0, 1e-30, wsum)
        inv_zp = (w0 / z0 + w1 / z1 + w2 / z2) / wsum
        zp = 1.0 / torch.where(inv_zp == 0.0, 1e-30, inv_zp)
        ok = (inside & keep[:, :, k0:k0 + 16] & (zp > 0.0) & (zp < far))
        # candidate by candidate, strict: the first of equal depths wins
        for c in range(cid.shape[2]):
            take = ok[:, :, c] & (zp[:, :, c] < depth)
            depth = torch.where(take, zp[:, :, c], depth)
            idx = torch.where(take, cid[:, :, c:c + 1], idx)
    return (_untile(depth, s, th, tw), _untile(idx, s, th, tw)), kb, kw


def _inside_any(table, ids, counts, s, th, tw, rh, rw):
    """[N, T, R, K]: the candidate passes the plain inside test at some
    pixel of rectangle R (rh x rw) of its tile."""
    n, n_t, _ = ids.shape
    k_run = int(counts.max())
    _, _, xp, yp = (a[None, :, None, :]
                    for a in tile_pixels(s, th, tw, table.dtype, "cpu"))
    rows = torch.arange(n).reshape(n, 1, 1)
    ny, nx = -(-th // rh), -(-tw // rw)
    frame = tile_in_frame(s, th, tw, "cpu")[None, :, None, :]
    out = []
    for k0 in range(0, k_run, 64):
        cid = ids[:, :, k0:min(k0 + 64, k_run)]
        d = table[rows, torch.clamp(cid, min=0).long()][..., None, :]
        x0, y0, x1, y1, x2, y2 = (d[..., i] for i in (0, 1, 3, 4, 6, 7))
        ins = (((yp - y0) * (x1 - x0) >= (xp - x0) * (y1 - y0))
               & ((yp - y1) * (x2 - x1) >= (xp - x1) * (y2 - y1))
               & ((yp - y2) * (x0 - x2) >= (xp - x2) * (y0 - y2))
               & frame)
        c = ins.shape[2]
        grid = torch.zeros((n, n_t, c, ny * rh, nx * rw), dtype=torch.bool)
        grid[..., :th, :tw] = ins.reshape(n, n_t, c, th, tw)
        grid = grid.reshape(n, n_t, c, ny, rh, nx, rw).any(6).any(4)
        out.append(grid.reshape(n, n_t, c, ny * nx).transpose(2, 3))
    return torch.cat(out, dim=3)


RASTER_CASES = {
    "random24": (24, lambda r: random_faces(r, 1, 60), 2048),
    "random64": (64, lambda r: random_faces(r, 2, 700), 2048),
    "random96": (96, lambda r: random_faces(r, 3, 300), 2048),
    "random128": (128, lambda r: random_faces(r, 1, 2000), 2048),
    "degenerate64": (64, lambda r: degenerate_faces(r, 64), 2048),
    # tiles cut by the frame: 32 x 40 over 40^2 (the second row 8 pixels),
    # 32 x 128 over 131^2 (the last row and column 3 pixels)
    "random40": (40, lambda r: random_faces(r, 1, 150), 2048),
    "random131": (131, lambda r: random_faces(r, 1, 400), 2048),
    "degenerate128": (128, lambda r: np.concatenate(
        [degenerate_faces(r, 128), random_faces(r, 1, 400)], 1), 2048),
    "overflow32": (32, lambda r: np.stack(
        [np.concatenate([np.array([[-0.9, -0.9], [0.9, -0.9], [0.0, 0.9]]),
                         np.full((3, 1), z)], 1) for z in np.linspace(1, 2, 8)]
    )[None].astype(np.float32), 4),
}
_BINNED: dict = {}


def _binned(case):
    if case not in _BINNED:
        s, make, cap = RASTER_CASES[case]
        faces = make(np.random.default_rng(len(case) + s))
        th, tw = min(32, s), min(128, s)
        table, ids, counts, _ = bin_faces(_t(faces), s, th, tw, cap)
        plain = rasterize_tiles_torch(table, ids, counts, s, th, tw,
                                      far=100.0)
        _BINNED[case] = (s, th, tw, table, ids, counts, plain, {})
    return _BINNED[case]


# K7's block shape and the others that chip_variants.py times, each
# (block rows, block columns, warp rows)
@pytest.mark.parametrize("block", K7_SHAPES)
@pytest.mark.parametrize("case", list(RASTER_CASES))
def test_k7_cull_is_exact(case, block):
    """K7's cull (cull_keep over the tile's blocks, then the warps'
    warp_h x 32 rectangles) and its walk over the survivors give the plain
    version's depth and face index bit for bit, and every (rectangle,
    candidate) pair it drops fails the inside test at every pixel of the
    rectangle."""
    s, th, tw, table, ids, counts, plain, inside = _binned(case)
    (depth, idx), kb, kw = _k7_emulate(table, ids, counts, s, th, tw, 100.0,
                                       block)
    assert torch.equal(idx, plain[1]) and torch.equal(depth, plain[0])
    assert bool((plain[1] >= 0).any())
    bh, bw, wh = block
    for rect in ((bh, bw), (wh, WARP_W)):
        if rect not in inside:
            inside[rect] = _inside_any(table, ids, counts, s, th, tw, *rect)
    kb_any = inside[(bh, bw)]
    kw_any = inside[(wh, WARP_W)]
    k_run = int(counts.max())
    live = ((torch.arange(k_run) < counts[..., None])
            & (ids[:, :, :k_run] >= 0))[:, :, None]
    for keep, inside in ((kb, kb_any), (kw, kw_any)):
        assert not bool((inside & live & ~keep).any())
    if case != "overflow32":   # not vacuous: the cull drops pairs
        assert bool((live & ~kw).any())
        assert bool((live & ~kb).any()) or (bh >= th and bw >= tw)


def test_block_is_the_kernels_shape():
    """BLOCK, the shape the cull's emulation and chip_smoke.py's counts
    take for K7's, is the one csrc/rasterize_tiles.cu builds, and one of
    the shapes tested above; every shape is made of whole warps of
    WARP_W columns, as the kernel's lanes take one column each."""
    src = (_build.CSRC / "rasterize_tiles.cu").read_text()
    built = tuple(int(re.search(rf"constexpr int {k} = (\d+);", src)[1])
                  for k in ("BH", "BW", "WH"))
    assert built == BLOCK and BLOCK in K7_SHAPES and WARP_W == 32
    assert all(bh % wh == 0 and bw % WARP_W == 0 for bh, bw, wh in K7_SHAPES)
