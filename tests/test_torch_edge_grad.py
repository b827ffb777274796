"""The port's differentiable rasterizer against rnr_tpu's, on the CPU:
`silhouette` and `rasterize_opt` (ops/edge_grad.py), whose forward runs
K7's plain version (`rasterize_tiled` on CPU tensors) at every size, the
oracle again on K7 overflow.

- forward maps equal to rnr_tpu's (the face index exact; rgb and depth to
  1e-6 of their largest, as rnr_tpu's own parity tests);
- gradients of faces and textures within 1e-4 of the largest against
  rnr_tpu's custom VJPs under random upstream weights;
- the sign, finite-difference, fitting and sliver tests of
  tests/test_edge_grad.py, on the port (torch.optim.Adam with optax's
  defaults);
- K7 at every size, on the largest tiles within 32 x 128 that divide
  it (sizes the TPU kernel's tile does not divide match rnr_tpu's
  oracle there); the oracle taken on the overflow case, counted in
  ORACLE_TAKEN, and never on the cases above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnr_tpu.ops import edge_grad as jeg
from rnr_tpu.ops.rasterize import rasterize_face_index as j_raster
from rnr_tpu_torch.ops import edge_grad
from rnr_tpu_torch.ops.edge_grad import (ORACLE_TAKEN, edge_gradients,
                                         rasterize_opt, silhouette)
from rnr_tpu_torch.ops.rasterize import rasterize_face_index
from rnr_tpu_torch.ops.rasterize_cuda import _untile, tile_grid
from rnr_tpu_torch.ops.render_api import rasterize_rgbad

torch.set_num_threads(2)
S = 32


def _tri(cx=0.0, cy=0.0, r=0.5, z=2.0):
    return np.asarray([[[cx - r, cy - r, z], [cx + r, cy - r, z],
                        [cx, cy + r, z]]], np.float32)[None]


def _tex(color, f=1, ts=2):
    t = np.zeros((1, f, ts, ts, ts, 3), np.float32)
    t[..., :] = color
    return t


def _mesh(seed=0, f=24):
    """Random front-and-back faces over the screen at depths 1.5-4, one
    partly off screen: several faces per pixel, ties in coverage."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-0.8, 0.8, (1, f, 1, 2))
    xy = c + rng.uniform(-0.5, 0.5, (1, f, 3, 2))
    xy[0, 0] += 0.9
    z = rng.uniform(1.5, 4.0, (1, f, 3, 1))
    return np.concatenate([xy, z], -1).astype(np.float32)


@pytest.fixture(autouse=True)
def _oracle_counts():
    before = dict(ORACLE_TAKEN)
    yield
    ORACLE_TAKEN.update(before)


CASES = {"triangle": (_tri(cx=0.1, cy=-0.05, r=0.5), S),
         "mesh": (_mesh(), S), "mesh_64": (_mesh(1, 60), 64)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_silhouette_matches_rnr_tpu(case):
    """Forward equal to rnr_tpu's silhouette and to the oracle's alpha;
    the faces' gradient under random upstream weights within 1e-4 of the
    largest against rnr_tpu's custom VJP; K7's plain version, never the
    oracle."""
    f, s = CASES[case]
    wm = np.random.default_rng(2).uniform(0.2, 1, (1, s, s)).astype(
        np.float32)
    want = np.asarray(jeg.silhouette(jnp.asarray(f), s, 0.0, 100.0))
    gj = np.asarray(jax.grad(lambda x: jnp.sum(
        jeg.silhouette(x, s, 0.0, 100.0) * wm))(jnp.asarray(f)))
    before = dict(ORACLE_TAKEN)
    ft = torch.tensor(f, requires_grad=True)
    got = silhouette(ft, s, 0.0, 100.0)
    assert ORACLE_TAKEN == before
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_array_equal(
        want, np.asarray(j_raster(jnp.asarray(f), s, far=100.0).alpha_map))
    (got * torch.from_numpy(wm)).sum().backward()
    scale = float(np.abs(gj).max())
    assert scale > 0
    np.testing.assert_allclose(ft.grad.numpy(), gj, rtol=0,
                               atol=1e-4 * scale)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("aa", [False, True])
def test_rasterize_opt_matches_rnr_tpu(case, aa):
    """rgb, alpha, depth against rnr_tpu's rasterize_opt (alpha exact);
    the faces' and textures' gradients of a random weighting of all three
    within 1e-4 of their largest."""
    f, s = CASES[case]
    nf = f.shape[1]
    rng = np.random.default_rng(3)
    tex = rng.uniform(0, 1, (1, nf, 3, 3, 3, 3)).astype(np.float32)
    w3 = rng.uniform(0.2, 1, (1, 3, s, s)).astype(np.float32)
    w1 = rng.uniform(0.2, 1, (1, s, s)).astype(np.float32)
    kw = dict(anti_aliasing=aa, near=0.0, far=100.0,
              background_color=(0.1, 0.2, 0.3))

    def jloss(x, t):
        o = jeg.rasterize_opt(x, t, s, **kw)
        return (jnp.sum(o["rgb"] * w3) + jnp.sum(o["alpha"] * w1)
                + jnp.sum(o["depth"] * w1) * 1e-3)

    jo = jeg.rasterize_opt(jnp.asarray(f), jnp.asarray(tex), s, **kw)
    gf, gt = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(f),
                                             jnp.asarray(tex))
    ft = torch.tensor(f, requires_grad=True)
    tt = torch.tensor(tex, requires_grad=True)
    po = rasterize_opt(ft, tt, s, **kw)
    for k in ("rgb", "alpha", "depth"):
        want = np.asarray(jo[k])
        assert po[k].shape == want.shape, k
        tol = 0 if k == "alpha" else 1e-6 * float(np.abs(want).max())
        np.testing.assert_allclose(po[k].detach().numpy(), want, rtol=0,
                                   atol=tol, err_msg=k)
    loss = ((po["rgb"] * torch.from_numpy(w3)).sum()
            + (po["alpha"] * torch.from_numpy(w1)).sum()
            + (po["depth"] * torch.from_numpy(w1)).sum() * 1e-3)
    loss.backward()
    for got, want in ((ft.grad, gf), (tt.grad, gt)):
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        assert scale > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * scale)


def test_edge_gradients_match_rnr_tpu_on_given_maps():
    """edge_gradients alone, on the oracle's maps of the random mesh, with
    alpha and a photometric term (random rgb and upstream gradients):
    within 1e-4 of the largest."""
    f = _mesh(4, 40)
    rng = np.random.default_rng(5)
    o = rasterize_face_index(torch.from_numpy(f), S, far=100.0)
    ga = rng.standard_normal((1, S, S)).astype(np.float32)
    rgb = rng.uniform(0, 1, (1, S, S, 3)).astype(np.float32)
    gr = rng.standard_normal((1, S, S, 3)).astype(np.float32)
    want = np.asarray(jeg.edge_gradients(
        jnp.asarray(f), jnp.asarray(o.face_index_map.numpy()),
        jnp.asarray(o.weight_map.numpy()), jnp.asarray(o.alpha_map.numpy()),
        grad_alpha=jnp.asarray(ga), rgb_map=jnp.asarray(rgb),
        grad_rgb=jnp.asarray(gr)))
    got = edge_gradients(torch.from_numpy(f), o.face_index_map, o.weight_map,
                         o.alpha_map, grad_alpha=torch.from_numpy(ga),
                         rgb_map=torch.from_numpy(rgb),
                         grad_rgb=torch.from_numpy(gr)).numpy()
    scale = float(np.abs(want).max())
    assert scale > 0 and (got[..., 2] == 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def test_oracle_taken_where_k7_does_not_tile_or_overflows(monkeypatch):
    """At 48^2, which 32 x 128 does not divide, K7 runs on 32 x 48 tiles
    (the second row cut to 16 by the frame) and the oracle is not taken:
    the alpha map equals rnr_tpu's oracle's.  On
    rnr_tpu's overflow case (8 faces over the 32^2 screen, a cap of 4
    candidates a tile) K7 reports overflow, the oracle's maps are returned
    with K7's overflow kept, and the count rises; backend "xla" takes the
    oracle without K7 and without a count."""
    f = _mesh(6, 8)
    tiled = edge_grad.rasterize_tiled
    tiles = []

    def counted(faces, s, **k):
        tiles.append((min(k.get("tile_h", 32), s),
                      min(k.get("tile_w", 128), s)))
        return tiled(faces, s, **k)

    monkeypatch.setattr(edge_grad, "rasterize_tiled", counted)
    ORACLE_TAKEN.update(overflow=0)
    a = silhouette(torch.from_numpy(_mesh()), 48, 0.0, 100.0)
    assert tiles == [(32, 48)] and ORACLE_TAKEN == {"overflow": 0}
    np.testing.assert_array_equal(a.numpy(), np.asarray(j_raster(
        jnp.asarray(_mesh()), 48, far=100.0).alpha_map))

    monkeypatch.setattr(edge_grad, "rasterize_tiled",
                        lambda *a, **k: counted(*a, max_faces_per_tile=4,
                                                **k))
    out = edge_grad._rasterize_winner(torch.from_numpy(f), S, 0.0, 100.0)
    assert ORACLE_TAKEN == {"overflow": 1} and tiles[-1] == (32, 32)
    assert int(out.overflow.sum()) > 0
    want = rasterize_face_index(torch.from_numpy(f), S, far=100.0)
    assert torch.equal(out.face_index_map, want.face_index_map)
    assert torch.equal(out.alpha_map, want.alpha_map)
    edge_grad._rasterize_winner(torch.from_numpy(f), S, 0.0, 100.0,
                                backend="xla")
    assert ORACLE_TAKEN == {"overflow": 1} and len(tiles) == 2


@pytest.mark.parametrize("s,grid", [(32, (1, 1)), (48, (2, 1)),
                                    (200, (7, 2)), (224, (7, 2)),
                                    (320, (10, 3)), (512, (16, 4)),
                                    (37, (2, 1)), (509, (16, 4))])
def test_k7_tiles_cover_every_size(s, grid):
    """K7's tiles at any frame size: 32 x 128 (min with S), ceil(S / 32)
    x ceil(S / 128) of them, the last row and column cut by the frame (64
    tiles at 509^2, where the largest divisors within 32 x 128 gave 1 x 1
    tiles); the plain version's maps cover every pixel once."""
    assert tile_grid(s, min(32, s), min(128, s)) == grid
    th, tw = min(32, s), min(128, s)
    n_t = grid[0] * grid[1]
    fill = torch.arange(n_t, dtype=torch.float32)[None, :, None].expand(
        1, n_t, th * tw)
    seen = _untile(fill, s, th, tw)
    assert seen.shape == (1, s, s)
    assert torch.equal(seen[0, 0, 0], torch.tensor(0.0))
    assert torch.equal(seen[0, -1, -1], torch.tensor(float(n_t - 1)))


@pytest.mark.parametrize("s", [40, 72])
def test_untiled_sizes_match_the_oracle(s):
    """At sizes 32 x 128 does not divide (tiles 32 x 40, 32 x 72, the
    last row cut by the frame), the silhouette on K7's plain version
    equals rnr_tpu's (its oracle there),
    and the faces' gradient is within 1e-4 of the largest of its custom
    VJP's."""
    f = _mesh(3, 40)
    wm = np.random.default_rng(4).uniform(0.2, 1, (1, s, s)).astype(
        np.float32)
    want = np.asarray(jeg.silhouette(jnp.asarray(f), s, 0.0, 100.0))
    gj = np.asarray(jax.grad(lambda x: jnp.sum(
        jeg.silhouette(x, s, 0.0, 100.0) * wm))(jnp.asarray(f)))
    before = dict(ORACLE_TAKEN)
    ft = torch.tensor(f, requires_grad=True)
    got = silhouette(ft, s, 0.0, 100.0)
    assert ORACLE_TAKEN == before
    np.testing.assert_array_equal(got.detach().numpy(), want)
    (got * torch.from_numpy(wm)).sum().backward()
    scale = float(np.abs(gj).max())
    assert scale > 0
    np.testing.assert_allclose(ft.grad.numpy(), gj, rtol=0,
                               atol=1e-4 * scale)


# ----------------------------------- tests/test_edge_grad.py on the port


def _area_grad(f, s=S):
    ft = torch.tensor(f, requires_grad=True)
    silhouette(ft, s, 0.0, 100.0).sum().backward()
    return ft.grad.numpy()[0, 0]


def _area(f):
    return float(silhouette(torch.tensor(f), S, 0.0, 100.0).sum())


def test_area_gradient_points_outward():
    g = _area_grad(_tri())
    assert g[0, 0] < 0 and g[0, 1] < 0, g
    assert g[1, 0] > 0 and g[1, 1] < 0, g
    assert g[2, 1] > 0, g
    assert (g[:, 2] == 0).all()


def test_gradient_magnitude_matches_finite_difference():
    faces0 = _tri()
    g = _area_grad(faces0)
    eps = 2.0 * (2.0 / S)
    for vi, ax in [(0, 0), (1, 0), (2, 1)]:
        fp, fm = faces0.copy(), faces0.copy()
        fp[0, 0, vi, ax] += eps
        fm[0, 0, vi, ax] -= eps
        fd = (_area(fp) - _area(fm)) / (2 * eps)
        an = g[vi, ax]
        assert np.sign(fd) == np.sign(an), (vi, ax, fd, an)
        assert 0.2 < abs(an) / max(abs(fd), 1e-6) < 5.0, (vi, ax, fd, an)


def _fit(loss_fn, steps=150):
    """Adam (optax.adam(5e-3)'s defaults) on the faces from _tri(r=0.55)
    toward the target: the losses."""
    faces = torch.tensor(_tri(cx=0.0, cy=0.0, r=0.55), requires_grad=True)
    opt = torch.optim.Adam([faces], lr=5e-3, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for _ in range(steps + 1):
        opt.zero_grad()
        loss = loss_fn(faces)
        loss.backward()
        losses.append(float(loss.detach()))
        opt.step()
    return losses


def test_silhouette_fitting_converges():
    target = silhouette(torch.tensor(_tri(cx=0.12, cy=-0.08, r=0.45)), S,
                        0.0, 100.0)
    losses = _fit(lambda f: ((silhouette(f, S, 0.0, 100.0) - target) ** 2
                             ).mean())
    assert min(losses) < losses[0] * 0.35, (losses[0], min(losses))


def test_forward_matches_rgbad():
    faces = torch.tensor(_tri())
    tex = torch.tensor(_tex((0.8, 0.3, 0.1)))
    a = rasterize_opt(faces, tex, S, anti_aliasing=False, near=0.0,
                      far=100.0)
    b = rasterize_rgbad(faces, tex, S, anti_aliasing=False, near=0.0,
                        far=100.0)
    for k, tol in (("rgb", 1e-6), ("alpha", 1e-6), ("depth", 1e-5)):
        np.testing.assert_allclose(a[k].detach().numpy(), b[k].numpy(),
                                   atol=tol, err_msg=k)


def test_rgb_edge_term_finite_difference():
    tex = torch.tensor(_tex((1.0, 0.5, 0.25)))
    wmap = torch.tensor(np.random.default_rng(0).uniform(
        0.2, 1.0, (1, 3, S, S)).astype(np.float32))

    def loss(f):
        return (rasterize_opt(f, tex, S, anti_aliasing=False, near=0.0,
                              far=100.0)["rgb"] * wmap).sum()

    faces0 = _tri()
    ft = torch.tensor(faces0, requires_grad=True)
    loss(ft).backward()
    g = ft.grad.numpy()[0, 0]
    assert np.abs(g[:, :2]).max() > 0
    eps = 2.0 * (2.0 / S)
    for vi, ax in [(0, 0), (0, 1), (1, 0), (2, 1)]:
        fp, fm = faces0.copy(), faces0.copy()
        fp[0, 0, vi, ax] += eps
        fm[0, 0, vi, ax] -= eps
        fd = (float(loss(torch.tensor(fp)))
              - float(loss(torch.tensor(fm)))) / (2 * eps)
        an = g[vi, ax]
        assert np.sign(fd) == np.sign(an), (vi, ax, fd, an)
        assert 0.2 < abs(an) / max(abs(fd), 1e-6) < 5.0, (vi, ax, fd, an)


def test_texture_gradient_flows():
    tex = torch.tensor(_tex((0.5, 0.5, 0.5)), requires_grad=True)
    rasterize_opt(torch.tensor(_tri()), tex, S, anti_aliasing=False,
                  near=0.0, far=100.0)["rgb"].sum().backward()
    assert float(tex.grad.abs().max()) > 0


def test_photometric_fitting_converges():
    tex = torch.tensor(_tex((0.9, 0.6, 0.2)))
    target = rasterize_opt(torch.tensor(_tri(cx=0.12, cy=-0.08, r=0.45)),
                           tex, S, anti_aliasing=False, near=0.0,
                           far=100.0)["rgb"]
    losses = _fit(lambda f: ((rasterize_opt(
        f, tex, S, anti_aliasing=False, near=0.0, far=100.0)["rgb"]
        - target) ** 2).mean())
    assert min(losses) < losses[0] * 0.35, (losses[0], min(losses))


def test_sliver_triangle_has_vertical_gradient():
    faces0 = np.asarray([[[[-0.7, 0.01, 2.0], [0.7, -0.04, 2.0],
                           [0.7, 0.06, 2.0]]]], np.float32)
    assert _area(faces0) > 0
    g = _area_grad(faces0)
    assert g[2, 1] > 0, g
    assert g[1, 1] < 0, g
    eps = 2.0 * (2.0 / S)
    fp, fm = faces0.copy(), faces0.copy()
    fp[0, 0, 2, 1] += eps
    fm[0, 0, 2, 1] -= eps
    fd = (_area(fp) - _area(fm)) / (2 * eps)
    assert fd > 0
    assert 0.1 < g[2, 1] / fd < 10.0, (g[2, 1], fd)

