"""The port's neural_renderer API (ops/render_api.py), texture atlas
(ops/texture_atlas.py) and textured OBJ tools (data/obj.py) against
rnr_tpu's, on the CPU.

- render_api: the camera modes and lighting to 1e-6 of their largest
  value; sample_textures' values and texture gradient to 1e-5;
  rasterize_rgbad (with and without anti-aliasing) equal maps and rgb /
  depth to 1e-5 of their largest; the Renderer in projection, look_at
  and look modes, with fill_back; and the checks of
  tests/test_render_api.py on the port.
- texture_atlas: load_textures in all four wrap modes, bilinear and
  nearest, and create_texture_image, to 1e-6 of rnr_tpu's; the checks
  of tests/test_texture_atlas_utils.py.
- obj: load_mtl, load_obj(load_texture=True) (Kd fills and map_Kd
  images, every wrap mode) equal to rnr_tpu's to 1e-6; save_obj's obj,
  mtl and png the same files as rnr_tpu's; the round trip of
  tests/test_obj_io.py:81-152; a JPEG texture raises a ValueError that
  names the format.
"""

import filecmp

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnr_tpu.data import obj as jobj
from rnr_tpu.ops import render_api as jra
from rnr_tpu.ops import texture_atlas as jta
from rnr_tpu_torch.data import obj as pobj
from rnr_tpu_torch.data.imageio import read_png
from rnr_tpu_torch.ops import render_api as pra
from rnr_tpu_torch.ops import texture_atlas as pta
from rnr_tpu_torch.ops.rasterize import rasterize_face_index

torch.set_num_threads(2)


def _close(got, want, rel=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


# ---------------------------------------------------------------- cameras


@pytest.mark.parametrize("mode", ["look_at", "look"])
def test_camera_modes_match_rnr_tpu(mode):
    v = np.random.default_rng(0).standard_normal((2, 10, 3)).astype(
        np.float32)
    kw = (dict(eye=[0.3, 0.5, -3.0], at=[0.1, 0.2, 0.0], up=[0, 1, 0.2])
          if mode == "look_at" else
          dict(eye=[0.5, 0.0, -3.0], direction=[0.1, 0.2, 1.0]))
    _close(getattr(pra, mode)(torch.from_numpy(v), **kw),
           getattr(jra, mode)(jnp.asarray(v), **kw))


def test_perspective_and_points_from_angles_match_rnr_tpu():
    v = np.random.default_rng(1).standard_normal((1, 10, 3)).astype(
        np.float32)
    v[..., 2] += 5.0
    for angle in (30.0, 45.0):
        _close(pra.perspective(torch.from_numpy(v), angle),
               jra.perspective(jnp.asarray(v), angle))
    for args in ((2.0, 15.0, 30.0), (1.5, -20.0, 200.0)):
        _close(pra.get_points_from_angles(*args),
               jra.get_points_from_angles(*args))
    _close(pra.get_points_from_angles(2.0, 0.3, 1.2, degrees=False),
           jra.get_points_from_angles(2.0, 0.3, 1.2, degrees=False))


def test_look_at_centers_target():
    out = pra.look_at(torch.zeros((1, 1, 3)), eye=[0, 0, -2.0]).numpy()
    np.testing.assert_allclose(out[0, 0], [0, 0, 2.0], atol=1e-5)


def test_look_matches_look_at_when_aligned():
    v = torch.randn((1, 10, 3), generator=torch.Generator().manual_seed(0))
    a = pra.look_at(v, eye=[0, 0, -3.0], at=[0, 0, 0])
    b = pra.look(v, eye=[0, 0, -3.0], direction=[0, 0, 1.0])
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_get_points_from_angles():
    np.testing.assert_allclose(pra.get_points_from_angles(2.0, 0.0, 0.0),
                               [0, 0, -2.0], atol=1e-6)
    np.testing.assert_allclose(pra.get_points_from_angles(1.0, 90.0, 0.0),
                               [0, 1.0, 0], atol=1e-6)


# --------------------------------------------------------------- lighting


def test_lighting_matches_rnr_tpu():
    rng = np.random.default_rng(2)
    faces = rng.standard_normal((2, 5, 3, 3)).astype(np.float32)
    tex = rng.uniform(0, 1, (2, 5, 3, 3, 3, 3)).astype(np.float32)
    for args in ((0.5, 0.5), (0.3, 0.7, (1, 0.5, 0.2), (0.2, 1, 1),
                              (0.2, 1.0, -0.4)), (0.0, 1.0), (1.0, 0.0)):
        _close(pra.lighting(torch.from_numpy(faces), torch.from_numpy(tex),
                            *args),
               jra.lighting(jnp.asarray(faces), jnp.asarray(tex), *args))


def test_lighting_ambient_and_directional():
    faces = torch.tensor([[[[0, 0, 0], [1, 0, 0], [0, 1, 0]]]],
                         dtype=torch.float32)
    tex = torch.ones((1, 1, 2, 2, 2, 3))
    np.testing.assert_allclose(pra.lighting(faces, tex, 1.0, 0.0), 1.0,
                               atol=1e-6)
    np.testing.assert_allclose(pra.lighting(faces, tex, 0.0, 1.0,
                                            direction=(0, 0, -1)), 1.0,
                               atol=1e-5)
    np.testing.assert_allclose(pra.lighting(faces, tex, 0.0, 1.0,
                                            direction=(0, 0, 1)), 0.0,
                               atol=1e-6)


# ------------------------------------------------------- texture sampling


def _faces(seed=3, f=7):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.9, 0.9, (1, f, 1, 2)) + rng.uniform(
        -0.6, 0.6, (1, f, 3, 2))
    z = rng.uniform(1.5, 4.0, (1, f, 3, 1))
    return np.concatenate([xy, z], -1).astype(np.float32)


@pytest.mark.parametrize("ts", [2, 4])
def test_sample_textures_matches_rnr_tpu(ts):
    """On random maps (rnr_tpu's ts=2 specialisation and its general
    loop): values and the texture gradient of a random weighting."""
    rng = np.random.default_rng(ts)
    n, f, s, c = 2, 7, 8, 5
    faces = rng.standard_normal((n, f, 3, 3)).astype(np.float32)
    faces[..., 2] = np.abs(faces[..., 2]) + 1.0
    tex = rng.uniform(0, 1, (n, f, ts, ts, ts, c)).astype(np.float32)
    fim = rng.integers(-1, f, (n, s, s)).astype(np.int32)
    w = rng.uniform(0, 1, (n, s, s, 3)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    depth = rng.uniform(1, 2, (n, s, s)).astype(np.float32)
    wt = rng.uniform(0, 1, (n, s, s, c)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (faces, tex, fim, w, depth)]
    want = jra.sample_textures(*jargs)
    gwant = jax.grad(lambda t: jnp.sum(jra.sample_textures(
        jargs[0], t, *jargs[2:]) * wt))(jargs[1])
    tt = torch.tensor(tex, requires_grad=True)
    got = pra.sample_textures(torch.from_numpy(faces), tt,
                              torch.from_numpy(fim), torch.from_numpy(w),
                              torch.from_numpy(depth))
    _close(got, want, 1e-5)
    (got * torch.from_numpy(wt)).sum().backward()
    _close(tt.grad, gwant, 1e-5)


def _big_triangle(z=2.0):
    return np.asarray([[[[-0.9, -0.9, z], [0.9, -0.9, z], [0.0, 0.9, z]]]],
                      np.float32)


def test_sample_textures_constant_volume():
    faces = torch.from_numpy(_big_triangle())
    out = rasterize_face_index(faces, 16, far=10.0, face_chunk=1)
    rgb = pra.sample_textures(faces, torch.full((1, 1, 4, 4, 4, 3), 0.7),
                              out.face_index_map, out.weight_map,
                              out.depth_map).numpy()
    covered = out.face_index_map.numpy() >= 0
    np.testing.assert_allclose(rgb[covered], 0.7, atol=1e-5)
    assert (rgb[~covered] == 0).all()


def test_sample_textures_gradients():
    faces = torch.from_numpy(_big_triangle())
    out = rasterize_face_index(faces, 8, far=10.0, face_chunk=1)
    tex = torch.zeros((1, 1, 4, 4, 4, 3), requires_grad=True)
    pra.sample_textures(faces, tex, out.face_index_map, out.weight_map,
                        out.depth_map).sum().backward()
    covered = float((out.face_index_map >= 0).sum())
    np.testing.assert_allclose(float(tex.grad.sum()), covered * 3,
                               rtol=1e-5)


def test_fill_back():
    out = pra.fill_back_faces(torch.tensor([[[0, 1, 2]]], dtype=torch.int32))
    np.testing.assert_array_equal(out.numpy(), [[[0, 1, 2], [2, 1, 0]]])


# ------------------------------------------------------------ rasterizing


@pytest.mark.parametrize("aa", [False, True])
def test_rasterize_rgbad_matches_rnr_tpu(aa):
    """Seven random faces with 3^3 texture volumes and a background: the
    discrete maps equal, rgb / alpha / depth / weights to 1e-5 of their
    largest (a few f32 roundings: XLA fuses rnr_tpu's quotients); the depth's face gradient and the textures' gradient of a
    random weighting to 1e-5 of their largest."""
    rng = np.random.default_rng(4)
    faces = _faces()
    tex = rng.uniform(0, 1, (1, 7, 3, 3, 3, 3)).astype(np.float32)
    s = 16
    kw = dict(image_size=s, anti_aliasing=aa, near=0.1, far=10.0,
              background_color=(0.2, 0.1, 0.3))
    want = jra.rasterize_rgbad(jnp.asarray(faces), jnp.asarray(tex), **kw)
    ft = torch.tensor(faces, requires_grad=True)
    tt = torch.tensor(tex, requires_grad=True)
    got = pra.rasterize_rgbad(ft, tt, **kw)
    np.testing.assert_array_equal(got["face_index_map"].numpy(),
                                  np.asarray(want["face_index_map"]))
    for k in ("rgb", "alpha", "depth", "weight_map"):
        _close(got[k], want[k], 1e-5)
    wr = rng.uniform(0, 1, (1, 3, s, s)).astype(np.float32)
    wd = rng.uniform(0, 1, (1, s, s)).astype(np.float32)

    def jloss(f, t):
        o = jra.rasterize_rgbad(f, t, **kw)
        return jnp.sum(o["rgb"] * wr) + jnp.sum(o["depth"] * wd)

    gf, gt = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(faces),
                                             jnp.asarray(tex))
    ((got["rgb"] * torch.from_numpy(wr)).sum()
     + (got["depth"] * torch.from_numpy(wd)).sum()).backward()
    _close(ft.grad, gf, 1e-5)
    _close(tt.grad, gt, 1e-5)


def test_rasterize_silhouettes_and_depth_match_rnr_tpu():
    faces = _faces(5, 9)
    for fn in ("rasterize_silhouettes", "rasterize_depth"):
        for aa in (False, True):
            _close(getattr(pra, fn)(torch.from_numpy(faces), 16, aa,
                                    far=10.0),
                   getattr(jra, fn)(jnp.asarray(faces), 16, aa, far=10.0))


def test_rasterize_rgbad_aa_shapes():
    faces = torch.from_numpy(_big_triangle())
    out = pra.rasterize_rgbad(faces, torch.full((1, 1, 2, 2, 2, 3), 0.5),
                              image_size=16, anti_aliasing=True, far=10.0)
    assert out["rgb"].shape == (1, 3, 16, 16)
    assert out["alpha"].shape == (1, 16, 16)
    a = out["alpha"].numpy()
    assert ((a > 0) & (a < 1)).any()
    sil = pra.rasterize_silhouettes(faces, image_size=16, far=10.0)
    np.testing.assert_allclose(sil.numpy(), a, atol=1e-6)


# ------------------------------------------------------------- the facade


def _scene():
    rng = np.random.default_rng(6)
    verts = rng.uniform(-0.6, 0.6, (1, 12, 3)).astype(np.float32)
    faces = rng.integers(0, 12, (1, 10, 3)).astype(np.int32)
    tex = rng.uniform(0, 1, (1, 10, 2, 2, 2, 3)).astype(np.float32)
    return verts, faces, tex


@pytest.mark.parametrize("mode", ["projection", "look_at", "look"])
@pytest.mark.parametrize("fill_back", [False, True])
def test_renderer_matches_rnr_tpu(mode, fill_back):
    """Renderer.render's 8-tuple against rnr_tpu's on a random textured
    mesh: the discrete maps and faces equal, the rest to 1e-5 of their
    largest (the projection's and the weights' quotients)."""
    verts, faces, tex = _scene()
    s = 24
    kw = dict(image_size=s, camera_mode=mode, anti_aliasing=True,
              fill_back=fill_back, near=0.1, far=100.0, orig_size=s,
              light_intensity_ambient=0.4, light_intensity_directional=0.6,
              light_direction=(0.3, 1.0, -0.2))
    jr, pr = jra.Renderer(**kw), pra.Renderer(**kw)
    cam = {}
    if mode == "projection":
        verts = verts + np.float32([0, 0, 2.5])
        k = np.asarray([[[s / 2, 0, s / 2], [0, s / 2, s / 2], [0, 0, 1]]],
                       np.float32)
        cam = dict(K=k, R=np.eye(3, dtype=np.float32)[None],
                   t=np.zeros((1, 1, 3), np.float32),
                   dist_coeffs=np.zeros((1, 5), np.float32))
    else:
        eye = np.asarray(jra.get_points_from_angles(2.5, 15.0, 30.0))
        jr.eye, pr.eye = jnp.asarray(eye), torch.tensor(eye)
    want = jr.render(jnp.asarray(verts), jnp.asarray(faces),
                     jnp.asarray(tex),
                     **{k: jnp.asarray(v) for k, v in cam.items()})
    got = pr.render(torch.from_numpy(verts), torch.from_numpy(faces),
                    torch.from_numpy(tex),
                    **{k: torch.from_numpy(v) for k, v in cam.items()})
    assert float(np.asarray(want[2]).sum()) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        if i in (3, 7):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g, w, 1e-5)


def test_renderer_facade_projection_mode():
    s = 32
    verts = torch.tensor([[[-0.5, -0.5, 2.0], [0.5, -0.5, 2.0],
                           [0.0, 0.5, 2.0]]])
    r = pra.Renderer(image_size=s, camera_mode="projection", orig_size=s,
                     anti_aliasing=False, fill_back=False, near=0.0,
                     far=100.0, light_intensity_ambient=1.0,
                     light_intensity_directional=0.0)
    rgb, depth, alpha, *_ = r.render(
        verts, torch.tensor([[[0, 2, 1]]], dtype=torch.int32),
        torch.full((1, 1, 2, 2, 2, 3), 1.0),
        K=torch.tensor([[[s / 2, 0, s / 2], [0, s / 2, s / 2],
                         [0, 0, 1.0]]]),
        R=torch.eye(3)[None], t=torch.zeros((1, 1, 3)),
        dist_coeffs=torch.zeros((1, 5)))
    cov = alpha.numpy() > 0
    assert cov.sum() > 0
    np.testing.assert_allclose(depth.numpy()[cov], 2.0, rtol=1e-4)
    np.testing.assert_allclose(rgb.numpy()[0, :, cov[0]], 1.0, atol=1e-4)


def test_renderer_facade_look_at_mode():
    r = pra.Renderer(image_size=32, camera_mode="look_at",
                     anti_aliasing=False, fill_back=True, near=0.1,
                     far=100.0)
    r.eye = pra.get_points_from_angles(2.0, 15.0, 30.0)
    _, _, alpha, *_ = r.render(
        torch.tensor([[[-0.3, -0.3, 0.0], [0.3, -0.3, 0.0],
                       [0.0, 0.4, 0.0]]]),
        torch.tensor([[[0, 1, 2]]], dtype=torch.int32), None)
    assert float(alpha.sum()) > 0


# --------------------------------------------------------- texture atlas


@pytest.mark.parametrize("wrap", [pta.REPEAT, pta.MIRRORED_REPEAT,
                                  pta.CLAMP_TO_EDGE, pta.CLAMP_TO_BORDER])
@pytest.mark.parametrize("bilinear", [True, False])
def test_load_textures_matches_rnr_tpu(wrap, bilinear):
    rng = np.random.default_rng(wrap)
    img = rng.uniform(0, 1, (9, 13, 3)).astype(np.float32)
    uv = rng.uniform(-1.5, 2.5, (6, 3, 2)).astype(np.float32)
    _close(pta.load_textures(torch.from_numpy(img), torch.from_numpy(uv), 4,
                             wrap, bilinear),
           jta.load_textures(jnp.asarray(img), jnp.asarray(uv), 4, wrap,
                             bilinear))


@pytest.mark.parametrize("f,tsi,tso", [(5, 4, 8), (7, 2, 16), (1, 3, 4)])
def test_create_texture_image_matches_rnr_tpu(f, tsi, tso):
    tex = np.random.default_rng(f).uniform(
        0, 1, (f, tsi, tsi, tsi, 3)).astype(np.float32)
    img, uv = pta.create_texture_image(torch.from_numpy(tex), tso)
    jimg, juv = jta.create_texture_image(jnp.asarray(tex), tso)
    _close(img, jimg)
    _close(uv, juv)


def test_load_textures_constant_image_and_wrap_modes():
    img = torch.full((8, 8, 3), 0.6)
    uv = torch.tensor([[[0.1, 0.1], [0.9, 0.1], [0.5, 0.9]]])
    tex = pta.load_textures(img, uv, texture_size=4)
    assert tex.shape == (1, 4, 4, 4, 3)
    np.testing.assert_allclose(tex.numpy(), 0.6, atol=1e-6)
    img = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (8, 8, 3)).astype(np.float32))
    uv_out = torch.tensor([[[1.25, 0.5], [1.75, 0.5], [1.5, 0.75]]])
    uv_eq = torch.tensor([[[0.25, 0.5], [0.75, 0.5], [0.5, 0.75]]])
    uv_mir = torch.tensor([[[0.75, 0.5], [0.25, 0.5], [0.5, 0.75]]])
    np.testing.assert_allclose(pta.load_textures(img, uv_out, 2),
                               pta.load_textures(img, uv_eq, 2), atol=1e-6)
    np.testing.assert_allclose(
        pta.load_textures(img, uv_out, 2, wrap=pta.MIRRORED_REPEAT),
        pta.load_textures(img, uv_mir, 2), atol=1e-6)
    assert (pta.load_textures(img, uv_out, 2,
                              wrap=pta.CLAMP_TO_BORDER) == 0).all()
    assert torch.isfinite(pta.load_textures(img, uv_out, 2,
                                            wrap=pta.CLAMP_TO_EDGE)).all()


def test_create_texture_image_roundtrip_constant():
    img, uv = pta.create_texture_image(torch.full((5, 4, 4, 4, 3), 0.3),
                                       texture_size_out=8)
    assert img.shape[0] % 8 == 0 and img.shape[1] % 8 == 0
    assert uv.shape == (5, 3, 2)
    assert 0 <= float(uv.min()) and float(uv.max()) <= 1.0
    np.testing.assert_allclose(img.numpy(), 0.3, atol=1e-5)


# -------------------------------------------------------------------- OBJ


def _textured_obj(root, tex_name="tex.png"):
    """tests/test_obj_io.py's two-material OBJ with an 8 x 8 red texture
    (written as rnr_tpu's test writes it, by cv2), plus a third face on a
    random 12 x 10 texture, a polygon and a corner without a vt index."""
    img = np.zeros((8, 8, 3), np.uint8)
    img[:, :, 2] = 255   # BGR red
    cv2.imwrite(str(root / "tex.png"), img)
    rnd = np.random.default_rng(0).integers(0, 256, (12, 10, 3))
    cv2.imwrite(str(root / "rnd.png"), rnd.astype(np.uint8))
    (root / "m.mtl").write_text(
        "newmtl blue\nKd 0.0 0.0 1.0\n"
        f"newmtl texd\nmap_Kd {tex_name}\n"
        "newmtl rnd\nKd 0.3 0.3 0.3\nmap_Kd rnd.png\n")
    (root / "m.obj").write_text(
        "mtllib m.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nv 2 1 0\n"
        "vt 0.1 0.1\nvt 0.9 0.1\nvt 0.5 0.9\nvt 1.3 -0.2\n"
        "usemtl blue\nf 1/1 2/2 3/3\n"
        "usemtl texd\nf 2/1 4/2 3/3\n"
        "usemtl rnd\nf 1/4 2/2 4/1 5/3\nf 1 3 5\n")
    return str(root / "m.obj")


def test_load_mtl_matches_rnr_tpu(tmp_path):
    _textured_obj(tmp_path)
    pc, pf = pobj.load_mtl(str(tmp_path / "m.mtl"))
    jc, jf = jobj.load_mtl(str(tmp_path / "m.mtl"))
    assert pf == jf and pc.keys() == jc.keys()
    for k in jc:
        np.testing.assert_array_equal(pc[k], jc[k])


@pytest.mark.parametrize("wrapping", ["REPEAT", "MIRRORED_REPEAT",
                                      "CLAMP_TO_EDGE", "CLAMP_TO_BORDER"])
@pytest.mark.parametrize("bilinear", [True, False])
def test_load_obj_textures_match_rnr_tpu(tmp_path, wrapping, bilinear):
    path = _textured_obj(tmp_path)
    kw = dict(load_texture=True, texture_size=3, texture_wrapping=wrapping,
              use_bilinear=bilinear)
    got = pobj.load_obj(path, **kw)
    want = jobj.load_obj(path, use_native=False, **kw)
    assert got.textures.shape == want.textures.shape == (5, 3, 3, 3, 3)
    _close(got.textures, want.textures)
    for k in ("v", "vt", "vn", "f_v_idx", "f_vt_idx", "f_vn_idx"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


def test_load_obj_mtl_texture_path(tmp_path):
    path = _textured_obj(tmp_path)
    m = pobj.load_obj(path, load_texture=True, texture_size=4)
    assert m.textures.shape == (5, 4, 4, 4, 3)
    np.testing.assert_allclose(
        m.textures[0], np.broadcast_to([0.0, 0.0, 1.0], (4, 4, 4, 3)),
        atol=1e-6)
    np.testing.assert_allclose(
        m.textures[1], np.broadcast_to([1.0, 0.0, 0.0], (4, 4, 4, 3)),
        atol=2e-2)


def test_load_obj_no_mtllib_raises(tmp_path):
    (tmp_path / "m.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    with pytest.raises(RuntimeError, match="no mtllib"):
        pobj.load_obj(str(tmp_path / "m.obj"), load_texture=True)


def test_load_obj_jpeg_texture_raises(tmp_path):
    """A map_Kd JPEG (4:2:0, odd size, smooth colours) and a gray one:
    the texture image bit-equal to rnr_tpu's cv2 read, and the port's
    load_obj(load_texture=True) to rnr_tpu's as in
    test_load_obj_textures_match_rnr_tpu; nothing raises."""
    yy, xx = np.mgrid[0:13, 0:11] / 13.0
    img = np.stack([200 * xx, 150 * yy, 90 + 60 * xx * yy], -1)
    cv2.imwrite(str(tmp_path / "t.jpg"), img.astype(np.uint8))
    cv2.imwrite(str(tmp_path / "g.jpg"), (250 * yy).astype(np.uint8))
    for name in ("t.jpg", "g.jpg"):
        raw = cv2.imread(str(tmp_path / name), cv2.IMREAD_UNCHANGED)
        raw = np.stack([raw] * 3, -1) if raw.ndim == 2 else raw[..., ::-1]
        np.testing.assert_array_equal(
            pobj._read_texture(str(tmp_path / name)),
            raw[::-1].astype(np.float32) / 255.0)
        path = _textured_obj(tmp_path, name)
        kw = dict(load_texture=True, texture_size=4)
        got = pobj.load_obj(path, **kw)
        want = jobj.load_obj(path, use_native=False, **kw)
        assert got.textures.shape == want.textures.shape == (5, 4, 4, 4, 3)
        _close(got.textures, want.textures)


def test_save_obj_writes_rnr_tpus_files(tmp_path):
    """save_obj with textures: the same .obj, .mtl and .png as rnr_tpu's
    (the atlas through cv2's BGR write there, the port's PNG writer
    here: the same pixels); without textures, the same OBJ text."""
    rng = np.random.default_rng(1)
    v = rng.uniform(-1, 1, (5, 3)).astype(np.float32)
    f = np.array([[0, 1, 2], [1, 3, 2], [2, 3, 4]], np.int32)
    tex = rng.uniform(0, 1, (3, 3, 3, 3, 3)).astype(np.float32)
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    jobj.save_obj(str(tmp_path / "j" / "a.obj"), v, f, textures=tex,
                  texture_size_out=8)
    pobj.save_obj(str(tmp_path / "p" / "a.obj"), v, f, textures=tex,
                  texture_size_out=8)
    for ext in ("obj", "mtl"):
        assert filecmp.cmp(tmp_path / "j" / f"a.{ext}",
                           tmp_path / "p" / f"a.{ext}", shallow=False), ext
    np.testing.assert_array_equal(
        read_png(str(tmp_path / "p" / "a.png")),
        cv2.imread(str(tmp_path / "j" / "a.png"))[:, :, ::-1])
    vt = rng.uniform(0, 1, (5, 2)).astype(np.float32)
    vn = rng.uniform(-1, 1, (5, 3)).astype(np.float32)
    for kw in (dict(), dict(vt=vt, f_vt_idx=f), dict(vn=vn, f_vn_idx=f),
               dict(vt=vt, vn=vn, f_vt_idx=f, f_vn_idx=f)):
        jobj.save_obj(str(tmp_path / "j.obj"), v, f, **kw)
        pobj.save_obj(str(tmp_path / "p.obj"), v, f, **kw)
        assert filecmp.cmp(tmp_path / "j.obj", tmp_path / "p.obj",
                           shallow=False), sorted(kw)


def test_save_obj_bakes_texture_atlas(tmp_path):
    """tests/test_obj_io.py's round trip on the port: the baked atlas read
    back through load_obj(load_texture=True, CLAMP_TO_EDGE) gives the
    per-face colours (voxel (0, 0, 0) skipped, as there)."""
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    f = np.array([[0, 1, 2], [1, 3, 2]], np.int32)
    tex = np.zeros((2, 4, 4, 4, 3), np.float32)
    tex[0] = [1.0, 0.0, 0.0]
    tex[1] = [0.0, 1.0, 0.0]
    p = tmp_path / "baked.obj"
    pobj.save_obj(str(p), v, f, textures=tex)
    assert (tmp_path / "baked.mtl").exists()
    assert (tmp_path / "baked.png").exists()
    m = pobj.load_obj(str(p), load_texture=True, texture_size=4,
                      texture_wrapping="CLAMP_TO_EDGE")
    t = m.textures.reshape(2, -1, 3)[:, 1:, :]
    np.testing.assert_allclose(
        t[0], np.broadcast_to([1.0, 0.0, 0.0], t[0].shape), atol=0.05)
    np.testing.assert_allclose(
        t[1], np.broadcast_to([0.0, 1.0, 0.0], t[1].shape), atol=0.05)
