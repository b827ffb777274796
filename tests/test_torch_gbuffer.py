"""Port parity of the G-buffer path vs rnr_tpu: OBJ loading, the TBN /
view-direction / reflection maps, `render_gbuffer` and `render_raster`,
and the slice as a whole (mesh -> G-buffer -> batch -> eval-step image).

rnr_tpu runs on the CPU (its oracle rasterizer, or its Pallas rasterizer
in interpret mode); the port on CPU tensors (K7's plain version).

Tolerances of the maps.  Where a face is thin (the fans around the UV
sphere's poles), a pixel's barycentrics cancel terms of the face's
inverse matrix far larger than 1, so f32 fixes them only to a few units
of u * M: u = 2^-24 and M the largest sum |a x| + |b y| + |c| of a weight
there (M reaches ~1700 on the 12x16 sphere at 64^2).  A float64
evaluation of the same expressions from each side's own f32 projected
faces is the witness: both sides' weights must lie within WITNESS_K u M
of it (here rnr_tpu's within 3.4 and the port's within 5.2 in
render_gbuffer, 2.9 and 4.8 in render_raster; the port rounds every
operation, while rnr_tpu's compiled CPU program fuses some multiply-adds),
and the port's largest error, in units of u M, may exceed rnr_tpu's by at
most WITNESS_MARGIN.  Each map is then held at every
agreeing pixel to MAP_TOL (TBN, SH basis and the weights to FINE_TOL),
raised to WITNESS_K u M only where that is larger, and never past
WORST_TOL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rnr_tpu.drivers.test_rnr as jdrv
import rnr_tpu.ops.gbuffer as jg
from rnr_tpu.data.obj import Mesh as JaxMesh
from rnr_tpu.data.obj import load_obj as jax_load_obj
from rnr_tpu.ops.cameras import get_reflect_dir as j_reflect
from rnr_tpu.ops.cameras import get_view_dir_map as j_view_dir
from rnr_tpu.ops.cameras import rt_from_pos_lookat as j_lookat
from rnr_tpu.ops.tbn import face_tangents as j_face_tangents
from rnr_tpu.ops.tbn import get_tbn_map as j_tbn
from rnr_tpu.train.steps import TrainState
from rnr_tpu.train.steps import make_rnr_eval_step as j_eval_step
from rnr_tpu_torch.data import Mesh, load_obj
from rnr_tpu_torch.drivers.test_rnr import (_gbuffer, _reconcile_sh_bands,
                                            _to_batch)
from rnr_tpu_torch.ops import gbuffer as tg
from rnr_tpu_torch.ops.cameras import (get_reflect_dir, get_view_dir_map,
                                       rt_from_pos_lookat)
from rnr_tpu_torch.ops.tbn import face_tangents, get_tbn_map
from rnr_tpu_torch.synthetic import camera_ring, sphere_mesh
from rnr_tpu_torch.train.steps import make_rnr_eval_step
from test_torch_slice import SMALL, _models

torch.set_num_threads(2)

MAP_TOL = 1e-5
FINE_TOL = 1e-4
WORST_TOL = 1e-3
WITNESS_K = 8.0
WITNESS_MARGIN = 2.0
FINE_KEYS = ("TBN_map", "sh_basis_map", "weight_map")

OBJ = """# a quad, a triangle with negative indices, a positions-only face
v 0 0 0
v 1 0 0.5
v 1 1 0
v 0 1 -0.25
v 0.5 0.5 2
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
vn 0 1 0
vn 1 0 0
f 1/1/1 2/2/1 3/3/2 4/4/3
f -1/-1/-1 -2/-2/-2 -3/-3/-3
"""


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("with_rt", [False, True])
def test_load_obj_and_mesh_match_jax(tmp_path, with_rt):
    path = tmp_path / "mesh.obj"
    path.write_text(OBJ)
    want, got = jax_load_obj(str(path), use_native=False), load_obj(str(path))
    for k in ("v", "vn", "vt", "f_v_idx", "f_vn_idx", "f_vt_idx"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), k)
        assert getattr(got, k).dtype == getattr(want, k).dtype, k
    norm = load_obj(str(path), normalization=True)
    np.testing.assert_array_equal(
        norm.v, jax_load_obj(str(path), normalization=True,
                             use_native=False).v)
    rt = None
    if with_rt:
        rt = j_lookat(np.array([0.3, 1.0, 2.0]))
        rt[:3, 3] += [0.1, -0.2, 0.3]
    jm, tm = JaxMesh(str(path), global_RT=rt), Mesh(str(path), global_RT=rt)
    for k in ("v", "vn", "vt", "f_v_idx", "f_vn_idx", "f_vt_idx", "v_orig",
              "vn_orig", "span", "center", "span_orig", "center_orig"):
        np.testing.assert_array_equal(getattr(tm, k), getattr(jm, k), k)
    for k in ("span_max", "span_max_orig", "num_vertex", "num_face"):
        assert getattr(tm, k) == getattr(jm, k), k


def test_tbn_view_dir_and_reflect_match_jax():
    rng = np.random.default_rng(5)
    fv = rng.standard_normal((7, 3, 3)).astype(np.float32)
    fvt = rng.uniform(0, 1, (7, 3, 2)).astype(np.float32)
    np.testing.assert_allclose(face_tangents(_t(fv), _t(fvt)).numpy(),
                               np.asarray(j_face_tangents(jnp.asarray(fv),
                                                          jnp.asarray(fvt))),
                               rtol=1e-5, atol=1e-5)
    nm = rng.standard_normal((2, 6, 5, 3)).astype(np.float32)
    fim = rng.integers(-1, 7, (2, 6, 5)).astype(np.int32)
    np.testing.assert_allclose(
        get_tbn_map(_t(nm), _t(fim), _t(fv), _t(fvt)).numpy(),
        np.asarray(j_tbn(jnp.asarray(nm), jnp.asarray(fim), jnp.asarray(fv),
                         jnp.asarray(fvt))), rtol=0, atol=1e-5)

    pos = np.array([0.7, 0.4, 2.0])
    np.testing.assert_array_equal(rt_from_pos_lookat(pos), j_lookat(pos))
    proj = np.array([[[60.0, 0, 16], [0, 58.0, 15], [0, 0, 1]]] * 2,
                    np.float32)
    pinv = np.linalg.inv(proj).astype(np.float32)
    rinv = np.stack([j_lookat(pos)[:3, :3].T,
                     j_lookat(-pos)[:3, :3].T]).astype(np.float32)
    got = get_view_dir_map((6, 5), _t(pinv), _t(rinv))
    want = j_view_dir((6, 5), jnp.asarray(pinv), jnp.asarray(rinv))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(
        get_reflect_dir(got[0], _t(nm)).numpy(),
        np.asarray(j_reflect(want[0], jnp.asarray(nm))), rtol=0, atol=1e-5)


def _jax_mesh(mesh):
    return jg.make_mesh_buffers(mesh)


def _views(s, idx):
    ring = camera_ring(s)
    return {k: np.stack([ring[i][k] for i in idx]) for k in ring[0]}


def _shared_edge(v, fa, fb, faces):
    """Faces fa and fb share two corners (compared by position: the UV
    sphere repeats its seam and pole vertices)."""
    pa = {tuple(v[i]) for i in faces[fa]}
    pb = {tuple(v[i]) for i in faces[fb]}
    return len(pa & pb) >= 2


def _f64_weights(faces, fim: np.ndarray, s: int):
    """The witness: rnr_tpu's weight expressions in float64 from f32 faces
    [N, F, 3, 3] (NDC) at the winners fim [N, S, S] (image orientation).
    Returns the clamped weights, the perspective-corrected weights (both
    [N, S, S, 3]) and u * M per pixel [N, S, S]."""
    f = np.asarray(faces, np.float64)
    fp = f[np.arange(f.shape[0])[:, None, None],
           np.clip(fim, 0, f.shape[1] - 1)]                  # [N, S, S, 3, 3]
    p = 0.5 * (fp[..., :2] * s + s - 1)
    x0, y0 = p[..., 0, 0], p[..., 0, 1]
    x1, y1 = p[..., 1, 0], p[..., 1, 1]
    x2, y2 = p[..., 2, 0], p[..., 2, 1]
    adj = np.stack([y1 - y2, x2 - x1, x1 * y2 - x2 * y1,
                    y2 - y0, x0 - x2, x2 * y0 - x0 * y2,
                    y0 - y1, x1 - x0, x0 * y1 - x1 * y0], -1)
    den = x2 * (y0 - y1) + x0 * (y1 - y2) + x1 * (y2 - y0)
    finv = adj.reshape(p.shape[:-2] + (3, 3)) / den[..., None, None]
    xi = np.arange(s, dtype=np.float64)[None, None, :, None]
    yi = (s - 1) - np.arange(s, dtype=np.float64)[None, :, None, None]
    terms = (finv[..., :, 0] * xi, finv[..., :, 1] * yi, finv[..., :, 2])
    u_m = 2.0 ** -24 * sum(np.abs(t) for t in terms).max(-1)
    u_m = np.where(fim >= 0, u_m, 0.0)
    w = np.clip(sum(terms), 0.0, 1.0)
    w = w / w.sum(-1, keepdims=True)
    q = w / fp[..., 2]
    return w, q / q.sum(-1, keepdims=True), u_m


def _witness(got_w, want_w, w64_got, w64_want, u_m, mask):
    """Both sides' weights within WITNESS_K u M of their float64
    evaluation, the port's worst no more than WITNESS_MARGIN units past
    rnr_tpu's."""
    e_got = (np.abs(got_w - w64_got).max(-1)[mask] / u_m[mask]).max()
    e_want = (np.abs(want_w - w64_want).max(-1)[mask] / u_m[mask]).max()
    assert e_want <= WITNESS_K and e_got <= WITNESS_K, (e_got, e_want)
    assert e_got <= e_want + WITNESS_MARGIN, (e_got, e_want)


def _hold_maps(got: dict, want: dict, agree: np.ndarray, u_m: np.ndarray):
    s = agree.shape[-1]
    for k, w in want.items():
        w = np.asarray(w).astype(np.float64)
        g = got[k].double().numpy()
        assert g.shape == w.shape, k
        if k in ("face_index_map", "alpha_map", "v_front_mask"):
            continue
        d = np.abs(g - w)
        tol = FINE_TOL if k in FINE_KEYS else MAP_TOL
        if k == "v_uvz":      # pixel units, up to S; per vertex
            assert d.max() <= MAP_TOL * s, (k, d.max())
            continue
        d = d.reshape(agree.shape + (-1,)).max(-1)[agree]
        limit = np.minimum(np.maximum(tol, WITNESS_K * u_m[agree]), WORST_TOL)
        worst = int(np.argmax(d - limit))
        assert (d <= limit).all(), (k, d[worst], limit[worst])


def test_render_gbuffer_matches_jax():
    """Two views of the 12x16 sphere at 64^2 in one batch: the port's
    `backend="auto"` (K7's plain version) against rnr_tpu's oracle."""
    s = 64
    mesh = sphere_mesh(12, 16)
    vw = _views(s, (0, 3))
    args = [vw["proj"], vw["pose"], vw["dist_coeffs"]]
    want = jg.render_gbuffer(_jax_mesh(mesh), *map(jnp.asarray, args), None,
                             None, s, backend="xla")
    got = tg.render_gbuffer(tg.make_mesh_buffers(mesh, "cpu"),
                            *map(_t, args), None, None, s)
    assert set(got) == set(want) | {"raster_overflow"}
    assert got["raster_overflow"].tolist() == [0, 0]
    fg = got["face_index_map"].numpy()
    fw = np.asarray(want["face_index_map"])
    agree = fg == fw
    assert agree.mean() >= 0.999 and 0.3 < (fg >= 0).mean() < 0.9
    for n, y, x in np.argwhere(~agree):
        assert fg[n, y, x] >= 0 and fw[n, y, x] >= 0
        assert _shared_edge(mesh.v, fg[n, y, x], fw[n, y, x], mesh.f_v_idx)
    np.testing.assert_array_equal(got["alpha_map"].numpy(),
                                  np.asarray(want["alpha_map"]))
    np.testing.assert_array_equal(got["v_front_mask"].numpy(),
                                  np.asarray(want["v_front_mask"]))

    faces_got = tg.project_faces(tg.make_mesh_buffers(mesh, "cpu"),
                                 *map(_t, args), None, None, s)[1]
    faces_want = jax.jit(lambda *a: jg._project_and_raster(
        _jax_mesh(mesh), *a, None, None, s, 0.0, 1e5, 128, "xla")[1])(
            *map(jnp.asarray, args))
    _, w64_got, u_m = _f64_weights(faces_got.numpy(), fg, s)
    _, w64_want, _ = _f64_weights(faces_want, fg, s)
    _witness(got["weight_map"].numpy()[..., 0],
             np.asarray(want["weight_map"])[..., 0], w64_got, w64_want, u_m,
             agree & (fg >= 0))
    _hold_maps(got, want, agree, u_m)


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_render_raster_matches_jax(backend):
    _raster_check(64, backend, "pallas_interpret" if backend == "auto"
                  else "xla")


@pytest.mark.parametrize("s", [37, 131, 200])
def test_render_raster_at_any_size_matches_the_oracle(s):
    """At frame sizes 32 x 128 does not divide (37: one tile cut to 37 x
    37; 131: 5 x 2 tiles, the last row and column 3 pixels; 200: 7 x 2
    tiles), the G-buffer path on K7's plain version with partial edge
    tiles against rnr_tpu's render_raster on its exact oracle: face
    index equal, depth and weights as in test_render_raster_matches_jax."""
    _raster_check(s, "auto", "xla")


def _raster_check(s, backend, jax_backend):
    mesh = sphere_mesh(12, 16)
    view = camera_ring(s)[7]
    want = jdrv._gbuffer(jg.render_raster, _jax_mesh(mesh), view, s,
                         backend=jax_backend)
    got = _gbuffer(tg.render_raster, tg.make_mesh_buffers(mesh, "cpu"), view,
                   s, backend=backend)
    fim = got.face_index_map.numpy()
    np.testing.assert_array_equal(fim, np.asarray(want.face_index_map))
    # against rnr_tpu's oracle K7's depth is another expression's, a few
    # f32 roundings off (ROADMAP.md's documented deltas; no map reads it)
    np.testing.assert_allclose(got.depth_map.numpy(),
                               np.asarray(want.depth_map),
                               rtol=1e-5 if backend == "xla"
                               or jax_backend != "xla" else 1e-4)

    cam = [view[k][None] for k in ("proj", "pose", "dist_coeffs")]
    faces_got = tg.project_faces(tg.make_mesh_buffers(mesh, "cpu"),
                                 *map(_t, cam), None, None, s)[1]
    faces_want = jax.jit(lambda *a: jg._project_and_raster(
        _jax_mesh(mesh), *a, None, None, s, 0.0, 1e5, 128, "xla")[1])(
            *map(jnp.asarray, cam))
    w64_got, _, u_m = _f64_weights(faces_got.numpy(), fim, s)
    w64_want, _, _ = _f64_weights(faces_want, fim, s)
    got_w, want_w = got.weight_map.numpy(), np.asarray(want.weight_map)
    _witness(got_w, want_w, w64_got, w64_want, u_m, fim >= 0)
    d = np.abs(got_w - want_w).max(-1)
    limit = np.minimum(np.maximum(MAP_TOL, WITNESS_K * u_m), WORST_TOL)
    assert (d <= limit).all(), float((d - limit).max())
    if backend == "xla":
        assert got.overflow is None and want.overflow is None
    elif want.overflow is None:    # rnr_tpu's oracle: K7 dropped nothing
        assert int(got.overflow.sum()) == 0
    else:
        assert got.overflow.tolist() == np.asarray(want.overflow).tolist()
    with pytest.raises(ValueError):
        _gbuffer(tg.render_raster, tg.make_mesh_buffers(mesh, "cpu"), view,
                 s, backend="pallas")


def test_reconcile_sh_bands():
    c = torch.arange(2 * 4 * 3, dtype=torch.float32).reshape(2, 4, 3)
    got = _reconcile_sh_bands(c, 9)
    want = jdrv._reconcile_sh_bands(jnp.asarray(c.numpy()), 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(_reconcile_sh_bands(c, 2).numpy(),
                                  c[:, :2].numpy())


def test_mesh_to_image_matches_jax():
    """The slice as a whole, in f32: the 12x16 sphere -> `_gbuffer` ->
    `_to_batch` -> the eval step of the SMALL model (JAX weights carried
    over), against rnr_tpu's render_gbuffer (its tile-binned rasterizer,
    in interpret mode) -> _to_batch -> make_rnr_eval_step.  Each side
    computes its own v_feature."""
    s = SMALL["img_size"]
    jm, variables, tm, batch = _models("float32", "float32")
    mesh = sphere_mesh(12, 16)
    view = camera_ring(s)[3]
    gcn_pos = np.array(batch["gcn_pos"])

    jgb = jdrv._gbuffer(jg.render_gbuffer, _jax_mesh(mesh), view, s,
                        backend="pallas_interpret")
    jbatch = jdrv._to_batch(jgb, gcn_pos)
    jvf = jax.jit(lambda v, p: jm.apply(
        v, p, method=lambda m, p_: m.compute_v_feature(p_)))(
            variables, jbatch["gcn_pos"])
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       constants=variables.get("constants", {}),
                       spectral=variables.get("spectral", {}), opt_state=None)
    jimg = np.asarray(j_eval_step(jm)(state, jbatch, v_feature=jvf)["img"])

    tgb = _gbuffer(tg.render_gbuffer, tg.make_mesh_buffers(mesh, "cpu"), view,
                   s)
    tb = _to_batch(tgb, gcn_pos)
    assert set(tb) == set(jbatch)
    with torch.inference_mode():
        tvf = tm.compute_v_feature(tb["gcn_pos"])
    timg = make_rnr_eval_step(tm)(tb, v_feature=tvf)["img"].numpy()

    np.testing.assert_array_equal(tgb["face_index_map"].numpy(),
                                  np.asarray(jgb["face_index_map"]))
    inside = np.asarray(jgb["alpha_map"])[0] > 0
    assert 0.3 < inside.mean() < 0.9
    assert float(np.std(jimg[0][inside])) > 1e-3   # not a flat frame
    scale = float(np.abs(jimg).max())
    np.testing.assert_allclose(timg, jimg, rtol=0, atol=1e-4 * scale)
