"""The port's off-path modules against rnr_tpu's: the NumPy camera
helpers (ops/cameras.py), the per-pixel TBN (ops/tbn.py), the NumPy
bilinear twin (ops/interpolate.py), the 3D U-Net and the image down /
upsampling stacks (models/unet3d.py) and the edge-list graph convs
(models/gcn_sparse.py), as tests/test_misc_additions.py holds rnr_tpu's.
NumPy helpers equal bit for bit (the same NumPy code), the torch modules
in f32 to 1e-5 of the largest value (the flax weights loaded by
`rnr_tpu_torch.convert`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnr_tpu.models import gcn_sparse as jgs
from rnr_tpu.models import unet3d as ju3
from rnr_tpu.ops import cameras as jcam
from rnr_tpu.ops.interpolate import interpolate_bilinear_np as jax_bilinear_np
from rnr_tpu.ops.tbn import get_tbn_map_perpixel as jax_tbn_perpixel
from rnr_tpu_torch.convert import load_jax_variables
from rnr_tpu_torch.models import gcn_sparse as tgs
from rnr_tpu_torch.models import unet3d as tu3
from rnr_tpu_torch.ops import cameras as tcam
from rnr_tpu_torch.ops.interpolate import interpolate_bilinear_np
from rnr_tpu_torch.ops.tbn import get_tbn_map_perpixel

torch.set_num_threads(2)


def _poses(rng, n=6):
    return [tcam.rt_from_pos_lookat(rng.standard_normal(3) * 2.0 + 0.1)
            for _ in range(n)]


CAMERA_CASES = {
    "get_spiral": lambda m, rng: m.get_spiral(-3.0, 0.5),
    "get_archimedean_spiral": lambda m, rng: m.get_archimedean_spiral(
        2.5, np.array([0.1, -0.2, 0.3]), num_step=50),
    "interpolate_views": lambda m, rng: m.interpolate_views(
        *_poses(rng, 2), num_steps=7),
    "get_nn_ranking": lambda m, rng: m.get_nn_ranking(_poses(rng)),
    "az_el_to_rot": lambda m, rng: [m.az_el_to_rot(a, e) for a, e in
                                    rng.uniform(-180, 180, (5, 2))],
    "rand_euler_rotation_matrix": lambda m, rng: m.rand_euler_rotation_matrix(
        15.0, rng),
    "rot_mag": lambda m, rng: [m.rot_mag(m.euler_to_rot(t)) for t in
                               rng.uniform(-1, 1, (5, 3))],
    "quat2rot": lambda m, rng: [m.quat2rot(q) for q in
                                list(rng.standard_normal((5, 4)))
                                + [np.zeros(4)]],
    "rot2quat": lambda m, rng: [m.rot2quat(m.euler_to_rot(t)) for t in
                                rng.uniform(-np.pi, np.pi, (20, 3))],
}


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [a for e in x for a in _flat(e)]
    return [np.asarray(x)]


@pytest.mark.parametrize("name", sorted(CAMERA_CASES))
def test_camera_helpers_equal_rnr_tpu(name):
    want = _flat(CAMERA_CASES[name](jcam, np.random.default_rng(1)))
    got = _flat(CAMERA_CASES[name](tcam, np.random.default_rng(1)))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_quat_rot_roundtrip():
    rng = np.random.default_rng(3)
    for t in rng.uniform(-np.pi, np.pi, (20, 3)):
        r = tcam.euler_to_rot(t)
        q = tcam.rot2quat(r)
        np.testing.assert_allclose(tcam.quat2rot(q), r, atol=1e-8)
        assert abs(np.linalg.norm(q) - 1.0) < 1e-8


def test_interpolate_bilinear_np_equals_rnr_tpu():
    rng = np.random.default_rng(5)
    data = rng.standard_normal((9, 7, 4)).astype(np.float32)
    # inside, on the edges and beyond them (clamped corners)
    x = rng.uniform(-1.0, 7.5, (3, 11)).astype(np.float32)
    y = rng.uniform(-1.0, 9.5, (3, 11)).astype(np.float32)
    np.testing.assert_array_equal(interpolate_bilinear_np(data, x, y),
                                  jax_bilinear_np(data, x, y))


def test_tbn_perpixel_matches_rnr_tpu():
    rng = np.random.default_rng(2)
    n, s = 2, 12
    normal = rng.standard_normal((n, s, s, 3)).astype(np.float32)
    pos = np.cumsum(rng.uniform(0.1, 1, (n, s, s, 3)), axis=2).astype(
        np.float32)
    uv = np.cumsum(rng.uniform(0.1, 1, (n, s, s, 2)), axis=1).astype(
        np.float32)
    uv[0, 3, 4] = uv[0, 3, 5]                     # a zero determinant
    alpha = (rng.uniform(size=(n, s, s, 1)) > 0.3).astype(np.float32)
    want = np.asarray(jax_tbn_perpixel(*map(jnp.asarray,
                                            (normal, pos, uv, alpha))))
    got = get_tbn_map_perpixel(*map(torch.from_numpy,
                                    (normal, pos, uv, alpha))).numpy()
    assert got.shape == (n, s, s, 3, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_tbn_perpixel_plane():
    """A plane with uv = xy: tangent +x, bitangent +y inside."""
    s = 8
    ys, xs = np.mgrid[0:s, 0:s].astype(np.float32) / s
    pos = np.stack([xs, ys, np.zeros_like(xs)], -1)[None]
    uv = np.stack([xs, ys], -1)[None]
    normal = np.broadcast_to(np.float32([0, 0, 1]), (1, s, s, 3)).copy()
    tbn = get_tbn_map_perpixel(*map(torch.from_numpy, (
        normal, pos, uv, np.ones((1, s, s, 1), np.float32)))).numpy()
    inner = tbn[0, 2:-2, 2:-2]
    np.testing.assert_allclose(inner[..., 0], np.broadcast_to(
        [1, 0, 0], inner[..., 0].shape), atol=1e-4)
    np.testing.assert_allclose(inner[..., 1], np.broadcast_to(
        [0, 1, 0], inner[..., 1].shape), atol=1e-4)


def flax_params(module, *args, seed: int = 1, **kw) -> dict:
    """A flax module's params without compiling its init: the shapes by
    jax.eval_shape, the values of flax's default initialisers in kind
    (kernels lecun-normal, untruncated; norm scales one; the rest zero)
    plus 0.1 of a standard normal, all drawn by NumPy from `seed`."""
    shapes = jax.eval_shape(lambda k: module.init(k, *args, **kw),
                            jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            a = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        else:
            a = np.full(s.shape, 1.0 if name == "scale" else 0.0)
        return (a + 0.1 * rng.standard_normal(s.shape)).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _against_flax(jmod, tmod, x, **apply_kw):
    """The flax module's params from flax_params, its apply jitted (op by
    op, flax compiles every op)."""
    params = flax_params(jmod, jnp.asarray(x), **apply_kw)
    want = np.asarray(jax.jit(lambda p, x_: jmod.apply(
        {"params": p}, x_, **apply_kw))(params, jnp.asarray(x)))
    load_jax_variables(tmod, {"params": params})
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("norm, outermost_linear", [("batch", False),
                                                    ("group", True),
                                                    ("none", False)])
def test_unet3d_matches_rnr_tpu(norm, outermost_linear):
    x = np.random.default_rng(0).standard_normal((2, 8, 8, 8, 3)).astype(
        np.float32)
    kw = dict(in_channels=3, out_channels=4, nf0=16, num_down=2,
              max_channels=32, norm=norm, outermost_linear=outermost_linear)
    _against_flax(ju3.Unet3d(**kw), tu3.Unet3d(**kw), x)


def test_sampling_nets_match_rnr_tpu():
    x = np.random.default_rng(0).standard_normal((2, 16, 16, 4)).astype(
        np.float32)
    _against_flax(ju3.DownsamplingNet([8, 16], last_layer_one=True),
                  tu3.DownsamplingNet(4, [8, 16], last_layer_one=True), x,
                  train=False)
    d = np.random.default_rng(1).standard_normal((2, 4, 4, 16)).astype(
        np.float32)
    _against_flax(ju3.UpsamplingNet([8, 4], first_layer_one=True),
                  tu3.UpsamplingNet(16, [8, 4], first_layer_one=True), d,
                  train=False)


@pytest.mark.parametrize("conv_type", ["edge", "mr"])
def test_sparse_gcn_matches_rnr_tpu(conv_type):
    x = np.random.default_rng(4).standard_normal((60, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        tgs.knn_edges(torch.from_numpy(x), 5).numpy(),
        np.asarray(jgs.knn_edges(jnp.asarray(x), 5)))
    _against_flax(jgs.SparseResDynBlock(8, 5, conv_type),
                  tgs.SparseResDynBlock(8, 5, conv_type), x)


def test_segment_max_of_an_empty_segment_is_minus_inf():
    data = torch.tensor([[1.0, -2.0], [3.0, 0.5]])
    out = tgs.segment_max(data, torch.tensor([0, 0]), 2)
    np.testing.assert_array_equal(out.numpy(), [[3.0, 0.5],
                                                [-np.inf, -np.inf]])
    want = jax.ops.segment_max(jnp.asarray(data.numpy()),
                               jnp.asarray([0, 0]), num_segments=2)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
