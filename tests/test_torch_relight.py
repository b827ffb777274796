"""Port parity of novel-light relighting vs rnr_tpu: the spherical maps,
the lighting models (SH fit, probe reconstruction, LightingLP), the ray
sampler with probe UVs, the probe-gather render, the K5 plain version
(unfused SH shading) against rnr_tpu's Pallas sh_shade in interpret mode,
and whole frames from a mesh under each relighting route of
rnr_tpu's test_rnr: probe gather, fit_sh SH coefficients (fan-fused), and
the unfused SH shading with both fan constructions.

Inputs are made with NumPy from a seed and handed to both packages; the
model weights are the JAX init of test_torch_slice.py's SMALL config
(random SH coefficients and textures), converted.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import rnr_tpu.drivers.test_rnr as jdrv
import rnr_tpu.ops.gbuffer as jg
from rnr_tpu.models.lighting import LightingLP as JaxLightingLP
from rnr_tpu.models.lighting import LightingSH as JaxLightingSH
from rnr_tpu.models.lighting import normalize_lighting_coeff as jax_normalize
from rnr_tpu.models.rays import RaySampler as JaxRaySampler
from rnr_tpu.models.rays import ray_render as jax_ray_render
from rnr_tpu.models.rnr import RNRModel as JaxRNRModel
from rnr_tpu.ops import spherical as jsph
from rnr_tpu.ops.interpolate import interpolate_bilinear as jax_bilinear
from rnr_tpu.ops.interpolate import (interpolate_bilinear_batch as
                                     jax_bilinear_batch)
from rnr_tpu.ops.sh import evaluate_sh_basis as jax_basis
from rnr_tpu.ops.sh import fit_sh_coeff as jax_fit_sh
from rnr_tpu.ops.sh_pallas import sh_shade as jax_sh_shade
from rnr_tpu.train.steps import TrainState
from rnr_tpu.train.steps import make_rnr_eval_step as j_eval_step
from rnr_tpu_torch.config import RNRConfig
from rnr_tpu_torch.convert import load_jax_variables
from rnr_tpu_torch.drivers.test_rnr import (_gbuffer, _to_batch, lightings,
                                            lp_background, relit_frame)
from rnr_tpu_torch.models.lighting import (LightingLP, LightingSH,
                                           normalize_lighting_coeff)
from rnr_tpu_torch.models.rays import (RaySampler, build_fan_channels,
                                       ray_render)
from rnr_tpu_torch.models.rnr import RNRModel
from rnr_tpu_torch.models.unet import remat_mode
from rnr_tpu_torch.ops import spherical as tsph
from rnr_tpu_torch.ops.gbuffer import make_mesh_buffers, render_gbuffer
from rnr_tpu_torch.ops.interpolate import interpolate_bilinear_batch
from rnr_tpu_torch.ops.sh import fit_sh_coeff
from rnr_tpu_torch.ops.sh_cuda import (sh_shade, sh_shade_bwd,
                                       sh_shade_bwd_torch, sh_shade_torch)
from rnr_tpu_torch.synthetic import (build_batch, camera_ring, make_probes,
                                     sphere_mesh)
from rnr_tpu_torch.train.steps import make_rnr_eval_step
from test_torch_gbuffer import _jax_mesh
from test_torch_slice import SMALL, _models

torch.set_num_threads(2)


def _max(a) -> float:
    return float(np.abs(np.asarray(a, np.float32)).max())


def _unit(rng, shape):
    d = rng.standard_normal(shape + (3,))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _seam_dirs(rng, n: int) -> np.ndarray:
    """[3, n + 8] directions: random ones, then the seam of u (x < 0,
    z = +0 and -0), the poles, and y just beyond +-1."""
    d = _unit(rng, (n,)).T
    extra = np.array([[-1, 0, 0], [-0.6, 0.8, 0], [-0.6, -0.8, -0.0],
                      [0, 1, 0], [0, -1, 0], [1, 0, 0],
                      [0, 1.0000001, 0], [0, -1.0000001, 0]],
                     np.float32).T
    extra[2, 2] = -0.0
    return np.concatenate([d, extra], axis=1)


# ------------------------------------------------------------ spherical maps


def test_spherical_mapping_and_batch_match_jax():
    rng = np.random.default_rng(0)
    d = _seam_dirs(rng, 300)
    got = tsph.spherical_mapping(torch.from_numpy(d)).numpy()
    want = np.asarray(jsph.spherical_mapping(jnp.asarray(d)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got[0, -6] == want[0, -6] and got[0, -6] < 0.01   # z = -0: u = 0
    db = np.stack([d, d[:, ::-1]])[..., None]                # [2, 3, S, 1]
    got = tsph.spherical_mapping_batch(torch.from_numpy(db.copy())).numpy()
    want = np.asarray(jsph.spherical_mapping_batch(jnp.asarray(db)))
    assert got.shape == (2, 2, d.shape[1], 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_spherical_mapping_inv_matches_jax_at_seam_and_poles():
    u = np.concatenate([np.linspace(0, 1, 33), [0.0, 1.0, 0.5]])
    v = np.concatenate([np.linspace(0, 1, 33), [0.5, 0.5, 0.0]])
    uv = np.stack(np.meshgrid(u, v)).reshape(2, -1).astype(np.float32)
    got = tsph.spherical_mapping_inv(torch.from_numpy(uv)).numpy()
    want = np.asarray(jsph.spherical_mapping_inv(jnp.asarray(uv)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the seam sign fix-up: z of u = 0 and u = 1 (about -+8.7e-8, the
    # f32 sine of -+pi) takes rnr_tpu's sign
    seam = np.isin(uv[0], (0.0, 1.0)) & (uv[1] == 0.5)
    assert np.all(np.abs(got[2, seam]) < 1e-6)
    np.testing.assert_array_equal(np.sign(got[2, seam]),
                                  np.sign(want[2, seam]))


def test_sph_cart_and_light_dirs_match_jax():
    rng = np.random.default_rng(1)
    x, y, z = rng.standard_normal((3, 50)).astype(np.float32)
    for g, w in zip(tsph.cart2sph(*map(torch.from_numpy, (x, y, z))),
                    jsph.cart2sph(*map(jnp.asarray, (x, y, z)))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-6)
    a, e, r = rng.uniform(-3, 3, (3, 50)).astype(np.float32)
    for g, w in zip(tsph.sph2cart(*map(torch.from_numpy, (a, e, r))),
                    jsph.sph2cart(*map(jnp.asarray, (a, e, r)))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-6)
    azi = np.arange(0, 360, 30, dtype=np.float32)
    pol = np.arange(0, 181, 20, dtype=np.float32)
    for g, w in zip(tsph.sample_light_dir(torch.from_numpy(azi),
                                          torch.from_numpy(pol)),
                    jsph.sample_light_dir(jnp.asarray(azi), jnp.asarray(pol))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


# ------------------------------------------------------------ lighting


def test_fit_sh_coeff_matches_jax():
    rng = np.random.default_rng(2)
    d = _unit(rng, (200,))
    basis = np.array(jax_basis(4, jnp.asarray(d)))
    for shape in ((200, 3), (2, 200, 3)):
        s = rng.standard_normal(shape).astype(np.float32)
        want = np.asarray(jax_fit_sh(jnp.asarray(s), jnp.asarray(basis)))
        got = fit_sh_coeff(torch.from_numpy(s), torch.from_numpy(basis))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * _max(want))


def _jax_lp(l_dir, probes):
    jm = JaxLightingLP(l_dir=l_dir, lps=probes)
    return jm, jax.device_get(jm.init(jax.random.PRNGKey(0)))


def test_lighting_lp_matches_jax():
    """LightingLP: the samples from each probe's bilinear lookup (probes
    with suns on the u seam), fit_sh, is_lp, and the converter carrying
    l_samples and the probes."""
    l_dir = graft._fib_sphere(256)
    probes = make_probes(2, 32, 64, seed=3)
    jm, jv = _jax_lp(l_dir, probes)
    tm = LightingLP(l_dir, lps=probes, device="cpu")
    want = np.asarray(jv["params"]["l_samples"])
    np.testing.assert_allclose(tm.l_samples.detach().numpy(), want, rtol=0,
                               atol=1e-5 * _max(want))
    assert _max(want) > 2.0                             # a sun was sampled
    for lmax in (2, 4):
        w = np.asarray(jm.apply(jv, method=lambda m: m.fit_sh(lmax)))
        g = tm.fit_sh(lmax).detach().numpy()
        assert g.shape == (2, (lmax + 1) ** 2, 3)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * _max(w))
    np.testing.assert_array_equal(tm(1, is_lp=True).numpy(),
                                  np.asarray(jm.apply(jv, 1, True)))
    np.testing.assert_allclose(tm(0).detach().numpy(),
                               np.asarray(jm.apply(jv, 0)), rtol=0,
                               atol=1e-5 * _max(want))
    # the converter: l_samples (a parameter) and lps (a constant)
    other = LightingLP(l_dir, lps=np.zeros_like(probes), device="cpu")
    load_jax_variables(other, jv)
    assert torch.equal(other.lps, torch.from_numpy(probes))
    np.testing.assert_array_equal(other.l_samples.detach().numpy(), want)
    with pytest.raises(ValueError, match="no light probes"):
        LightingLP(l_dir, num_lighting=2, device="cpu")(0, is_lp=True)


def test_lighting_sh_reconstruct_lp_matches_jax():
    """LightingSH's probe grid (basis_val_recon), reconstruct_lp, is_lp
    for one and for all lightings, and samples from a given coeff."""
    rng = np.random.default_rng(4)
    l_dir = graft._fib_sphere(128)
    init = (0.3 * rng.standard_normal((3, 25, 3))).astype(np.float32)
    jm = JaxLightingSH(l_dir=l_dir, lmax=4, num_lighting=3, init_coeff=init,
                       lp_recon_h=16, lp_recon_w=32)
    jv = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tm = LightingSH(l_dir, 4, 3, 3, lp_recon_h=16, lp_recon_w=32,
                    init_coeff=init)
    want = jv["constants"]["basis_val_recon"]
    np.testing.assert_allclose(tm.basis_val_recon.numpy(), want, rtol=0,
                               atol=2e-6)
    load_jax_variables(tm, jv)          # holds both basis caches to JAX's
    coeff = (0.5 * rng.standard_normal((25, 3))).astype(np.float32)
    cases = [((1,), dict(is_lp=True)), ((None,), dict(is_lp=True)),
             ((2,), {}), ((None,), dict(coeff=coeff)),
             ((None,), dict(coeff=coeff, is_lp=True))]
    for args, kw in cases:
        w = np.asarray(jm.apply(jv, *args, **{
            k: (jnp.asarray(v) if k == "coeff" else v)
            for k, v in kw.items()}))
        g = tm(*args, **{k: (torch.from_numpy(v) if k == "coeff" else v)
                         for k, v in kw.items()}).detach().numpy()
        assert g.shape == w.shape, (args, kw)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * _max(w))


def test_normalize_lighting_coeff_matches_jax():
    rng = np.random.default_rng(5)
    c = rng.standard_normal((4, 9, 3)).astype(np.float32)
    c[2] *= 5.0
    for ref in (0, 2):
        want = np.asarray(jax_normalize(jnp.asarray(c), ref))
        got = normalize_lighting_coeff(torch.from_numpy(c), ref).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * _max(want))
        np.testing.assert_array_equal(got[ref], c[ref])


# ------------------------------------------------------------ rays


def test_interpolate_bilinear_batch_masked_rays_are_zero():
    rng = np.random.default_rng(6)
    data = rng.uniform(0.5, 2, (2, 8, 16, 3)).astype(np.float32)
    x = rng.uniform(-1, 16, (2, 5, 7)).astype(np.float32)
    y = rng.uniform(-1, 8, (2, 5, 7)).astype(np.float32)
    x[:, 0], y[:, 0] = -16.0, -8.0                    # uv = -1: masked
    for d in (data, data[:1]):
        want = np.asarray(jax_bilinear_batch(jnp.asarray(d), jnp.asarray(x),
                                             jnp.asarray(y)))
        got = interpolate_bilinear_batch(
            torch.from_numpy(d), torch.from_numpy(x),
            torch.from_numpy(y)).numpy()
        assert got.shape == (2, 5, 7, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert np.all(got[:, 0] == 0.0)


def _ray_inputs(rng, size):
    b = build_batch(size, 64)
    vdt = _unit(rng, (1, size, size))
    return b["TBN_map"], vdt, b["alpha_map"]


@pytest.mark.parametrize("mode,interval", [("reflect", 5.0),
                                           ("diffuse", 10.0)])
def test_ray_sampler_with_uv_matches_jax(mode, interval):
    tbn, vdt, alpha = _ray_inputs(np.random.default_rng(7), 16)
    js = JaxRaySampler(5, 1, interval, mode)
    jd, juv, jt = js(jnp.asarray(tbn), jnp.asarray(vdt), jnp.asarray(alpha))
    ts = RaySampler(5, 1, interval, mode)
    td, tuv, tt = ts(torch.from_numpy(tbn), torch.from_numpy(vdt),
                     torch.from_numpy(alpha))
    assert tuv.shape == (1, 16, 16, 2, 6)
    for g, w in ((td, jd), (tuv, juv), (tt, jt)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-6)
    masked = alpha[..., 0] == 0
    assert masked.any() and np.all(tuv.numpy()[masked] == -1.0)
    nd, nuv, _ = ts(torch.from_numpy(tbn), torch.from_numpy(vdt),
                    torch.from_numpy(alpha), with_uv=False)
    assert nuv is None and torch.equal(nd, td)


@pytest.mark.parametrize("shared_probe", [True, False])
def test_ray_render_matches_jax_with_its_backward(shared_probe):
    """The probe gather and fan means (values to 1e-5 of max), and the
    VJP into the probe and rays_lt (the scatter of the probe path's
    backward); masked rays (uv = -1) gather 0."""
    rng = np.random.default_rng(8 + shared_probe)
    n, s, r, r_diff = 2, 6, 7, 3
    uv = rng.uniform(-0.05, 1.05, (n, s, s, 2, r)).astype(np.float32)
    uv[:, 0] = -1.0
    lt = rng.uniform(0, 2, (n, s, s, r, 3)).astype(np.float32)
    alb = rng.uniform(0, 1, (2, n, s, s, 3)).astype(np.float32)
    lp = make_probes(1 if shared_probe else n, 8, 16, seed=9)
    kw = dict(num_ray_diffuse=r_diff, separate_albedo=True)

    def jfun(lt_, lp_):
        return jax_ray_render(jnp.asarray(alb[0]), jnp.asarray(uv), lt_, lp_,
                              albedo_diffuse=jnp.asarray(alb[1]), **kw)

    jout, jvjp = jax.vjp(lambda a, b: jfun(a, b)["out"], jnp.asarray(lt),
                         jnp.asarray(lp))
    jout = jfun(jnp.asarray(lt), jnp.asarray(lp))
    g = rng.standard_normal(jout["out"].shape).astype(np.float32)
    jg_lt, jg_lp = jvjp(jnp.asarray(g))
    tlt = torch.from_numpy(lt).requires_grad_()
    tlp = torch.from_numpy(lp).requires_grad_()
    tout = ray_render(torch.from_numpy(alb[0]), torch.from_numpy(uv), tlt,
                      tlp, albedo_diffuse=torch.from_numpy(alb[1]), **kw)
    tout["out"].backward(torch.from_numpy(g))
    for k in ("out", "out_specular", "out_diffuse", "ltt_specular_map",
              "ltt_diffuse_map", "rays_color", "lp"):
        w = np.asarray(jout[k])
        np.testing.assert_allclose(tout[k].detach().numpy(), w, rtol=0,
                                   atol=1e-5 * _max(w), err_msg=k)
    assert np.all(tout["rays_color"].detach().numpy()[:, 0] == 0.0)
    for got, want in ((tlt.grad, jg_lt), (tlp.grad, jg_lp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5 * _max(want))


# ------------------------------------------------------------ K5 plain version


def _shade_inputs(rng, size, lmax, dtype):
    """rays_dir from the fan builder (zero directions at the masked
    pixels of the synthetic G-buffer), rays_lt, alpha, coeff, R = 6 + 5."""
    b = build_batch(size, 64)
    spec, diff = RaySampler(5, 1, 5.0, "reflect"), RaySampler(2, 2, 10.0,
                                                              "diffuse")
    piv = np.concatenate([spec.pivots_dir.T, diff.pivots_dir.T]
                         ).astype(np.float32)
    vdt = _unit(rng, (1, size, size))
    rd = build_fan_channels(*(torch.from_numpy(a) for a in (
        b["TBN_map"], vdt, b["alpha_map"], piv)), 6)[1].to(dtype)
    lt = torch.from_numpy(rng.uniform(0, 2, (1, size, size, 11, 3)).astype(
        np.float32)).to(dtype)
    cf = torch.from_numpy((0.5 * rng.standard_normal(((lmax + 1) ** 2, 3))
                           ).astype(np.float32))
    return rd, lt, torch.from_numpy(b["alpha_map"]), cf


def _j(t):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sh_shade_plain_matches_jax_interpret(dtype):
    """K5's plain version and its backward against rnr_tpu's sh_shade
    (Pallas, interpret mode) and its VJP, lmax 4, with masked pixels
    (zero directions, alpha 0) present: f32 to 1e-4 (the K1 tests'
    tolerance), d coeff to 1e-4 of max, d rays_lt in f32 to 1e-4 of max
    and in bf16 within one bf16 step of each value; the masked pixels
    give exactly 0, never NaN."""
    rng = np.random.default_rng(10)
    rd, lt, al, cf = _shade_inputs(rng, 16, 4, dtype)
    masked = al[..., 0] == 0
    assert bool(masked.any()) and bool((rd[masked] == 0).any())
    (js, jd), jvjp = jax.vjp(
        lambda lt_, cf_: jax_sh_shade(_j(rd), lt_, jnp.asarray(al.numpy()),
                                      cf_, 4, 6, True),
        _j(lt), jnp.asarray(cf.numpy()))
    ts, td = sh_shade(rd, lt, al, cf, 4, 6)
    assert sh_shade.launches == 0                      # CPU: plain version
    for g, w in ((ts, js), (td, jd)):
        assert _max(w) > 0.1
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4)
        assert bool(torch.isfinite(g).all()) and bool((g[masked] == 0).all())
    gs = rng.standard_normal(ts.shape).astype(np.float32)
    gd = rng.standard_normal(ts.shape).astype(np.float32)
    jlt, jcf = jvjp((jnp.asarray(gs), jnp.asarray(gd)))
    tlt, tcf = sh_shade_bwd(rd, lt, al, cf, torch.from_numpy(gs),
                            torch.from_numpy(gd), 4, 6)
    assert tlt.dtype == dtype and tcf.dtype == torch.float32
    np.testing.assert_allclose(tcf.numpy(), np.asarray(jcf), rtol=0,
                               atol=1e-4 * _max(jcf))
    want = np.asarray(jlt.astype(jnp.float32))
    got = tlt.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * _max(want))
    else:
        assert np.all(np.abs(got - want) <= 2 ** -7 * np.abs(want) + 1e-30)


@pytest.mark.parametrize("lmax", [2, 4, 10])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_scaled_ladder_matches_jax_interpret(lmax, dtype):
    """K5's arithmetic (the scaled ladder folded per order into
    fan_coeff's coefficients, test_torch_sh.k5_emulate in f32) on the fan's
    materialised rays, masked pixels included, against rnr_tpu's sh_shade
    (Pallas, interpret mode): within 1e-4 x max + 1e-5, as chip_smoke.py
    holds the kernel to its plain version; masked pixels exactly 0."""
    from test_torch_sh import k5_emulate
    rng = np.random.default_rng(20 + lmax)
    rd, lt, al, cf = _shade_inputs(rng, 16, lmax, dtype)
    masked = al[..., 0] == 0
    js, jd = jax_sh_shade(_j(rd), _j(lt), jnp.asarray(al.numpy()),
                          jnp.asarray(cf.numpy()), lmax, 6, True)
    for g, w in zip(k5_emulate(rd, lt, al, cf, lmax, 6, torch.float32),
                    (js, jd)):
        w = np.asarray(w)
        assert g.shape == w.shape and _max(w) > 0.1
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * _max(w) + 1e-5)
        assert bool((g[masked] == 0).all())


@pytest.mark.parametrize("lmax", [2, 4, 10])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5b_scaled_backward_matches_jax_interpret(lmax, dtype):
    """K5b's arithmetic (test_torch_sh.k5b_emulate in f32: the order split,
    T_9 and T_10 from the stored T_8, the per-order fold and d coeff summed
    per lane, lane and block) on the fan's materialised rays, masked
    pixels included, against jax.vjp of rnr_tpu's sh_shade (Pallas,
    interpret mode): d coeff within 1e-4 x max + 1e-5; d rays_lt in f32
    within 1e-4 x max + 1e-5 and in bf16 within 2^-7 x max, as
    chip_smoke.py holds the kernel to its plain version; masked pixels'
    d rays_lt exactly 0."""
    from test_torch_sh import k5b_emulate
    rng = np.random.default_rng(40 + lmax)
    rd, lt, al, cf = _shade_inputs(rng, 16, lmax, dtype)
    masked = al[..., 0] == 0
    assert bool(masked.any())
    _, jvjp = jax.vjp(
        lambda lt_, cf_: jax_sh_shade(_j(rd), lt_, jnp.asarray(al.numpy()),
                                      cf_, lmax, 6, True),
        _j(lt), jnp.asarray(cf.numpy()))
    gs, gd = (rng.standard_normal((1, 16, 16, 3)).astype(np.float32)
              for _ in range(2))
    jlt, jcf = jvjp((jnp.asarray(gs), jnp.asarray(gd)))
    tlt, tcf = k5b_emulate(rd, lt, al, cf, torch.from_numpy(gs),
                           torch.from_numpy(gd), lmax, 6, torch.float32)
    assert tlt.dtype == dtype and _max(jcf) > 0.1
    np.testing.assert_allclose(tcf.numpy(), np.asarray(jcf), rtol=0,
                               atol=1e-4 * _max(jcf) + 1e-5)
    want = np.asarray(jlt.astype(jnp.float32))
    got = tlt.float().numpy()
    tol = 1e-4 * _max(want) + 1e-5 if dtype == torch.float32 else (
        2 ** -7 * _max(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert bool((tlt[masked] == 0).all())


def test_sh_shade_autograd_runs_the_plain_backward_on_cpu():
    rng = np.random.default_rng(11)
    rd, lt, al, cf = _shade_inputs(rng, 8, 2, torch.bfloat16)
    lt.requires_grad_()
    cf.requires_grad_()
    s, d = sh_shade(rd, lt, al, cf, 2, 6)
    gs, gd = torch.randn_like(s), torch.randn_like(d)
    torch.autograd.backward((s, d), (gs, gd))
    wl, wc = sh_shade_bwd_torch(rd, lt.detach(), al, cf.detach(), gs, gd, 2,
                                6)
    assert torch.equal(lt.grad, wl) and torch.equal(cf.grad, wc)
    ps, pd = sh_shade_torch(rd, lt.detach(), al, cf.detach(), 2, 6)
    assert torch.equal(s.detach(), ps) and torch.equal(d.detach(), pd)
    assert sh_shade.launches == 0 and sh_shade_bwd.launches == 0


# ------------------------------------------------------------ whole frames


ROUTES = ("probe", "sh_fit", "unfused", "unfused_einsum")


@pytest.fixture(scope="module")
def relight_case():
    """The SMALL model on both sides, the 12x16 sphere's G-buffer from
    ring view 3 on both sides (rnr_tpu's rasterizer in interpret mode),
    each side's v_feature, and two 32 x 64 probes."""
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
    tgb = _gbuffer(render_gbuffer, make_mesh_buffers(mesh, "cpu"), view, s)
    tb = _to_batch(tgb, gcn_pos)
    with torch.inference_mode():
        tvf = tm.compute_v_feature(tb["gcn_pos"])
    return dict(jm=jm, variables=variables, tm=tm, jgb=jgb, jbatch=jbatch,
                jvf=jvf, tb=tb, tvf=tvf,
                probes=make_probes(2, 32, 64, seed=12),
                l_dir=graft._fib_sphere(SMALL["num_sample"]))


def _route_models(case, route):
    """(JAX model, port model) of a route: the shipped fan-fused
    configuration, or sh_fan_fuse=False with rnr_tpu's Pallas sh_shade in
    interpret mode (fan_impl elementwise or einsum)."""
    if route in ("probe", "sh_fit"):
        return case["jm"], case["tm"]
    jcfg = case["jm"].cfg
    jcfg = dataclasses.replace(jcfg, rays=dataclasses.replace(
        jcfg.rays, sh_fan_fuse=False, sh_kernel="pallas_interpret",
        fan_impl="einsum" if route == "unfused_einsum" else "elementwise"))
    jm = JaxRNRModel(cfg=jcfg, l_dir=case["l_dir"])
    tm = load_jax_variables(RNRModel(
        RNRConfig.from_dict(dataclasses.asdict(jcfg)), SMALL["gcn_v"],
        l_dir=case["l_dir"], device="cpu"), case["variables"])
    return jm, tm


def _jax_lightings(case, lp_sh: bool):
    """rnr_tpu test_rnr.main()'s list for novel probes (:218-238)."""
    probes = case["probes"]
    sh = None
    if lp_sh:
        lm, lv = _jax_lp(case["l_dir"], probes)
        lmax = case["jm"].cfg.lighting.sh_lmax
        sh = jdrv._reconcile_sh_bands(
            lm.apply(lv, method=lambda m: m.fit_sh(lmax)), (lmax + 1) ** 2)
    return [("novel%02d" % i, jnp.asarray(probes[i][None]),
             None if sh is None else sh[i]) for i in range(len(probes))]


def test_lightings_list_matches_jax(relight_case):
    """The driver's lighting list: novel probes fitted to SH (lmax 4 and,
    zero-padded, 2) or as probes, and the learned lightings as probes."""
    case = relight_case
    tm = case["tm"]
    for lp_sh in (True, False):
        want = _jax_lightings(case, lp_sh)
        got = lightings(tm, case["probes"], lp_sh=lp_sh)
        assert [g[0] for g in got] == [w[0] for w in want]
        for (_, glp, gsh), (_, wlp, wsh) in zip(got, want):
            np.testing.assert_array_equal(glp.numpy(), np.asarray(wlp))
            assert (gsh is None) == (wsh is None)
            if gsh is not None:
                np.testing.assert_allclose(gsh.numpy(), np.asarray(wsh),
                                           rtol=0, atol=1e-5 * _max(wsh))
    low = lightings(tm, case["probes"], sh_lmax=2)[1][2]
    assert low.shape == (25, 3) and bool((low[9:] == 0).all())
    jv = case["variables"]
    learned = lightings(tm)
    assert [n for n, _, _ in learned] == ["learned0", "learned1"]
    for i, (_, lp, sh) in enumerate(learned):
        want = np.asarray(case["jm"].apply(
            jv, i, True, method=lambda m, i_, l: m.lighting(i_, is_lp=l)))
        assert sh is None and lp.shape == want.shape == (1, 64, 128, 3)
        np.testing.assert_allclose(lp.numpy(), want, rtol=0,
                                   atol=1e-5 * _max(want))
    assert lightings(tm, lighting_idx=1)[0][0] == "learned1"


@pytest.mark.parametrize("route", ROUTES)
def test_relit_frame_from_a_mesh_matches_jax(relight_case, route):
    """One view under each of the two novel probes, through the route's
    path, against rnr_tpu's eval step with relight on and its
    save_lp_background composite (test_rnr.py:315-343): f32, each image
    within 1e-4 of max |img|.  Each side renders its own G-buffer and
    v_feature."""
    case = relight_case
    jm, tm = _route_models(case, route)
    jstate = TrainState(step=jnp.zeros((), jnp.int32),
                        params=case["variables"]["params"],
                        constants=case["variables"].get("constants", {}),
                        spectral=case["variables"].get("spectral", {}),
                        opt_state=None)
    jstep = j_eval_step(jm)
    tstep = make_rnr_eval_step(tm, output_keys=None)
    lp_sh = route != "probe"
    jlights = _jax_lightings(case, lp_sh)
    tlights = lightings(tm, case["probes"], lp_sh=lp_sh)
    jalpha = np.asarray(case["jgb"]["alpha_map"][0])[..., None]
    vd = jnp.asarray(np.asarray(case["jgb"]["view_dir_map"][0]))
    for (_, jlp, jsh), (_, tlp, tsh) in zip(jlights, tlights):
        jimg = np.asarray(jstep(jstate, case["jbatch"], lp_override=jlp,
                                relight=True, v_feature=case["jvf"],
                                sh_override=jsh)["img"][0])
        jimg = jimg * jalpha
        # the probe behind the object (rnr_tpu test_rnr.py:333-343)
        uv = jsph.spherical_mapping(-jnp.moveaxis(vd, -1, 0))
        lp0 = jlp[0]
        bgx = jnp.clip(uv[0] * lp0.shape[1], None, lp0.shape[1] - 1)
        bgy = jnp.clip(uv[1] * lp0.shape[0], None, lp0.shape[0] - 1)
        jimg = jimg + np.asarray(jax_bilinear(lp0, bgx, bgy)) * (1 - jalpha)
        timg = relit_frame(tstep, case["tb"], tlp, tsh, case["tvf"],
                           save_lp_background=True).numpy()
        inside = jalpha[..., 0] > 0
        assert 0.3 < inside.mean() < 0.9
        assert float(np.std(jimg[inside])) > 1e-3      # not a flat frame
        np.testing.assert_allclose(timg, jimg, rtol=0,
                                   atol=1e-4 * _max(jimg))
    out = tstep(case["tb"], v_feature=case["tvf"], lp_override=tlp,
                sh_override=tsh, relight=True)
    assert (out["rays_uv"] is None) == lp_sh
    # without relight the overrides are ignored: the learned lighting 0
    plain = tstep(case["tb"], v_feature=case["tvf"], lp_override=tlp,
                  sh_override=tsh)["img"]
    assert torch.equal(plain, tstep(case["tb"], v_feature=case["tvf"])["img"])
    bg = lp_background(tlp[0], case["tb"]["view_dir_map"][0])
    assert bg.shape == (SMALL["img_size"], SMALL["img_size"], 3)


def test_rnr_model_raises_only_for_remat():
    from rnr_tpu_torch.synthetic import build_config
    cfg = build_config(img_size=32, tex_size=32, lmax=2, nf0=4, num_down=2,
                       gcn_blocks=2, num_azi=2, num_polar=1, num_sample=64)
    for rays in (dict(sh_fan_fuse=False), dict(direct_sh_shading=False),
                 dict(fan_impl="einsum")):
        RNRModel(dataclasses.replace(cfg, rays=dataclasses.replace(
            cfg.rays, **rays)), 300, device="cpu")
    for remat in (True, "all", "wide", "none", False):
        m = RNRModel(dataclasses.replace(cfg, render_net=dataclasses.replace(
            cfg.render_net, remat=remat)), 300, device="cpu")
        assert m.render_net.Unet_0.remat == remat_mode(remat)
    with pytest.raises(ValueError, match="remat"):
        RNRModel(dataclasses.replace(cfg, render_net=dataclasses.replace(
            cfg.render_net, remat="some")), 300, device="cpu")


def test_make_probes_are_seeded_hdr_with_a_seam_sun():
    p = make_probes(2, 64, 128, seed=0)
    assert p.shape == (2, 64, 128, 3) and p.dtype == np.float32
    assert np.array_equal(p, make_probes(2, 64, 128, seed=0))
    assert not np.array_equal(p, make_probes(2, 64, 128, seed=1))
    assert p.min() > 0 and p.max() > 2.0
    # the first probe's first sun straddles u = 0 / 1, 20 degrees up
    row = int(round((90 - 20) / 180 * 64))
    assert p[0, row, 0].max() > 2.0 and p[0, row, -1].max() > 2.0
    assert p[0, row, 64].max() < p[0, row, 0].max() / 4
