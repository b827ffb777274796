"""Port parity of the whole serving slice vs rnr_tpu's RNRModel, plus the
port's import and dispatch rules.

compute_v_feature + the eval step of the port (CPU, the kernels' twins)
against RNRModel.apply(train=False) with the same weights (the JAX init
with random SH coefficients and textures, converted) and the same
synthetic G-buffers.  JAX runs its XLA paths (conv_backend "xla",
sh_kernel "xla"); the port runs its kernel twins (fan-fused SH, K3 for
every 3x3 conv).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from rnr_tpu.models.rnr import RNRModel as JaxRNRModel
from rnr_tpu_torch.config import RNRConfig
from rnr_tpu_torch.convert import load_jax_variables
from rnr_tpu_torch.models.rnr import RNRModel
from rnr_tpu_torch.ops import backend
from rnr_tpu_torch.synthetic import build_batch, to_torch
from rnr_tpu_torch.train.steps import make_rnr_eval_step

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL = dict(img_size=32, tex_size=64, lmax=4, num_sample=64, nf0=8,
             num_down=3, gcn_blocks=4, gcn_v=512, num_azi=5, num_polar=1)


def _models(rays_dtype, unet_dtype):
    cfg, _, batch = graft._build(rays_dtype=rays_dtype, conv_backend="xla",
                                 sh_kernel="xla", **SMALL)
    # exact kNN graphs: the bf16 ranking ties are tested on their own
    # (test_torch_knn.py); here they would only blur the slice check
    cfg = dataclasses.replace(
        cfg, gcn=dataclasses.replace(cfg.gcn, knn_approx=False),
        render_net=dataclasses.replace(cfg.render_net,
                                       compute_dtype=unet_dtype))
    jm = JaxRNRModel(cfg=cfg, l_dir=graft._fib_sphere(SMALL["num_sample"]))
    variables = jax.device_get(jax.jit(lambda r, b: jm.init(
        r, b, lighting_idx=0, train=False))(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
             "gcn": jax.random.PRNGKey(2)}, batch))
    # rnr_tpu starts the SH lighting at zero (a black image) and the
    # textures at constants: randomise both, or the comparison is vacuous
    rng = np.random.default_rng(0)
    params = dict(variables["params"])
    params["lighting"] = {"coeff": (0.5 * rng.standard_normal(
        params["lighting"]["coeff"].shape)).astype(np.float32)}
    params["texture_mapper"] = {
        k: (0.5 + 0.5 * rng.standard_normal(v.shape)).astype(np.float32)
        for k, v in params["texture_mapper"].items()}
    variables = dict(variables, params=params)
    tm = load_jax_variables(RNRModel(
        RNRConfig.from_dict(dataclasses.asdict(cfg)), SMALL["gcn_v"],
        device="cpu"), variables)
    return jm, variables, tm, batch


def _run_both(rays_dtype, unet_dtype):
    jm, variables, tm, batch = _models(rays_dtype, unet_dtype)
    jvf = jax.jit(lambda v, p: jm.apply(
        v, p, method=lambda m, p_: m.compute_v_feature(p_)))(
            variables, batch["gcn_pos"])
    jout = jax.jit(lambda v, b, f: jm.apply(
        v, b, lighting_idx=0, train=False, mutable=["spectral"],
        v_feature_override=f)[0])(variables, batch, jvf)
    tb = to_torch({k: np.asarray(v) for k, v in batch.items()}, "cpu")
    with torch.inference_mode():
        tvf = tm.compute_v_feature(tb["gcn_pos"])
    tout = make_rnr_eval_step(tm, output_keys=None)(tb, v_feature=tvf)
    j = {k: np.asarray(jout[k]).astype(np.float32)
         for k in ("img", "neural_img", "rays_lt")}
    t = {k: tout[k].float().numpy() for k in j}
    j["v_feature"], t["v_feature"] = np.asarray(jvf), tvf.numpy()
    return j, t


def test_slice_f32_matches_jax():
    """f32 rays and U-Net: v_feature, neural_img, rays_lt and img agree to
    f32 noise (sums in another order; the port builds the SH fan in f32
    as the fused kernel does, the JAX XLA path shades the same f32 rays)."""
    j, t = _run_both("float32", "float32")
    assert float(np.std(j["img"])) > 1e-3          # not a black frame
    for k, tol in (("v_feature", 1e-4), ("neural_img", 1e-5),
                   ("rays_lt", 1e-4), ("img", 1e-4)):
        scale = float(np.abs(j[k]).max())
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=tol * scale,
                                   err_msg=k)


def test_slice_bf16_close_to_jax():
    """The shipped dtypes: bf16 rays and bf16 U-Net.  Both sides round
    rays_lt and the U-Net activations to bf16, at different places (XLA
    adds conv biases in bf16, the port's K3 in f32; XLA rounds each ray's
    radiance to bf16 before the reduction, the fused shading does not).
    Held to 5e-2 x max max and 5e-3 x max mean absolute error (measured:
    9e-3 and 4e-4 for img, 1e-2 and 1e-3 for rays_lt, one bf16 step of
    2.0); neural_img and v_feature stay f32."""
    j, t = _run_both("bfloat16", "bfloat16")
    np.testing.assert_allclose(t["v_feature"], j["v_feature"], rtol=0,
                               atol=1e-4 * float(np.abs(j["v_feature"]).max()))
    np.testing.assert_allclose(t["neural_img"], j["neural_img"], rtol=0,
                               atol=1e-5 * float(np.abs(j["neural_img"]).max()))
    for k in ("rays_lt", "img"):
        scale = float(np.abs(j[k]).max())
        err = np.abs(t[k] - j[k])
        assert err.max() <= 5e-2 * scale and err.mean() <= 5e-3 * scale, (
            k, float(err.max()), float(err.mean()), scale)


def test_synthetic_batch_equals_graft_build():
    _, _, jbatch = graft._build(img_size=32, tex_size=32, lmax=2,
                                num_sample=64, nf0=8, num_down=3,
                                gcn_blocks=2, gcn_v=300, num_azi=2,
                                num_polar=1, batch=2)
    nb = build_batch(32, 300, batch=2)
    assert set(nb) == set(jbatch)
    for k, v in jbatch.items():
        np.testing.assert_array_equal(nb[k], np.asarray(v), err_msg=k)


def test_port_never_imports_jax():
    """Import the port and chip_smoke.py, run a CPU frame, a CPU train
    step, a CPU frame from a mesh (G-buffer, then the eval step) and that
    view relit under a procedural probe, through SH and through the probe
    gather, in a fresh interpreter: no jax, flax or rnr_tpu module is
    ever loaded."""
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})

def foreign():
    return sorted(m for m in sys.modules
                  if m.split('.')[0] in ('jax', 'flax', 'rnr_tpu'))

assert not foreign()
import torch
import rnr_tpu_torch, rnr_tpu_torch.convert
import chip_smoke
from rnr_tpu_torch.models.rnr import RNRModel
from rnr_tpu_torch.synthetic import (build_batch, build_config, build_statics,
                                     init_weights, to_torch)
from rnr_tpu_torch.train.steps import (create_rnr_optimizer, make_generator,
                                       make_rnr_eval_step, make_rnr_train_step)
assert not foreign(), foreign()
cfg = build_config(img_size=32, tex_size=32, lmax=2, nf0=4, num_down=2,
                   gcn_blocks=2, num_azi=2, num_polar=1, num_sample=64)
m = init_weights(RNRModel(cfg, 300, device='cpu'), 0)
b = to_torch(build_batch(32, 300), 'cpu')
img = make_rnr_eval_step(m)(b)['img']
assert img.shape == (1, 32, 32, 3) and bool(torch.isfinite(img).all())
assert not foreign(), foreign()
step = make_rnr_train_step(m, create_rnr_optimizer(m, 1e-3))
met = step(b, build_statics(m, 64), make_generator(0, 'cpu'))
assert bool(torch.isfinite(met['loss']))
assert not foreign(), foreign()
from rnr_tpu_torch.drivers.test_rnr import _gbuffer, _to_batch
from rnr_tpu_torch.ops.gbuffer import make_mesh_buffers, render_gbuffer
from rnr_tpu_torch.synthetic import camera_ring, sphere_mesh
gb = _gbuffer(render_gbuffer, make_mesh_buffers(sphere_mesh(8, 12), 'cpu'),
              camera_ring(32)[0], 32)
assert int(gb['raster_overflow'][0]) == 0 and bool(gb['alpha_map'].any())
img = make_rnr_eval_step(m)(_to_batch(gb, b['gcn_pos']))['img']
assert img.shape == (1, 32, 32, 3) and bool(torch.isfinite(img).all())
assert not foreign(), foreign()
from rnr_tpu_torch.drivers.test_rnr import lightings, relit_frame
from rnr_tpu_torch.synthetic import make_probes
for lp_sh in (True, False):
    (_, lp, sh), = lightings(m, make_probes(1, 16, 32), lp_sh=lp_sh)
    img = relit_frame(make_rnr_eval_step(m), _to_batch(gb, b['gcn_pos']), lp,
                      sh, save_lp_background=True)
    assert img.shape == (32, 32, 3) and bool(torch.isfinite(img).all())
assert not foreign(), foreign()
print('NOJAX_OK')
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-I", "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "NOJAX_OK" in res.stdout, res.stderr


def test_dispatch_cpu_to_twins_without_building(monkeypatch):
    """CPU tensors go to the twins and never reach the CUDA build; the
    rule has no environment override; mixed devices raise."""
    from rnr_tpu_torch.ops import _build

    def no_build(name):
        raise AssertionError(f"CPU path tried to build {name}")

    monkeypatch.setattr(_build, "load", no_build)
    for var in ("RNR_PALLAS_INTERPRET", "CUDA_VISIBLE_DEVICES"):
        monkeypatch.setenv(var, "1")
    x = torch.zeros(3)
    assert backend.use_kernel(x) is False
    with pytest.raises(ValueError):
        backend.use_kernel(x, torch.zeros(3, device="meta"))
    cfg, _, _ = graft._build(img_size=32, tex_size=32, lmax=2, num_sample=64,
                             nf0=4, num_down=2, gcn_blocks=4, gcn_v=300,
                             num_azi=2, num_polar=1)
    m = RNRModel(RNRConfig.from_dict(dataclasses.asdict(cfg)), 300,
                 device="cpu")
    b = to_torch(build_batch(32, 300), "cpu")
    out = make_rnr_eval_step(m)(b)
    assert out["img"].shape == (1, 32, 32, 3)
    src = "".join(open(os.path.join(ROOT, "rnr_tpu_torch", "ops", f)).read()
                  for f in ("backend.py", "sh_cuda.py", "texture_cuda.py",
                            "conv_cuda.py", "knn_cuda.py",
                            "rasterize_cuda.py", "gbuffer.py"))
    assert "environ" not in src and "except" not in src
