"""Port parity of one f32 training step in the two relighting
configurations vs rnr_tpu: the unfused SH shading (sh_fan_fuse=False: K5
and K5b's plain versions, rnr_tpu's Pallas sh_shade in interpret mode)
and the probe path (direct_sh_shading=False: the learned lighting
reconstructed as a 64 x 128 probe and gathered per ray, whose backward is
a scatter into the probe).

As tests/test_torch_train.py: the SMALL config, exact kNN graphs,
`gcn.stochastic=False` and dropout off on both sides, random lighting and
textures (the coarse levels' albedo channels at zero), rnr_tpu's loss
under jit.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from rnr_tpu.models.rnr import RNRModel as JaxRNRModel
from rnr_tpu.train.steps import TrainState
from rnr_tpu.train.steps import make_rnr_loss_fn as jax_loss_fn
from rnr_tpu_torch.config import RNRConfig
from rnr_tpu_torch.convert import jax_grads_to_torch, load_jax_variables
from rnr_tpu_torch.models.rnr import RNRModel
from rnr_tpu_torch.synthetic import to_torch
from rnr_tpu_torch.train.steps import make_generator, make_rnr_loss_fn
from test_torch_train import (LOSS_KEYS, SMALL, _gradient_blocked_by_batch_norm,
                              _max, _no_dropout)

torch.set_num_threads(2)

CONFIGS = {
    # rnr_tpu's unfused shading runs its Pallas sh_shade (K5) in
    # interpret mode, the port K5's plain version and backward
    "unfused": dict(sh_fan_fuse=False, sh_kernel="pallas_interpret"),
    "probe": dict(direct_sh_shading=False),
}


def _jax_step(rays: dict):
    jcfg, _, batch = graft._build(rays_dtype="float32", conv_backend="xla",
                                  sh_kernel="xla", **SMALL)
    jcfg = dataclasses.replace(
        jcfg, rays=dataclasses.replace(jcfg.rays, **rays),
        gcn=dataclasses.replace(jcfg.gcn, knn_approx=False,
                                stochastic=False),
        render_net=dataclasses.replace(jcfg.render_net,
                                       compute_dtype="float32"))
    l_dir = graft._fib_sphere(SMALL["num_sample"])
    jm = JaxRNRModel(cfg=jcfg, l_dir=l_dir)
    keys = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
            "gcn": jax.random.PRNGKey(2)}
    variables = jax.device_get(jax.jit(lambda r, b: jm.init(
        r, b, lighting_idx=0, train=False))(keys, batch))
    rng = np.random.default_rng(0)
    params = dict(variables["params"])
    params["lighting"] = {"coeff": (0.5 * rng.standard_normal(
        params["lighting"]["coeff"].shape)).astype(np.float32)}
    tex = {}
    for k, v in params["texture_mapper"].items():
        t = (0.5 + 0.5 * rng.standard_normal(v.shape)).astype(np.float32)
        if k != "texture_0":
            t[..., :6] = 0.0
        tex[k] = t
    params["texture_mapper"] = tex
    variables = dict(variables, params=params)
    nprng = np.random.default_rng(1)
    statics = {
        "l_samples_init": nprng.uniform(0, 1, (SMALL["num_sample"], 3)
                                        ).astype(np.float32),
        "l_samples_mask": (nprng.uniform(size=SMALL["num_sample"]) > 0.3
                           ).astype(np.float32),
        "tex_flatten_init": np.maximum(tex["texture_0"][..., :6], 0.0),
    }
    st = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                    constants=variables["constants"],
                    spectral=variables["spectral"], opt_state=None)
    vg = jax.jit(jax.value_and_grad(jax_loss_fn(jm), has_aux=True))
    with nn.intercept_methods(_no_dropout):
        (_, aux), grads = vg(params, st, batch, statics,
                             jax.random.PRNGKey(3))
    return dict(cfg=jcfg, l_dir=l_dir, variables=variables,
                batch={k: np.asarray(v) for k, v in batch.items()},
                statics=statics,
                aux=jax.device_get({k: aux[k] for k in LOSS_KEYS}),
                grads=jax.device_get(grads))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_relight_train_step_f32_matches_jax(name):
    """One step's five loss terms (1e-5 relative) and every parameter's
    gradient (1e-4 x that gradient's max), as test_torch_train.py holds
    the fan-fused step; the batch-norm-blocked GCN and fusion Dense hold
    noise below 1e-6 of the largest gradient on both sides.  The lighting
    coefficients' gradient comes through K5b's d coeff (unfused) or
    through the probe scatter and the reconstruction grid (probe)."""
    case = _jax_step(CONFIGS[name])
    m = RNRModel(RNRConfig.from_dict(dataclasses.asdict(case["cfg"])),
                 SMALL["gcn_v"], l_dir=case["l_dir"], device="cpu")
    load_jax_variables(m, case["variables"])
    m.render_net.Unet_0.use_dropout = False
    batch = to_torch(case["batch"], "cpu")
    loss, aux = make_rnr_loss_fn(m)(batch, to_torch(case["statics"], "cpu"),
                                    make_generator(0, "cpu"))
    loss.backward()
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(aux[k].detach()),
                                   float(case["aux"][k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    grads = jax_grads_to_torch(m, case["grads"])
    top = max(_max(g) for g in grads.values())
    for pname, p in m.named_parameters():
        g, w = p.grad.numpy(), grads[pname].numpy()
        if _gradient_blocked_by_batch_norm(pname):
            assert max(_max(g), _max(w)) < 1e-6 * top, pname
            continue
        assert _max(w) > 1e-6 * top, pname
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * _max(w),
                                   err_msg=pname)
    assert _max(grads["lighting.coeff"][0]) > 0
