"""The GCN's options against rnr_tpu's, on the CPU (the options no other
test_torch_* file sets).

DenseDeepGCN at V 256, 3 blocks, k 8, 16 filters, exact graphs and no
stochastic picks, one option at a time: conv_type "mr", block_type
"dense", act_type "leakyrelu" / "prelu", norm_type "batch" /
"instance", use_bias False, compute_dtype "bfloat16" (and the defaults).
The forward and every parameter gradient of a random weighting of it
are held to rnr_tpu's: f32 to 1e-5 of the largest value (forward) and of
each parameter's largest gradient (a gradient that is zero in rnr_tpu,
as the fusion PReLU's slope where every channel maximum is positive,
must be zero); bf16 forward to 1e-3 and gradients to 5e-2 of their
largest (measured 9.5e-7 and 2.3e-2: the EdgeConv biases' gradients sum
bf16 products that the two packages round at their own places), and the
bf16 forward must differ from the f32 one by more than 1e-4 of its
largest, so that the option reaches the computation.  Then
graph_refresh_every 2 and 4 through RNRModel: v_feature and the eval
frame against rnr_tpu's to 1e-4 of their largest.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from rnr_tpu.models.gcn import DenseDeepGCN as JaxGCN
from rnr_tpu.models.gcn import GCNConfig as JaxGCNConfig
from rnr_tpu.models.rnr import RNRModel as JaxRNRModel
from rnr_tpu_torch.config import RNRConfig
from rnr_tpu_torch.convert import jax_grads_to_torch, load_jax_variables
from rnr_tpu_torch.models.gcn import DenseDeepGCN, GCNConfig
from rnr_tpu_torch.models.rnr import RNRModel
from rnr_tpu_torch.synthetic import to_torch
from rnr_tpu_torch.train.steps import make_rnr_eval_step

torch.set_num_threads(2)
V = 256
BASE = dict(num_v=V, n_blocks=3, kernel_size=8, n_filters=16,
            out_channels=32, knn_approx=False, stochastic=False)
OPTIONS = {"default": {}, "mr": dict(conv_type="mr"),
           "dense": dict(block_type="dense"),
           "leakyrelu": dict(act_type="leakyrelu"),
           "prelu": dict(act_type="prelu"),
           "batch": dict(norm_type="batch"),
           "instance": dict(norm_type="instance"),
           "no_bias": dict(use_bias=False),
           "bfloat16": dict(compute_dtype="bfloat16")}


def _pos():
    return np.random.default_rng(5).standard_normal((V, 3)).astype(
        np.float32)


def _run(opts):
    """(forward, parameter gradients) of both packages for one option:
    rnr_tpu's as numpy, the port's in its parameter layout."""
    pos = _pos()
    wv = np.random.default_rng(6).standard_normal((1, 32)).astype(
        np.float32)
    jg = JaxGCN(JaxGCNConfig(**BASE, **opts))
    variables = jax.device_get(jg.init(jax.random.PRNGKey(0),
                                       jnp.asarray(pos), train=False))
    # PReLU starts every slope at 0.2: move them, or a wrong slope
    # gradient would pass unseen behind equal forwards
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a * 1.7 if "prelu_slope" in jax.tree_util.keystr(p)
        else a,
        variables["params"])
    variables = dict(variables, params=params)

    def fwd(p):
        out = jg.apply(dict(variables, params=p), jnp.asarray(pos),
                       train=False, mutable=["spectral"])[0]
        return jnp.sum(out * wv), out

    (_, jout), jgrad = jax.value_and_grad(fwd, has_aux=True)(params)
    tg = load_jax_variables(DenseDeepGCN(GCNConfig(**BASE, **opts)),
                            variables)
    tout = tg(torch.from_numpy(pos))
    (tout.float() * torch.from_numpy(wv)).sum().backward()
    want = jax_grads_to_torch(tg, jax.device_get(jgrad))
    got = {n: p.grad for n, p in tg.named_parameters()}
    return (np.asarray(jout, np.float32), tout.detach().float().numpy(),
            want, got)


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_gcn_option_matches_rnr_tpu(name):
    jout, tout, want, got = _run(OPTIONS[name])
    tol, gtol = (1e-3, 5e-2) if name == "bfloat16" else (1e-5, 1e-5)
    scale = float(np.abs(jout).max())
    assert jout.shape == tout.shape == (1, 32) and scale > 1e-3
    np.testing.assert_allclose(tout, jout, rtol=0, atol=tol * scale)
    assert set(want) == set(got)
    moved = 0
    for n in want:
        g = float(want[n].abs().max())
        assert got[n] is not None, n
        err = float((got[n].float() - want[n]).abs().max())
        assert err <= gtol * g, (n, err, g)
        moved += g > 0
    assert moved >= len(want) - 1
    if name == "bfloat16":
        f32 = _run({})[1]
        assert float(np.abs(tout - f32).max()) > 1e-4 * scale


def _rnr_models(refresh):
    small = dict(img_size=32, tex_size=64, lmax=4, num_sample=64, nf0=8,
                 num_down=3, gcn_blocks=6, gcn_v=512, num_azi=5,
                 num_polar=1)
    cfg, _, batch = graft._build(conv_backend="xla", sh_kernel="xla",
                                 graph_refresh_every=refresh, **small)
    cfg = dataclasses.replace(
        cfg, gcn=dataclasses.replace(cfg.gcn, knn_approx=False),
        render_net=dataclasses.replace(cfg.render_net,
                                       compute_dtype="float32"))
    jm = JaxRNRModel(cfg=cfg, l_dir=graft._fib_sphere(64))
    variables = jax.device_get(jax.jit(lambda r, b: jm.init(
        r, b, lighting_idx=0, train=False))(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1),
             "gcn": jax.random.PRNGKey(2)}, batch))
    rng = np.random.default_rng(0)
    params = dict(variables["params"])
    params["lighting"] = {"coeff": (0.5 * rng.standard_normal(
        params["lighting"]["coeff"].shape)).astype(np.float32)}
    variables = dict(variables, params=params)
    pcfg = RNRConfig.from_dict(dataclasses.asdict(cfg))
    assert pcfg.gcn.graph_refresh_every == refresh
    tm = load_jax_variables(RNRModel(pcfg, 512, device="cpu"), variables)
    return jm, variables, tm, batch


@pytest.mark.parametrize("refresh", [2, 4])
def test_graph_refresh_every_through_rnr_model(refresh):
    """RNRModel with 6 GCN blocks (windowed dilations 1-2, stratified 3-5)
    refreshing its graphs every `refresh` blocks: v_feature and the eval
    frame against rnr_tpu's to 1e-4 of their largest, and v_feature
    differs from refresh 1's."""
    jm, variables, tm, batch = _rnr_models(refresh)
    jvf = jm.apply(variables, batch["gcn_pos"],
                   method=lambda m, p: m.compute_v_feature(p))
    jout = jm.apply(variables, batch, lighting_idx=0, train=False,
                    mutable=["spectral"], v_feature_override=jvf)[0]
    tb = to_torch({k: np.asarray(v) for k, v in batch.items()}, "cpu")
    with torch.inference_mode():
        tvf = tm.compute_v_feature(tb["gcn_pos"])
    timg = make_rnr_eval_step(tm)(tb, v_feature=tvf)["img"].numpy()
    for got, want in ((tvf.numpy(), np.asarray(jvf)),
                      (timg, np.asarray(jout["img"]))):
        scale = float(np.abs(want).max())
        assert scale > 1e-3
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
    _, _, t1, _ = _rnr_models(1)
    with torch.inference_mode():
        vf1 = t1.compute_v_feature(tb["gcn_pos"]).numpy()
    assert float(np.abs(vf1 - tvf.numpy()).max()) > 1e-4 * float(
        np.abs(vf1).max())
