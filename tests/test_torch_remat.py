"""Remat in the port's U-Net (models/unet.py::remat_call) against no
remat and against rnr_tpu's nn.remat.

Each remat mode must compute the same function with the same dropout
masks: on the CPU the recompute runs the same plain versions on the
same inputs, so the loss, every gradient and the dropout generator's
state after the step are held bit for bit to a run without remat, on
one CPU thread (on two, the GCN's gather backward adds in no fixed order
and its first EdgeConv's gradient differs between two runs without
remat).  The kernels' forward is recomputed on the card; chip_smoke.py's
parallel phase holds that there.  Against rnr_tpu's remat=True and "wide"
RenderingNet (dropout off on both sides), forward and parameter
gradients in f32 to 1e-5 of the largest value.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnr_tpu.models.unet import RenderingNet as JaxRenderingNet
from rnr_tpu_torch.config import (DNRConfig, LossConfig, RenderNetConfig,
                                  TextureConfig)
from rnr_tpu_torch.convert import jax_grads_to_torch, load_jax_variables
from rnr_tpu_torch.models.rnr import RNRModel
from rnr_tpu_torch.models.unet import RenderingNet, remat_call, remat_mode
from rnr_tpu_torch.synthetic import (build_batch, build_config, build_statics,
                                     init_weights, to_torch)
from rnr_tpu_torch.train.losses import image_l1_loss
from rnr_tpu_torch.train.steps import (build_dnr_modules, dnr_forward,
                                       make_generator, make_rnr_loss_fn)
from test_torch_misc import flax_params

torch.set_num_threads(2)

MODES = (True, "all", "wide")
GCN_V = 256


def _rnr(remat, compute_dtype="bfloat16"):
    cfg = build_config(img_size=32, tex_size=32, lmax=2, nf0=8, num_down=3,
                       gcn_blocks=2, num_azi=2, num_polar=1, num_sample=64)
    cfg = dataclasses.replace(
        cfg, gcn=dataclasses.replace(cfg.gcn, stochastic=False),
        render_net=dataclasses.replace(cfg.render_net, remat=remat,
                                       compute_dtype=compute_dtype))
    return init_weights(RNRModel(cfg, GCN_V, device="cpu"), 0)


def _grads(model) -> dict:
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _rnr_step(remat, compute_dtype):
    """(loss terms, gradients, generator state) of one loss and backward
    with dropout on."""
    m = _rnr(remat, compute_dtype)
    batch = to_torch(build_batch(32, GCN_V, batch=2), "cpu")
    gen = make_generator(3, "cpu")
    loss, aux = make_rnr_loss_fn(m)(batch, build_statics(m, 64), gen)
    loss.backward()
    terms = {k: v.detach() for k, v in aux.items()}
    return terms, _grads(m), gen.get_state()


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", MODES)
def test_rnr_remat_is_bit_equal_to_none(remat, compute_dtype, one_thread):
    want_terms, want_grads, want_state = _rnr_step(False, compute_dtype)
    terms, grads, state = _rnr_step(remat, compute_dtype)
    for k in want_terms:
        assert torch.equal(terms[k], want_terms[k]), k
    assert grads.keys() == want_grads.keys()
    for k in want_grads:
        assert torch.equal(grads[k], want_grads[k]), k
    assert torch.equal(state, want_state)


@pytest.mark.parametrize("remat", MODES)
def test_dnr_remat_is_bit_equal_to_none(remat):
    def step(remat):
        cfg = DNRConfig(
            texture=TextureConfig(texture_size=32, texture_num_ch=12,
                                  mipmap_level=2),
            render_net=RenderNetConfig(nf0=8, num_down_unet=3, remat=remat),
            loss=LossConfig(border_crop=2))
        mods = init_weights(build_dnr_modules(cfg, device="cpu"), 1)
        rng = np.random.default_rng(0)
        batch = {
            "uv_map": rng.uniform(0, 1, (2, 32, 32, 2)),
            "sh_basis_map": rng.uniform(-1, 1, (2, 32, 32, 9)),
            "alpha_map": np.ones((2, 32, 32, 1)),
            "img_gt": rng.uniform(0, 1, (2, 32, 32, 3))}
        batch = {k: torch.from_numpy(v.astype(np.float32))
                 for k, v in batch.items()}
        gen = make_generator(5, "cpu")
        out, _ = dnr_forward(mods, batch, True, gen)
        loss = image_l1_loss(out, batch["img_gt"], batch["alpha_map"], 2)
        loss.backward()
        return loss.detach(), _grads(mods), gen.get_state()

    (wl, wg, ws), (l, g, s) = step(False), step(remat)
    assert torch.equal(l, wl)
    assert g.keys() == wg.keys() and all(torch.equal(g[k], wg[k]) for k in g)
    assert torch.equal(s, ws)


def test_remat_modes_recompute_their_blocks(monkeypatch):
    """Which blocks each mode runs under remat_call: none; every Down /
    Up / fusion block; levels 0 and 1 and the fusion block.  No block
    is recomputed where no gradient is asked."""
    import rnr_tpu_torch.models.unet as unet

    seen = []

    def spy(fn, generator, *args):
        seen.append(type(fn).__name__ + ("" if generator is None else "+g"))
        return remat_call(fn, generator, *args)

    monkeypatch.setattr(unet, "remat_call", spy)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 32, 32, 5)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 8)).astype(np.float32))
    counts = {}
    for remat in ("none", "all", "wide"):
        net = init_weights(RenderingNet(
            nf0=4, in_channels=5, out_channels=3, num_down_unet=4,
            out_channels_gcn=8, fuse_mode="dense", remat=remat), 0)
        seen.clear()
        net(x, v, True, make_generator(0, "cpu"))
        counts[remat] = sorted(seen)
        seen.clear()
        with torch.no_grad():
            net(x, v, True, make_generator(0, "cpu"))
        assert seen == []
    assert counts["none"] == []
    assert counts["all"] == sorted(["DownBlock+g"] * 4 + ["UpBlock+g"] * 4
                                   + ["GcnFuseBlock+g"])
    assert counts["wide"] == sorted(["DownBlock+g"] * 2 + ["UpBlock+g"] * 2
                                    + ["GcnFuseBlock+g"])


def test_remat_mode_values():
    assert [remat_mode(r) for r in (False, "none", True, "all", "wide")] == [
        "none", "none", "all", "all", "wide"]
    for bad in ("some", 2, None):
        with pytest.raises(ValueError, match="remat"):
            remat_mode(bad)


@pytest.mark.parametrize("remat, fuse_mode", [(True, "concat"),
                                              ("wide", "dense")])
def test_remat_matches_rnr_tpu(remat, fuse_mode):
    """rnr_tpu's RenderingNet under remat, forward and the gradients of
    sum(out * r) by parameter, f32, dropout off (train=False on both
    sides; remat applies whatever `train` says).  The weights are drawn
    (flax_params) for the plain tree and carried to nn.remat's names by the port's
    `Unet.flax_names`, so both modes see the weights of the parity tests
    without remat."""
    kw = dict(nf0=8, in_channels=11, out_channels=6, num_down_unet=3,
              out_channels_gcn=16, compute_dtype="float32",
              fuse_mode=fuse_mode)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 32, 32, 11)).astype(np.float32)
    v = rng.standard_normal((2, 16)).astype(np.float32)
    r = rng.standard_normal((2, 32, 32, 6)).astype(np.float32)
    params = flax_params(JaxRenderingNet(**kw), jnp.asarray(x),
                         jnp.asarray(v), train=False)
    net = RenderingNet(remat=remat, **kw)
    names = net.Unet_0.flax_names
    assert any(n.startswith("Checkpoint") for n in names.values())
    params = {"Unet_0": {names.get(k, k): t
                         for k, t in params["Unet_0"].items()}}
    jn = JaxRenderingNet(remat=remat, **kw)

    def loss(p):
        out = jn.apply({"params": p}, jnp.asarray(x), jnp.asarray(v),
                       train=False)
        return jnp.sum(out * r), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    load_jax_variables(net, {"params": params})
    out = net(torch.from_numpy(x), torch.from_numpy(v))
    (out * torch.from_numpy(r)).sum().backward()
    want = np.asarray(want)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    jg = jax_grads_to_torch(net, jax.device_get(jgrads))
    top = max(float(g.abs().max()) for g in jg.values())
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[name].numpy(), rtol=0,
                                   atol=1e-5 * top, err_msg=name)
