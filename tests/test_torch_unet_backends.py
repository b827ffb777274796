"""The U-Net's conv_backend in the port: routing, parity with rnr_tpu
under each route, one parameter layout for every route, and group norm
(one training step under each kernel route: test_torch_conv4_train.py).

rnr_tpu runs "pallas_interpret" (K3 and K6 in Pallas interpret mode),
"p3s4" (K3 and K8's 4x4 pair), "slab3" (K8's 3x3 slab conv) and "slab"
(the 3x3 slab conv and K8's 4x4 pair), the last three reached on the CPU
only with RNR_PALLAS_INTERPRET=1, set here per test with monkeypatch;
the port runs "pallas", "p3s4", "slab3" and "slab" through its
autograd.Functions, whose wrappers take the plain versions on CPU
tensors.  Which wrapper ran is counted by patching the four `*_fwd`
functions of ops/conv4_cuda.py, through which every forward and every
data gradient of the 4x4 pair goes, and the slab conv's `conv3x3s_fwd`
(its forward and data gradient) and `conv3x3s_wgrad` in
ops/conv_cuda.py.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnr_tpu.models.unet import RenderingNet as JaxRenderingNet
from rnr_tpu_torch.convert import load_jax_variables
from rnr_tpu_torch.models.rnr import RNRModel
from rnr_tpu_torch.models.unet import CONV_ROUTES, RenderingNet, conv_routes
from rnr_tpu_torch.ops import conv4_cuda as c4
from rnr_tpu_torch.ops import conv_cuda as cc
from rnr_tpu_torch.synthetic import build_config
from test_torch_conv import _perturb

torch.set_num_threads(2)

FWDS = ("down4_fwd", "convt4_fwd", "down4s_fwd", "convt4s_fwd")
SLAB = ("conv3x3s_fwd", "conv3x3s_wgrad")
# the port's selector -> rnr_tpu's, run on the CPU
JAX_BACKEND = {"xla": "xla", "pallas3": "xla", "pallas": "pallas_interpret",
               "p3s4": "p3s4", "slab3": "slab3", "slab": "slab"}
# rnr_tpu's selectors that reach their Pallas kernels on the CPU only
# with RNR_PALLAS_INTERPRET=1
FORCED_INTERPRET = ("p3s4", "slab3", "slab")


@pytest.fixture
def calls(monkeypatch):
    """Counts of the four 4x4 wrappers' and the two slab wrappers' calls,
    by name."""
    seen = collections.Counter()
    for mod, names in ((c4, FWDS), (cc, SLAB)):
        for name in names:
            fn = getattr(mod, name)

            def counted(*a, _fn=fn, _name=name, **k):
                seen[_name] += 1
                return _fn(*a, **k)

            monkeypatch.setattr(mod, name, counted)
    return seen


def _nets(backend, pad_mode, monkeypatch, nf0=8, norm="batch"):
    kw = dict(nf0=nf0, in_channels=11, out_channels=6, num_down_unet=3,
              out_channels_gcn=16, norm=norm, compute_dtype="float32",
              fuse_mode="dense", pad_mode=pad_mode)
    if backend in FORCED_INTERPRET:
        monkeypatch.setenv("RNR_PALLAS_INTERPRET", "1")
    return (JaxRenderingNet(conv_backend=JAX_BACKEND[backend], **kw),
            RenderingNet(conv_backend=backend, **kw))


def _jax_params_and_out(jn, x, v, seed=0):
    """Init under the "xla" route (flax keeps one tree across backends, so
    only the apply compiles the interpret-mode kernels), perturb, apply."""
    ji = jn.clone(conv_backend="xla")
    init = jax.jit(lambda k, x_, v_: ji.init(k, x_, v_, train=False))
    params = _perturb(jax.device_get(init(
        jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(v)))["params"],
        np.random.default_rng(seed + 1))
    out = jax.jit(lambda p, x_, v_: jn.apply({"params": p}, x_, v_,
                                             train=False))(
        params, jnp.asarray(x), jnp.asarray(v))
    return params, np.asarray(out)


def _xv(seed=11, side=32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, side, side, 11)).astype(np.float32),
            rng.standard_normal((1, 16)).astype(np.float32))


# ------------------------------------------------------------ routing


@pytest.mark.parametrize("backend", sorted(CONV_ROUTES) + ["cudnn"])
def test_conv_routes_raise_or_route(backend):
    if backend == "cudnn":
        with pytest.raises(ValueError, match="conv_backend"):
            conv_routes(backend)
        return
    want = {"xla": ("plain", "plain", "plain"),
            "auto": ("k3", "plain", "plain"),
            "pallas3": ("k3", "plain", "plain"),
            "pallas": ("k3", "down4", "convt4"),
            "pallas_interpret": ("k3", "down4", "convt4"),
            "p3s4": ("k3", "down4s", "convt4s"),
            "slab3": ("slab", "plain", "plain"),
            "slab": ("slab", "down4s", "convt4s")}[backend]
    assert conv_routes(backend) == want
    net = RenderingNet(nf0=4, in_channels=5, out_channels=3, num_down_unet=2,
                       out_channels_gcn=8, conv_backend=backend)
    u = net.Unet_0
    assert u.Conv_0.route == want[0]
    assert u.DownBlock_0.Conv_0.route == want[0]
    assert u.DownBlock_0.Conv_1.route == want[1]
    assert u.UpBlock_0.ConvTranspose_0.route == want[2]


@pytest.mark.parametrize("backend,err", [("slab3", None), ("slab", None),
                                         ("tpu", ValueError)])
def test_rnr_model_refuses_unported_backends(backend, err):
    """RNRModel builds under the slab selectors, with the slab conv on
    every 3x3 conv, and refuses a name that is no selector."""
    cfg = build_config(img_size=16, tex_size=16, lmax=2, nf0=4, num_down=2,
                       gcn_blocks=2, num_azi=2, num_polar=1, num_sample=16)
    cfg = dataclasses.replace(cfg, render_net=dataclasses.replace(
        cfg.render_net, conv_backend=backend))
    if err is not None:
        with pytest.raises(err):
            RNRModel(cfg, 64, device="cpu")
        return
    u = RNRModel(cfg, 64, device="cpu").render_net.Unet_0
    assert u.Conv_0.route == u.UpBlock_0.Conv_0.route == "slab"
    assert u.DownBlock_0.Conv_1.route == CONV_ROUTES[backend][1]


@pytest.mark.parametrize("backend", ["pallas", "p3s4", "slab3", "slab",
                                     "xla"])
def test_rnr_model_passes_conv_backend(backend, calls):
    """The repaired fault: RNRModel used to build its U-Net without the
    config's conv_backend, so every selector ran as "pallas3".  A config
    asking for "pallas" or "p3s4" now reaches its 4x4 kernels' wrappers,
    once per down and transpose conv of the frame."""
    from rnr_tpu_torch.synthetic import build_batch, init_weights, to_torch
    cfg = build_config(img_size=16, tex_size=16, lmax=2, nf0=4, num_down=2,
                       gcn_blocks=2, num_azi=2, num_polar=1, num_sample=16)
    cfg = dataclasses.replace(cfg, render_net=dataclasses.replace(
        cfg.render_net, conv_backend=backend))
    m = init_weights(RNRModel(cfg, 64, device="cpu"), 0)
    with torch.inference_mode():
        img = m(to_torch(build_batch(16, 64), "cpu"))["img"]
    assert bool(torch.isfinite(img).all())
    nd = cfg.render_net.num_down_unet
    slab = {"conv3x3s_fwd": _n3x3(nd)}
    want = {"pallas": {"down4_fwd": nd, "convt4_fwd": nd},
            "p3s4": {"down4s_fwd": nd, "convt4s_fwd": nd},
            "slab3": slab,
            "slab": dict(slab, down4s_fwd=nd, convt4s_fwd=nd),
            "xla": {}}[backend]
    assert dict(calls) == want


def _n3x3(nd):
    """The 3x3 convs of a U-Net with nd downs and GCN fusion: the in and
    out convs, one per down and per up level, two in the fusion block."""
    return 2 * nd + 4


# per selector and pad mode: calls of each 4x4 and slab wrapper in one
# forward and backward of a U-Net with nd downs and GCN fusion (rnr_tpu's
# VJPs: under reflect the down convs' data gradient is the plain conv's);
# `input_grad`: whether the U-Net's input needs a gradient (the first
# conv's data gradient)
def _want_calls(backend, pad_mode, nd, input_grad=True):
    want = {}
    if backend in ("slab3", "slab"):
        n3 = _n3x3(nd)
        want = {"conv3x3s_fwd": 2 * n3 - (not input_grad),
                "conv3x3s_wgrad": n3}
    if backend == "pallas":
        return {"down4_fwd": 2 * nd, "convt4_fwd": nd + nd * (
            pad_mode == "same")}
    if backend in ("p3s4", "slab"):
        want.update(down4s_fwd=2 * nd, convt4s_fwd=nd)
        if pad_mode == "same":
            want["convt4_fwd"] = nd          # K6 as down4s's dgrad
    return want


@pytest.mark.parametrize("pad_mode", ["same", "reflect"])
@pytest.mark.parametrize("backend", ["pallas", "p3s4", "slab3", "slab",
                                     "pallas3", "xla"])
def test_each_function_reached_in_forward_and_backward(backend, pad_mode,
                                                       calls):
    net = RenderingNet(nf0=4, in_channels=5, out_channels=3,
                       num_down_unet=2, out_channels_gcn=8,
                       pad_mode=pad_mode, conv_backend=backend)
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.1 * torch.from_numpy(rng.standard_normal(
                tuple(p.shape)).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((1, 16, 16, 5)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 8)).astype(np.float32))
    net(x, v).square().sum().backward()
    assert dict(calls) == _want_calls(backend, pad_mode, 2, input_grad=False)
    assert all(p.grad is not None for p in net.parameters())


def test_port_ignores_rnr_pallas_interpret(monkeypatch, calls):
    """rnr_tpu's RNR_PALLAS_INTERPRET forces its Pallas kernels on for
    every selector; the port has no override: with it set, "xla" and
    "pallas3" still route the 4x4 convs to the plain convs."""
    monkeypatch.setenv("RNR_PALLAS_INTERPRET", "1")
    x, v = _xv(side=16)
    for backend in ("xla", "pallas3"):
        net = RenderingNet(nf0=4, in_channels=11, out_channels=3,
                           num_down_unet=2, out_channels_gcn=16,
                           conv_backend=backend)
        assert net.Unet_0.DownBlock_0.Conv_1.route == "plain"
        with torch.no_grad():
            net(torch.from_numpy(x), torch.from_numpy(v))
    assert not calls


# ------------------------------------------------------------ parity


@pytest.mark.parametrize("pad_mode", ["same", "reflect"])
@pytest.mark.parametrize("backend", ["pallas", "p3s4", "slab3", "slab",
                                     "xla"])
def test_rendering_net_backend_matches_jax(backend, pad_mode, monkeypatch,
                                           calls):
    """RenderingNet, f32, nf0 8, 3 downs, 32^2, the JAX init perturbed:
    the port's route against rnr_tpu's (held to 2e-4 of the tanh output,
    as tests/test_torch_conv.py holds the shipped route)."""
    x, v = _xv()
    jn, tn = _nets(backend, pad_mode, monkeypatch)
    params, want = _jax_params_and_out(jn, x, v)
    load_jax_variables(tn, {"params": params})
    with torch.no_grad():
        got = tn(torch.from_numpy(x), torch.from_numpy(v)).numpy()
    assert got.shape == (1, 32, 32, 6) and float(np.std(want)) > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    slab = {"conv3x3s_fwd": _n3x3(3)}
    want_calls = {"pallas": {"down4_fwd": 3, "convt4_fwd": 3},
                  "p3s4": {"down4s_fwd": 3, "convt4s_fwd": 3},
                  "slab3": slab,
                  "slab": dict(slab, down4s_fwd=3, convt4s_fwd=3),
                  "xla": {}}[backend]
    assert dict(calls) == want_calls


def test_one_state_dict_serves_every_backend():
    """One converted JAX tree loads into the port under every selector,
    each layout unchanged, and the port's own state dict moves between
    them; the outputs agree to f32 noise (2e-4 of the tanh output)."""
    x, v = _xv()
    jn, _ = _nets("xla", "reflect", None)
    params, want = _jax_params_and_out(jn, x, v, seed=4)
    outs, states = {}, {}
    for backend in ("xla", "pallas3", "pallas", "p3s4", "slab3", "slab"):
        tn = RenderingNet(nf0=8, in_channels=11, out_channels=6,
                          num_down_unet=3, out_channels_gcn=16,
                          fuse_mode="dense", conv_backend=backend)
        load_jax_variables(tn, {"params": params})
        states[backend] = tn.state_dict()
        with torch.no_grad():
            outs[backend] = tn(torch.from_numpy(x),
                               torch.from_numpy(v)).numpy()
    shapes = {b: {k: tuple(t.shape) for k, t in s.items()}
              for b, s in states.items()}
    assert all(s == shapes["xla"] for s in shapes.values())
    for backend, got in outs.items():
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4,
                                   err_msg=backend)
    moved = RenderingNet(nf0=8, in_channels=11, out_channels=6,
                         num_down_unet=3, out_channels_gcn=16,
                         fuse_mode="dense", conv_backend="p3s4")
    moved.load_state_dict(states["xla"])
    with torch.no_grad():
        got = moved(torch.from_numpy(x), torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, outs["xla"], rtol=0, atol=2e-4)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_group_norm_rendering_net_matches_jax(backend, monkeypatch):
    """norm="group" (flax GroupNorm, groups of 16: nf0 16), f32, 32^2:
    the GroupNorm_k parameters convert by name; held to 2e-4 of the tanh
    output."""
    x, v = _xv(seed=13)
    jn, tn = _nets(backend, "reflect", monkeypatch, nf0=16, norm="group")
    params, want = _jax_params_and_out(jn, x, v, seed=2)
    assert "GroupNorm_0" in params["Unet_0"]["DownBlock_0"]
    load_jax_variables(tn, {"params": params})
    with torch.no_grad():
        got = tn(torch.from_numpy(x), torch.from_numpy(v)).numpy()
    assert float(np.std(want)) > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
