"""Port parity of the training slice vs rnr_tpu: the config copy, the
device rule, the stochastic GCN picks, dropout, the losses, and one
whole f32 training step plus a 3-step Adam trajectory.

The step comparison runs rnr_tpu's `make_rnr_loss_fn` under jit once per
file (a module fixture) at the SMALL config of test_torch_slice.py, with
its XLA paths (conv_backend "xla", sh_kernel "xla"), exact kNN graphs,
`gcn.stochastic=False` on both sides, and dropout off: on the JAX side
through flax's `intercept_methods` (every nn.Dropout returns its input),
on the port through the Unet's `use_dropout` flag.  The trajectory applies
optax's Adam to the gradients of that one compiled function.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
import rnr_tpu.config as jax_config
from rnr_tpu.models.gcn import dilate_edges as jax_dilate_edges
from rnr_tpu.models.gcn import sample_strata as jax_sample_strata
from rnr_tpu.models.rays import rays_lt_chrom_loss as jax_chrom
from rnr_tpu.models.rnr import RNRModel as JaxRNRModel
from rnr_tpu.models.texture import TextureMapper as JaxTextureMapper
from rnr_tpu.ops.metrics import masked_err_metrics as jax_metrics
from rnr_tpu.train import losses as jax_losses
from rnr_tpu.train.steps import TrainState, make_rnr_loss_fn as jax_loss_fn
import rnr_tpu_torch.config as port_config
from rnr_tpu_torch.convert import jax_grads_to_torch, load_jax_variables
from rnr_tpu_torch.models.gcn import (SNDense, dilate_edges, draw_pick,
                                      sample_strata)
from rnr_tpu_torch.models.rays import rays_lt_chrom_loss
from rnr_tpu_torch.models.rnr import RNRModel
from rnr_tpu_torch.models.texture import TextureMapper
from rnr_tpu_torch.models.unet import RenderingNet, dropout
from rnr_tpu_torch.ops.metrics import masked_err_metrics
from rnr_tpu_torch.synthetic import build_config, init_weights, to_torch
from rnr_tpu_torch.train import losses
from rnr_tpu_torch.train.steps import (create_rnr_optimizer, make_generator,
                                       make_rnr_loss_fn, make_rnr_train_step,
                                       rnr_texture_flatten_init)

torch.set_num_threads(2)

SMALL = dict(img_size=32, tex_size=64, lmax=4, num_sample=64, nf0=8,
             num_down=3, gcn_blocks=4, gcn_v=512, num_azi=5, num_polar=1)
LR = 1e-3
LOSS_KEYS = ("loss", "loss_rn", "loss_lighting", "loss_rays_lt_chrom",
             "loss_alb")


def _max(a) -> float:
    return float(np.abs(np.asarray(a, np.float32)).max())


# ------------------------------------------------------------ config, device


CONFIG_CLASSES = ("TextureConfig", "LightingConfig", "RaysConfig",
                  "GCNTrainConfig", "RenderNetConfig", "LossConfig",
                  "TrainConfig", "RNRConfig", "DNRConfig")


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_copy_has_the_same_fields_and_defaults(name):
    jc, pc = getattr(jax_config, name), getattr(port_config, name)
    jf = [(f.name, f.type) for f in dataclasses.fields(jc)]
    pf = [(f.name, f.type) for f in dataclasses.fields(pc)]
    assert pf == jf
    assert dataclasses.asdict(pc()) == dataclasses.asdict(jc())


def test_config_from_dict_carries_a_jax_config_across():
    jcfg, _, _ = graft._build(rays_dtype="bfloat16", conv_backend="pallas3",
                              **SMALL)
    jcfg = dataclasses.replace(jcfg, use_gcn=False)
    pcfg = port_config.RNRConfig.from_dict(dataclasses.asdict(jcfg))
    assert isinstance(pcfg.gcn, port_config.GCNTrainConfig)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    for prop in ("num_ray_specular", "num_ray_diffuse", "num_ray_total",
                 "render_net_in_channels", "render_net_out_channels"):
        assert getattr(pcfg, prop) == getattr(jcfg, prop)
    with pytest.raises(ValueError):
        port_config.RNRConfig.from_dict({"no_such_field": 1})


def test_entry_points_build_on_the_card_unless_asked_for_the_cpu():
    cfg = build_config(img_size=32, tex_size=32, lmax=2, nf0=4, num_down=2,
                       gcn_blocks=2, num_azi=2, num_polar=1, num_sample=64)
    if torch.cuda.is_available():
        assert RNRModel(cfg, 300).lighting.coeff.device.type == "cuda"
        assert make_generator(0).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            RNRModel(cfg, 300)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_generator(0)
    m = RNRModel(cfg, 300, device="cpu")
    assert {p.device.type for p in m.parameters()} == {"cpu"}
    assert {b.device.type for b in m.buffers()} == {"cpu"}


# ------------------------------------------------------------ random picks


def test_stochastic_picks_equal_jax_for_the_same_key():
    """The JAX picks recomputed from each key (split, permutation,
    uniform) and handed to the port's pick functions give the same
    indices as rnr_tpu's sample_strata / dilate_edges, on both branches."""
    strat = np.arange(7 * 469).reshape(7, 469).astype(np.int32)
    window = np.arange(7 * 64).reshape(7, 64).astype(np.int32)
    branches = set()
    for seed in range(12):
        key = jax.random.PRNGKey(seed)
        for cols, dilation in ((strat, None), (window, 4)):
            n = cols.shape[1]
            r_choice, r_perm = jax.random.split(key)
            perm = np.array(jax.random.permutation(r_perm, n)[:16])
            use = bool(jax.random.uniform(r_choice, ()) < 0.5)
            branches.add(use)
            pick = (torch.tensor(use), torch.from_numpy(perm))
            if dilation is None:
                want = jax_sample_strata(jnp.asarray(cols), 16, seed, True,
                                         0.5, key, True)
                got = sample_strata(torch.from_numpy(cols), 16, seed, pick)
            else:
                want = jax_dilate_edges(jnp.asarray(cols), 16, dilation,
                                        True, 0.5, key, True)
                got = dilate_edges(torch.from_numpy(cols), 16, dilation,
                                   pick)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert branches == {True, False}


def test_generator_draws_are_deterministic():
    a = [draw_pick(469, 16, 0.2, make_generator(5, "cpu")) for _ in range(2)]
    assert torch.equal(a[0][0], a[1][0]) and torch.equal(a[0][1], a[1][1])
    b = draw_pick(469, 16, 0.2, make_generator(6, "cpu"))
    assert not torch.equal(a[0][1], b[1])
    perm = a[0][1]
    assert perm.shape == (16,) and len(set(perm.tolist())) == 16
    coins = [bool(draw_pick(64, 16, 0.2, g)[0])
             for g in [make_generator(0, "cpu")] for _ in range(400)]
    assert 0.14 < np.mean(coins) < 0.26        # epsilon 0.2


def test_dropout_rate_scaling_and_seed():
    x = torch.ones((200, 500))
    y = dropout(x, 0.1, make_generator(3, "cpu"))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.9) < 0.005
    np.testing.assert_allclose(y[kept].numpy(), 1 / 0.9, rtol=1e-6)
    assert torch.equal(y, dropout(x, 0.1, make_generator(3, "cpu")))
    assert not torch.equal(y, dropout(x, 0.1, make_generator(4, "cpu")))
    xb = torch.full((64, 64), 0.7, dtype=torch.bfloat16)
    yb = dropout(xb, 0.1, make_generator(3, "cpu"))
    assert yb.dtype == torch.bfloat16
    net = init_weights(RenderingNet(nf0=4, in_channels=5, out_channels=3,
                                    num_down_unet=2, use_gcn=False), 0)
    xin = torch.randn(1, 16, 16, 5, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = net(xin, None, True, make_generator(1, "cpu"))
        b = net(xin, None, True, make_generator(1, "cpu"))
        c = net(xin, None, True, make_generator(2, "cpu"))
        ev = net(xin)
        net.Unet_0.use_dropout = False
        off = net(xin, None, True)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(ev, off)
    net.Unet_0.use_dropout = True
    with pytest.raises(ValueError, match="Generator"):
        net(xin, None, True)


# ------------------------------------------------------------ losses


def test_losses_and_metrics_match_jax():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (2, 20, 20, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (2, 20, 20, 3)).astype(np.float32)
    alpha = (rng.uniform(size=(2, 20, 20, 1)) > 0.3).astype(np.float32)
    t = torch.from_numpy
    pairs = [
        (losses.image_l1_loss(t(img), t(gt), t(alpha), 5),
         jax_losses.image_l1_loss(img, gt, alpha, 5)),
    ]
    est = rng.standard_normal((64, 3)).astype(np.float32)
    init = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    mask = (rng.uniform(size=64) > 0.3).astype(np.float32)
    pairs.append((losses.lighting_loss(t(est), t(init), t(mask), 1.0, 0.1),
                  jax_losses.lighting_loss(est, init, mask, 1.0, 0.1)))
    tex = rng.standard_normal((8, 8, 3)).astype(np.float32)
    tex0 = tex.copy()
    tex0[:3] += 1.0                                   # 3 rows changed
    pairs.append((losses.albedo_prior_loss(t(tex), t(tex0)),
                  jax_losses.albedo_prior_loss(tex, tex0)))
    pairs.append((losses.albedo_prior_loss(t(tex), t(tex.copy())),
                  jax_losses.albedo_prior_loss(tex, tex.copy())))
    jm = jax_metrics(img * 255, gt * 255, alpha)
    pm = masked_err_metrics(t(img * 255), t(gt * 255), t(alpha))
    assert set(pm) == set(jm)
    pairs += [(pm[k], jm[k]) for k in jm]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                   atol=1e-6)


def test_l1_terms_take_jax_gradient_where_the_difference_is_zero():
    """Where an estimate equals its target bit for bit (a black pixel
    rendered black, a zero lighting against a black stitched probe, an
    albedo mean of exactly 0.5), each L1 term's gradient is rnr_tpu's:
    JAX's |x| has slope +1 at 0 (-0.0 too), torch.abs 0."""
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (1, 16, 16, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (1, 16, 16, 3)).astype(np.float32)
    img[:, :8] = gt[:, :8] = 0.0
    alpha = np.ones((1, 16, 16, 1), np.float32)
    est = rng.standard_normal((64, 3)).astype(np.float32)
    init = rng.standard_normal((64, 3)).astype(np.float32)
    est[:32] = init[:32] = 0.0
    est[0] = -0.0
    mask = (np.arange(64) % 3 > 0).astype(np.float32)
    tex = np.tile(np.asarray([0.25, 0.75], np.float32), 32).reshape(8, 8, 1)
    tex = np.concatenate([tex, tex[::-1], tex + 0.125], -1)
    cases = [
        (lambda x: losses.image_l1_loss(x, torch.from_numpy(gt),
                                        torch.from_numpy(alpha), 2),
         lambda x: jax_losses.image_l1_loss(x, gt, alpha, 2), img),
        (lambda x: losses.lighting_loss(x, torch.from_numpy(init),
                                        torch.from_numpy(mask), 1.0, 0.1),
         lambda x: jax_losses.lighting_loss(x, init, mask, 1.0, 0.1), est),
        (lambda x: losses.albedo_prior_loss(x, torch.zeros_like(x)),
         lambda x: jax_losses.albedo_prior_loss(x, jnp.zeros_like(x)), tex),
    ]
    for port_fn, jax_fn, x in cases:
        xt = torch.from_numpy(x.copy()).requires_grad_(True)
        port_fn(xt).backward()
        want = np.asarray(jax.grad(jax_fn)(jnp.asarray(x)))
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6,
                                   atol=1e-9)


def test_chrom_loss_matches_jax_with_finite_gradient_at_zero():
    """Values and gradients of rays_lt_chrom_loss, with some rays_lt
    exactly (0, 0, 0), where a norm would give a NaN gradient."""
    rng = np.random.default_rng(1)
    lt = rng.uniform(0, 2, (1, 6, 7, 5, 3)).astype(np.float32)
    lt[0, :2, :3, 1] = 0.0
    alpha = (rng.uniform(size=(1, 6, 7, 1)) > 0.2).astype(np.float32)
    img = rng.uniform(0, 0.1, (1, 6, 7, 3)).astype(np.float32)
    (jl, *jrest), jvjp = jax.vjp(
        lambda x: jax_chrom(x, jnp.asarray(alpha), jnp.asarray(img)),
        jnp.asarray(lt))
    jg = jvjp((jnp.ones(()), *[jnp.zeros_like(r) for r in jrest]))[0]
    lt_t = torch.from_numpy(lt).requires_grad_()
    tl, *trest = rays_lt_chrom_loss(lt_t, torch.from_numpy(alpha),
                                    torch.from_numpy(img))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for a, b in zip(trest, jrest):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=1e-5)
    assert bool(torch.isfinite(lt_t.grad).all())
    np.testing.assert_allclose(lt_t.grad.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-5 * _max(jg))
    # bf16 storage: the math runs in f32 on both sides
    lb = torch.from_numpy(lt).to(torch.bfloat16)
    jb = jax_chrom(jnp.asarray(lb.float().numpy()).astype(jnp.bfloat16),
                   jnp.asarray(alpha), jnp.asarray(img))[0]
    np.testing.assert_allclose(
        float(rays_lt_chrom_loss(lb, torch.from_numpy(alpha),
                                 torch.from_numpy(img))[0]),
        float(jb), rtol=1e-5)


def test_flatten_mipmap_matches_jax():
    """resize_bilinear (F.interpolate, half-pixel) against
    jax.image.resize when upsampling 8, 16, 32 -> 64: f32, 1e-6."""
    rng = np.random.default_rng(2)
    jm = JaxTextureMapper(texture_size=64, texture_num_ch=24, mipmap_level=4)
    params = {f"texture_{l}": rng.standard_normal(
        (64 >> l, 64 >> l, 24)).astype(np.float32) for l in range(4)}
    want = np.asarray(jm.flatten_mipmap(params, 0, 6))
    tm = TextureMapper(64, 24, 4)
    load_jax_variables(tm, {"params": params})
    got = tm.flatten_mipmap(0, 6).detach().numpy()
    assert got.shape == (64, 64, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * _max(want))


def test_sndense_no_gradient_through_u_and_update_in_training():
    torch.manual_seed(0)
    sn = SNDense(6, 5)
    with torch.no_grad():
        sn.kernel.normal_()
        sn.u.normal_()
    u0 = sn.u.clone()
    x = torch.randn(2, 6)
    y = sn(x)                                         # eval: u stays
    assert torch.equal(sn.u, u0)
    y.sum().backward()
    assert sn.u.grad is None and not sn.u.requires_grad
    y2 = sn(x, train=True)                            # train: u advances
    assert not torch.equal(sn.u, u0)
    torch.testing.assert_close(y2, y)                 # same sigma, same u step


# ------------------------------------------------------------ the whole step


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, nn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


@pytest.fixture(scope="module")
def step_case():
    """rnr_tpu's loss and gradients at SMALL, f32: 3 Adam steps."""
    jcfg, _, batch = graft._build(rays_dtype="float32", conv_backend="xla",
                                  sh_kernel="xla", **SMALL)
    jcfg = dataclasses.replace(
        jcfg, gcn=dataclasses.replace(jcfg.gcn, knn_approx=False,
                                      stochastic=False),
        render_net=dataclasses.replace(jcfg.render_net,
                                       compute_dtype="float32"))
    l_dir = graft._fib_sphere(SMALL["num_sample"])
    jm = JaxRNRModel(cfg=jcfg, l_dir=l_dir)
    keys = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
            "gcn": jax.random.PRNGKey(2)}
    variables = jax.device_get(jax.jit(lambda r, b: jm.init(
        r, b, lighting_idx=0, train=False))(keys, batch))
    # random lighting and textures (rnr_tpu starts them at constants).
    # The coarse levels' albedo channels 0:6 start at zero, so that the
    # flattened albedo is level 0 bit for bit in both frameworks and the
    # albedo prior's "changed" mask is the same on both sides.
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
    vg = jax.jit(jax.value_and_grad(jax_loss_fn(jm), has_aux=True))
    tx = optax.adam(LR)
    p, spectral = params, variables["spectral"]
    opt = tx.init(p)
    steps = []
    for _ in range(3):
        st = TrainState(step=jnp.zeros((), jnp.int32), params=p,
                        constants=variables["constants"], spectral=spectral,
                        opt_state=opt)
        with nn.intercept_methods(_no_dropout):
            (_, aux), grads = vg(p, st, batch, statics, jax.random.PRNGKey(3))
        steps.append({"aux": jax.device_get({k: aux[k] for k in LOSS_KEYS}),
                      "spectral": jax.device_get(aux["spectral"]),
                      "grads": jax.device_get(grads)})
        updates, opt = tx.update(grads, opt, p)
        p = optax.apply_updates(p, updates)
        spectral = aux["spectral"]
    return dict(cfg=jcfg, l_dir=l_dir, variables=variables,
                batch={k: np.asarray(v) for k, v in batch.items()},
                statics=statics, steps=steps, final=jax.device_get(p))


def _port_model(case):
    m = RNRModel(port_config.RNRConfig.from_dict(
        dataclasses.asdict(case["cfg"])), SMALL["gcn_v"], l_dir=case["l_dir"],
        device="cpu")
    load_jax_variables(m, case["variables"])
    m.render_net.Unet_0.use_dropout = False
    return m


def test_port_basis_val_and_flatten_init_match_jax(step_case):
    m = _port_model(step_case)
    want = step_case["variables"]["constants"]["lighting"]["basis_val"]
    np.testing.assert_allclose(m.lighting.basis_val.numpy(), want, rtol=0,
                               atol=2e-6)
    np.testing.assert_array_equal(rnr_texture_flatten_init(m).numpy(),
                                  step_case["statics"]["tex_flatten_init"])


# The GCN and the fusion block's Dense reach the loss only through a
# spatially constant per-channel shift that the next batch norm removes:
# their exact gradient is zero (in rnr_tpu as in the port), and both
# sides hold f32 rounding noise there, ~1e-10 against ~1e-2 elsewhere.
def _gradient_blocked_by_batch_norm(name: str) -> bool:
    return name.startswith("gcn.") or "GcnFuseBlock_0.Dense_0" in name


def test_train_step_f32_matches_jax(step_case):
    """One step's five loss terms (1e-5 relative), every parameter's
    gradient (1e-4 x that gradient's max; measured up to 2.1e-5: f32
    sums in another order) and the SNDense vectors after the step (1e-5).
    The gradients that batch norm blocks are noise on both sides: held
    below 1e-6 x the largest gradient of the model."""
    m = _port_model(step_case)
    batch = to_torch(step_case["batch"], "cpu")
    statics = to_torch(step_case["statics"], "cpu")
    loss, aux = make_rnr_loss_fn(m)(batch, statics,
                                    make_generator(0, "cpu"))
    loss.backward()
    want = step_case["steps"][0]
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(aux[k].detach()),
                                   float(want["aux"][k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert float(want["aux"]["loss_alb"]) > 0       # the prior is live
    grads = jax_grads_to_torch(m, want["grads"])
    assert set(grads) == {n for n, _ in m.named_parameters()}
    top = max(_max(g) for g in grads.values())
    for name, p in m.named_parameters():
        g, w = p.grad.numpy(), grads[name].numpy()
        if _gradient_blocked_by_batch_norm(name):
            assert max(_max(g), _max(w)) < 1e-6 * top, name
            continue
        assert _max(w) > 1e-6 * top, name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * _max(w),
                                   err_msg=name)
    for name in ("gcn.SNDense_0", "gcn.SNDense_1"):
        u = dict(m.named_buffers())[f"{name}.u"].numpy()
        ju = want["spectral"]["gcn"][name.split(".")[1]]["u"]
        assert not np.array_equal(
            ju, step_case["variables"]["spectral"]["gcn"][
                name.split(".")[1]]["u"])
        np.testing.assert_allclose(u, ju, rtol=0, atol=1e-5 * _max(ju))


def test_train_trajectory_3_steps_matches_optax(step_case):
    """Three make_rnr_train_step steps against optax's Adam on rnr_tpu's
    gradients: each step's loss terms to 3e-4 relative (measured 1.2e-4
    for loss_rn at the third step: Adam turns a near-zero gradient
    element, whose rounding differs, into a full-size step), every
    parameter after the third step to 3 x lr absolute, and each tensor's
    update (final - start) to 0.15 relative L2 of rnr_tpu's, over the
    elements whose rnr_tpu gradient was at least 1e-2 of its tensor's max
    in all three steps (measured up to 0.064: where the loss's L1 sign
    flips at a pixel near its target, steps 2 and 3 differ by a discrete
    amount), so that an update of 0.5x or 2x the right size fails."""
    m = _port_model(step_case)
    step = make_rnr_train_step(m, create_rnr_optimizer(m, LR))
    batch = to_torch(step_case["batch"], "cpu")
    statics = to_torch(step_case["statics"], "cpu")
    gen = make_generator(0, "cpu")
    for want in step_case["steps"]:
        met = step(batch, statics, gen)
        for k in LOSS_KEYS:
            np.testing.assert_allclose(float(met[k]), float(want["aux"][k]),
                                       rtol=3e-4, atol=1e-7, err_msg=k)
    final = load_jax_variables(_port_model(step_case), dict(
        step_case["variables"], params=step_case["final"]))
    moved = 0
    start = dict(_port_model(step_case).named_parameters())
    jgrads = [jax_grads_to_torch(m, s["grads"]) for s in step_case["steps"]]
    for (name, p), q in zip(m.named_parameters(), final.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=0, atol=3 * LR, err_msg=name)
        moved += int(not torch.equal(p, start[name]))
        if _gradient_blocked_by_batch_norm(name):
            continue
        mask = np.ones(p.shape, bool)
        for g in jgrads:
            a = np.abs(g[name].numpy())
            mask &= a >= 1e-2 * a.max()
        d0 = start[name].detach().numpy()
        dp = (p.detach().numpy() - d0)[mask]
        dq = (q.detach().numpy() - d0)[mask]
        rel = np.linalg.norm(dp - dq) / np.linalg.norm(dq)
        assert rel < 0.15, (name, rel)
    assert moved == len(start)
