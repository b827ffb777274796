"""Port parity: the K3 twin (3x3 conv) and the U-Net modules vs rnr_tpu.

The JAX conv3x3 runs in Pallas interpret mode; the JAX U-Net runs its XLA
convs (conv_backend="xla"), the port its K3 twin for every 3x3 conv.
Weights come from the JAX init, perturbed with NumPy noise so that norm
scales, biases and every kernel are exercised, then `convert`ed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnr_tpu.models.unet import RenderingNet as JaxRenderingNet
from rnr_tpu.ops.conv_pallas import conv3x3 as jax_conv3x3
from rnr_tpu_torch.convert import load_jax_variables
from rnr_tpu_torch.models.unet import RenderingNet
from rnr_tpu_torch.ops.conv_cuda import conv3x3, conv3x3_torch

torch.set_num_threads(2)


@pytest.mark.parametrize("pad_mode", ["same", "reflect"])
@pytest.mark.parametrize("c", [5, 64])
def test_conv3x3_twin_matches_jax_interpret(pad_mode, c):
    rng = np.random.default_rng(c)
    x = rng.standard_normal((1, 16, 24, c)).astype(np.float32)
    w = (rng.standard_normal((3, 3, c, 12)) / np.sqrt(9 * c)).astype(
        np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jax_conv3x3(xj, jnp.asarray(w), jnp.asarray(b),
                                  pad_mode, False, 0.2, True
                                  ).astype(jnp.float32))
    got = conv3x3(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w),
                  torch.from_numpy(b), pad_mode)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 16, 24, 12)
    # both: bf16 operands, f32 sums, bf16 output; the sums' order differs,
    # so a value may round to the neighbouring bf16 (2^-8 relative)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-2)
    assert conv3x3.launches == 0


def test_conv3x3_twin_f32_matches_xla_conv():
    """At f32 activations the twin is an exact-precision conv + bias."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, 11, 6)).astype(np.float32)
    w = rng.standard_normal((3, 3, 6, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="reflect")
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xp), jnp.asarray(w), (1, 1), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)) + b
    got = conv3x3_torch(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(b), "reflect").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _perturb(tree, rng, scale=0.1):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _perturb(v, rng, scale) for k, v in tree.items()}
    a = np.asarray(tree)
    return (a + scale * rng.standard_normal(a.shape)).astype(a.dtype)


def _jax_forward(jn, seed, x, v, rng):
    """Init (jitted: op-by-op init compiles every op), perturb, apply."""
    init = jax.jit(lambda k, x_, v_: jn.init(k, x_, v_, train=False))
    params = _perturb(jax.device_get(init(
        jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(v)))["params"],
        rng)
    want = jax.jit(lambda p, x_, v_: jn.apply({"params": p}, x_, v_,
                                              train=False))(
        params, jnp.asarray(x), jnp.asarray(v))
    return params, np.asarray(want)


def _render_nets(fuse_mode, pad_mode, dtype, nf0=4, gcn=16, cin=11, cout=6):
    kw = dict(nf0=nf0, in_channels=cin, out_channels=cout, num_down_unet=3,
              out_channels_gcn=gcn, norm="batch", compute_dtype=dtype,
              fuse_mode=fuse_mode, pad_mode=pad_mode)
    return JaxRenderingNet(conv_backend="xla", **kw), RenderingNet(**kw)


@pytest.mark.parametrize("fuse_mode,pad_mode", [
    ("dense", "reflect"), ("dense", "same"), ("concat", "reflect"),
    ("concat", "same")])
def test_rendering_net_matches_jax_f32(fuse_mode, pad_mode):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1, 32, 32, 11)).astype(np.float32)
    v = rng.standard_normal((1, 16)).astype(np.float32)
    jn, tn = _render_nets(fuse_mode, pad_mode, "float32")
    params, want = _jax_forward(jn, 0, x, v, rng)
    load_jax_variables(tn, {"params": params})
    with torch.no_grad():
        got = tn(torch.from_numpy(x), torch.from_numpy(v)).numpy()
    assert got.shape == (1, 32, 32, 6) and float(np.std(want)) > 0.05
    # f32 everywhere; conv sums and batch statistics in another order
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


def test_rendering_net_bf16_close_to_jax():
    """The shipped bf16 U-Net: the port (K3 twin, f32 sums + f32 bias) vs
    XLA's bf16 convs (+ bias in bf16).  bf16 keeps 8 bits, and at 32^2
    the innermost batch statistics span 2 x 2 pixels, so one rounding flip
    (2^-8) is amplified by the normalisation of the levels below it: the
    tanh output (|y| <= 1) is held to 1e-1 max and 1e-2 mean absolute
    error (measured: 0.066 and 0.0062; the f32 tests above are the tight
    check of the same code)."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((1, 32, 32, 11)).astype(np.float32)
    v = rng.standard_normal((1, 16)).astype(np.float32)
    jn, tn = _render_nets("dense", "reflect", "bfloat16", nf0=8)
    params, want = _jax_forward(jn, 1, x, v, rng)
    load_jax_variables(tn, {"params": params})
    with torch.no_grad():
        got = tn(torch.from_numpy(x), torch.from_numpy(v)).numpy()
    err = np.abs(got - want)
    assert err.max() < 1e-1 and err.mean() < 1e-2, (err.max(), err.mean())


# ---- K3 / K3b planning on the host (csrc/conv3x3.cu, conv3x3_wgrad.cu)

from rnr_tpu_torch.ops import conv_cuda as cc  # noqa: E402


@pytest.mark.parametrize("n,h,wd,c8,o8", [
    (1, 512, 512, 64, 64), (1, 512, 512, 112, 64), (1, 512, 512, 128, 80),
    (2, 256, 256, 128, 640), (1, 32, 32, 512, 512), (2, 7, 9, 8, 16),
    (1, 63, 62, 48, 80), (2, 1, 1, 8, 8)])
def test_k3b_plan_covers_every_unit_in_fixed_runs(n, h, wd, c8, o8):
    splits, chunk = cc.k3b_plan(n, h, wd, c8, o8)
    units = n * h * -(-wd // cc.K3B_UNIT)
    assert chunk % cc.K3B_UNIT == 0 and chunk >= cc.K3B_UNIT
    per = chunk // cc.K3B_UNIT
    # every unit in exactly one split, no split empty
    assert splits * per >= units > (splits - 1) * per
    tiles = -(-c8 // cc.K3B_CT) * -(-o8 // cc.K3B_CT)
    # at most K3B_TARGET_BLOCKS blocks: the wanted split count, less what
    # whole runs of units round away (at most half)
    want = max(1, min(units, cc.K3B_TARGET_BLOCKS // tiles))
    assert want >= splits >= -(-want // 2)
    assert splits * tiles <= max(cc.K3B_TARGET_BLOCKS, tiles)
    assert cc.k3b_plan(n, h, wd, c8, o8) == (splits, chunk)


def test_channel_padding_copies_only_ragged_counts():
    x = torch.randn(1, 3, 4, 64).to(torch.bfloat16)
    assert cc.pad_channels(x, 64) is x
    xp = cc.pad_channels(torch.randn(1, 3, 4, 108), cc.round8(108))
    assert xp.shape[-1] == 112 and bool((xp[..., 108:] == 0).all())
    assert [cc.round8(k) for k in (5, 8, 45, 77, 78, 108, 640)] == [
        8, 8, 48, 80, 80, 112, 640]


def test_k3_weights_zero_pad_and_round_once():
    w = torch.randn(3, 3, 45, 77)
    wb = cc.k3_weights(w, cc.round8(45))
    assert wb.dtype == torch.bfloat16 and wb.shape == (3, 3, 48, 80)
    assert wb.is_contiguous()
    assert torch.equal(wb[:, :, :45, :77], w.to(torch.bfloat16))
    assert not wb[:, :, 45:].any() and not wb[..., 77:].any()


def _fold_like_kernel(dxp: torch.Tensor) -> torch.Tensor:
    """What K3's pad-2 launch (rnr_conv3x3_f32out) makes of the full
    correlation dxp [N, H+2, W+2, C]: the interior written to dx, the ring
    laid out as ring_len describes, then per border-line pixel the
    additions of its fold_ring_kernel in their order."""
    n, hp, wp, c = dxp.shape
    h, wd = hp - 2, wp - 2
    dx = dxp[:, 1:-1, 1:-1].clone()
    ring = torch.cat([dxp[:, 0], dxp[:, -1], dxp[:, 1:-1, 0],
                      dxp[:, 1:-1, -1]], dim=1)
    assert ring.shape[1] == cc.ring_len(h, wd)
    top, bot = ring[:, :wd + 2], ring[:, wd + 2:2 * (wd + 2)]
    left = ring[:, 2 * (wd + 2):2 * (wd + 2) + h]      # i' = 1 .. H
    right = ring[:, 2 * (wd + 2) + h:]
    lines = {(a, b) for a in {1, h - 2} for b in range(wd)}
    lines |= {(a, b) for b in {1, wd - 2} for a in range(h)}
    for a, b in sorted(lines):
        v = dx[:, a, b].clone()
        if a == 1:
            v = v + top[:, b + 1]
        if a == h - 2:
            v = v + bot[:, b + 1]
        if b == 1:
            v = v + left[:, a]
        if b == wd - 2:
            v = v + right[:, a]
        if a == 1 and b == 1:
            v = v + top[:, 0]
        if a == 1 and b == wd - 2:
            v = v + top[:, wd + 1]
        if a == h - 2 and b == 1:
            v = v + bot[:, 0]
        if a == h - 2 and b == wd - 2:
            v = v + bot[:, wd + 1]
        dx[:, a, b] = v
    return dx


@pytest.mark.parametrize("h,wd", [(2, 2), (3, 3), (3, 5), (4, 4), (7, 9),
                                  (6, 3)])
def test_reflect_dgrad_ring_fold_is_dgrads_fold_bitwise(h, wd):
    """The kernel route's reflect dgrad (interior + ring, then the ring
    fold) adds in `_dgrad`'s order: bitwise the same dx."""
    rng = np.random.default_rng(h * 10 + wd)
    dxp = torch.from_numpy(rng.standard_normal((2, h + 2, wd + 2, 3)).astype(
        np.float32))
    g = torch.zeros(2, h, wd, 4)
    want = cc._dgrad(g, torch.zeros(3, 3, 3, 4), "reflect",
                     lambda a, k: dxp)
    assert torch.equal(_fold_like_kernel(dxp), want)


# --------------------------------------------- f32 activations, three passes


def _f32_cases():
    from rnr_tpu_torch.ops.conv4_cuda import (convt4_torch, down4_fwd,
                                              down4_torch)
    from rnr_tpu_torch.ops.conv_cuda import (conv3x3_fwd, conv3x3_wgrad,
                                             conv3x3_wgrad_torch)
    return {
        # name: (kernel stand-in on bf16 parts with an f32 output, exact
        # f32 function, operand shapes)
        "conv3x3_reflect": (
            lambda a, b, bias: conv3x3_fwd(a, b, bias, "reflect",
                                           torch.float32),
            lambda a, b, bias: conv3x3_torch(a, b, bias, "reflect"),
            (2, 12, 10, 30), (3, 3, 30, 20)),
        "conv3x3_same": (
            lambda a, b, bias: conv3x3_fwd(a, b, bias, "same",
                                           torch.float32),
            lambda a, b, bias: conv3x3_torch(a, b, bias, "same"),
            (1, 9, 16, 24), (3, 3, 24, 8)),
        "conv3x3_wgrad": (
            lambda a, b, _: conv3x3_wgrad(a, b, "reflect"),
            lambda a, b, _: conv3x3_wgrad_torch(a, b, "reflect"),
            (2, 12, 10, 30), (2, 12, 10, 20)),
        "down4": (
            lambda a, b, _: down4_fwd(a, b, "reflect", torch.float32),
            lambda a, b, _: down4_torch(a, b, "reflect"),
            (1, 16, 12, 30), (4, 4, 30, 16)),
        "convt4": (
            lambda a, b, _: convt4_torch(a, b, torch.float32),
            lambda a, b, _: convt4_torch(a, b),
            (1, 8, 6, 32), (4, 4, 32, 16)),
    }


@pytest.mark.parametrize("name", sorted(_f32_cases()))
def test_f32_by_three_computes_the_f32_function(name):
    """conv_cuda.f32_by_three, the kernels' route for f32 activations (the
    DNR U-Net; rnr_tpu's kernels keep f32 products for them), on the
    kernels' plain versions for bf16 operands with f32 outputs: within
    5e-5 of the largest value of the exact f32 function, where one bf16
    pass is off by more than 20 times as much."""
    from rnr_tpu_torch.ops.conv_cuda import f32_by_three
    one, exact, sa, sb = _f32_cases()[name]
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(sa, generator=g), torch.randn(sb, generator=g)
    bias = torch.randn(sb[-1], generator=g)
    want = exact(a, b, bias)
    got = f32_by_three(lambda ap, bp, first: one(
        ap, bp, bias if first else torch.zeros_like(bias)), a, b)
    single = one(a.to(torch.bfloat16), b.to(torch.bfloat16), bias)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert got.dtype == torch.float32 and err <= 5e-5 * scale, err / scale
    assert float((single - want).abs().max()) > 20 * err


# ------------------------------- f32 weight gradients, six passes, short runs

from test_torch_cuda import _cancelling_operands, _wgrad_f64  # noqa: E402


@pytest.mark.parametrize("wgrad", ["conv3x3_wgrad", "conv3x3s_wgrad"])
def test_f32_weight_gradient_holds_where_sums_cancel(wgrad):
    """conv_cuda.f32_by_six, the f32 route of K3b and K8b, on the
    wrappers' plain versions for bf16 parts (exact products, f32 sums):
    within 5e-5 of the largest exact dW on operands whose sums cancel,
    under the U-Net's reflect padding (a zero ring leaves its edge taps
    sums that do not cancel), where f32_by_three (the forward's route)
    misses that limit."""
    pad_mode = "reflect"
    one_kernel = getattr(cc, wgrad)
    x, gy = _cancelling_operands((1, 32, 32, 30), 16, 0)
    want = _wgrad_f64(x, gy, pad_mode)
    scale = float(want.abs().max())

    def one(a, b, _):
        return one_kernel(a, b, pad_mode)

    def rel(t):
        return float((t.to(torch.float64) - want).abs().max()) / scale

    six, three = cc.f32_by_six(one, x, gy), cc.f32_by_three(one, x, gy)
    assert six.dtype == torch.float32 and rel(six) <= 5e-5, rel(six)
    assert rel(three) > 5e-5, rel(three)
    assert rel(one_kernel(x.to(torch.bfloat16), gy.to(torch.bfloat16),
                          pad_mode)) > 1e-2


def test_split_bf16_parts_sum_to_the_tensor():
    """Three bf16 parts hold every bit of an f32 tensor (normal range);
    two hold all but the lowest 8 of the 24."""
    t = torch.randn(4096, generator=torch.Generator().manual_seed(1))
    p3 = cc.split_bf16(t, 3)
    assert all(p.dtype == torch.bfloat16 for p in p3)
    s3 = sum(p.to(torch.float64) for p in p3)
    assert torch.equal(s3, t.to(torch.float64))
    s2 = sum(p.to(torch.float64) for p in cc.split_bf16(t))
    assert float(((s2 - t.to(torch.float64)) / t).abs().max()) <= 2 ** -17


@pytest.mark.parametrize("plan", ["k3b_plan", "k8b_plan"])
@pytest.mark.parametrize("n,h,wd,c8,o8", [
    (1, 512, 512, 32, 64), (1, 512, 512, 64, 64), (1, 128, 128, 256, 256),
    (1, 32, 32, 512, 512), (2, 7, 9, 8, 16)])
def test_f32_wgrad_runs_are_short(plan, n, h, wd, c8, o8):
    """The f32 weight gradients' plans: runs of at most F32_WGRAD_PER
    units of 64 columns, every unit in exactly one, none empty; the
    default plan where its runs are shorter already."""
    fn = getattr(cc, plan)
    units = n * h * -(-wd // cc.K3B_UNIT)
    splits, run = fn(n, h, wd, c8, o8, max_per=cc.F32_WGRAD_PER)
    per = run // cc.K3B_UNIT if plan == "k3b_plan" else run
    assert 1 <= per <= cc.F32_WGRAD_PER
    assert splits * per >= units > (splits - 1) * per
    d_splits, d_run = fn(n, h, wd, c8, o8)
    d_per = d_run // cc.K3B_UNIT if plan == "k3b_plan" else d_run
    if d_per <= cc.F32_WGRAD_PER:
        assert (splits, run) == (d_splits, d_run)
