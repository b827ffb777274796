"""Port parity of the U-Net's 4x4 stride-2 pair vs rnr_tpu: the plain
versions of K6 (down4, convt4) and K8's 4x4 pair (down4s, convt4s), their
four autograd.Functions, and group norm.

rnr_tpu's down4 / convt4 / down4s / convt4s run their Pallas kernels in
interpret mode; on the CPU the port's wrappers run the plain versions
(`down4_torch`, `convt4_torch`, one per function, for both formulations),
and launch nothing.  Gradients are held against jax.grad through
rnr_tpu's custom VJPs.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnr_tpu.ops import conv_pallas as jcp
from rnr_tpu_torch.models.unet import GroupNorm
from rnr_tpu_torch.ops import conv4_cuda as c4

torch.set_num_threads(2)

CO = [(4, 5), (5, 7), (7, 4)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, shape, c, o):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape + (c,)).astype(np.float32)
    w = (rng.standard_normal((4, 4, c, o)) / np.sqrt(16 * c)).astype(
        np.float32)
    return x, w


def _tol(want: np.ndarray, dtype: str) -> float:
    """f32: 1e-5 of the largest magnitude (f32 sums in another order).
    bf16: both sides sum bf16 products in f32 and round once, so a value
    may round to its neighbour: one bf16 step (2^-7 of the leading power
    of two) at the largest magnitude."""
    scale = float(np.abs(want).max())
    if dtype == "float32":
        return 1e-5 * scale
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


@pytest.mark.parametrize("c,o", CO)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("pad_mode", ["same", "reflect"])
def test_down4_plain_matches_down4_and_down4s(pad_mode, dtype, c, o):
    """15 x 16 (odd H): rnr_tpu's kernels and the port give H//2 rows."""
    x, w = _inputs(c * 10 + o, (1, 15, 16), c, o)
    jdt, tdt = DTYPES[dtype]
    xj, wj = jnp.asarray(x).astype(jdt), jnp.asarray(w)
    got = c4.down4_torch(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                         pad_mode)
    assert got.dtype == tdt and got.shape == (1, 7, 8, o)
    for fn in (jcp.down4, jcp.down4s):
        want = np.asarray(fn(xj, wj, pad_mode, True).astype(jnp.float32))
        assert want.shape == (1, 7, 8, o)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=_tol(want, dtype),
                                   err_msg=fn.__name__)


@pytest.mark.parametrize("c,o", CO)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_convt4_plain_matches_convt4_and_convt4s(dtype, c, o):
    x, w = _inputs(c * 10 + o + 1, (1, 15, 16), c, o)
    jdt, tdt = DTYPES[dtype]
    xj, wj = jnp.asarray(x).astype(jdt), jnp.asarray(w)
    got = c4.convt4_torch(torch.from_numpy(x).to(tdt), torch.from_numpy(w))
    assert got.dtype == tdt and got.shape == (1, 30, 32, o)
    for fn in (jcp.convt4, jcp.convt4s):
        want = np.asarray(fn(xj, wj, True).astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=_tol(want, dtype),
                                   err_msg=fn.__name__)


def test_plain_versions_write_the_asked_output_dtype():
    x, w = _inputs(3, (2, 8, 6), 5, 4)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    for y in (c4.down4_fwd(xb, torch.from_numpy(w), "reflect",
                           torch.float32),
              c4.convt4s_fwd(xb, torch.from_numpy(w), torch.float32)):
        assert y.dtype == torch.float32
    # the f32 output is the bf16 one before its rounding
    f32 = c4.convt4_fwd(xb, torch.from_numpy(w), torch.float32)
    np.testing.assert_array_equal(
        f32.to(torch.bfloat16).float().numpy(),
        c4.convt4_fwd(xb, torch.from_numpy(w)).float().numpy())
    assert c4.down4.launches == c4.convt4.launches == 0
    assert c4.down4s.launches == c4.convt4s.launches == 0


# (name, port function, rnr_tpu function, takes pad_mode)
FUNCTIONS = [("down4", c4.down4, jcp.down4, True),
             ("down4s", c4.down4s, jcp.down4s, True),
             ("convt4", c4.convt4, jcp.convt4, False),
             ("convt4s", c4.convt4s, jcp.convt4s, False)]


@pytest.mark.parametrize("pad_mode", ["same", "reflect"])
@pytest.mark.parametrize("name,port,ref,padded", FUNCTIONS,
                         ids=[f[0] for f in FUNCTIONS])
def test_autograd_functions_match_jax_grad(name, port, ref, padded,
                                           pad_mode):
    """dx and dw of sum(f(x, w) * g) against jax.grad through rnr_tpu's
    custom VJPs (interpret mode), f32, each scaled by its largest
    magnitude as tests/test_conv_pallas.py does and held to 1e-5 (f32
    sums in another order).  The transpose convs
    have no padding mode: both values run the same case."""
    x, w = _inputs(len(name) + len(pad_mode), (2, 8, 12), 5, 7)
    pm = (pad_mode,) if padded else ()
    rng = np.random.default_rng(9)
    out_shape = (2, 4, 6, 7) if padded else (2, 16, 24, 7)
    g = rng.standard_normal(out_shape).astype(np.float32)
    jx, jw = jax.grad(
        lambda x_, w_: jnp.sum(ref(x_, w_, *pm, True) * g),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = port(xt, wt, *pm)
    assert y.shape == out_shape
    (y * torch.from_numpy(g)).sum().backward()
    for got, want, what in ((xt.grad, jx, "dx"), (wt.grad, jw, "dw")):
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy() / scale, want / scale,
                                   rtol=0, atol=1e-5, err_msg=what)


@pytest.mark.parametrize("name,port", [("down4", c4.down4),
                                       ("down4s", c4.down4s)])
def test_down_backward_rounds_where_rnr_tpu_does(name, port):
    """bf16 activations under "same": dx is the f32-output transpose conv
    of g with the flipped, io-swapped kernel, rounded once to bf16; dw is
    the bf16 conv's weight gradient (rounded to bf16), returned in f32,
    within one bf16 step of the f32 one."""
    x, w = _inputs(11, (1, 8, 8), 8, 16)
    rng = np.random.default_rng(12)
    g = torch.from_numpy(rng.standard_normal((1, 4, 4, 16)).astype(
        np.float32)).to(torch.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    port(xt, wt, "same").backward(g)
    assert xt.grad.dtype == torch.bfloat16 and wt.grad.dtype == torch.float32
    w_dx = torch.from_numpy(w).flip(0, 1).transpose(2, 3)     # [4, 4, O, C]
    want_dx = c4.convt4_torch(g, w_dx, torch.float32).to(torch.bfloat16)
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  want_dx.float().numpy())
    assert torch.equal(wt.grad, wt.grad.to(torch.bfloat16).float())
    xf = xt.detach().float().requires_grad_()
    wf = torch.from_numpy(w).to(torch.bfloat16).float().requires_grad_()
    c4.down4_torch(xf, wf, "same").backward(g.float())
    dw = wf.grad.numpy()
    np.testing.assert_allclose(wt.grad.numpy(), dw, rtol=0,
                               atol=_tol(dw, "bfloat16"))


def test_down4_same_backward_needs_even_sizes():
    """At odd sizes rnr_tpu's VJP fails in both pad modes (its XLA convs
    give ceil(H/2) rows against the forward's H//2).  Under "same" the
    port's transpose conv would give 2 (H//2) rows, so it raises with the
    reason; under reflect the plain conv's gradient takes any size."""
    x, w = _inputs(5, (1, 15, 16), 4, 4)
    xt = torch.from_numpy(x).requires_grad_()
    with pytest.raises(ValueError, match="even H and W"):
        c4.down4(xt, torch.from_numpy(w), "same").sum().backward()
    c4.down4s(xt, torch.from_numpy(w), "reflect").sum().backward()
    assert xt.grad.shape == xt.shape


def test_pad_mode_is_checked():
    x, w = _inputs(6, (1, 8, 8), 4, 4)
    with pytest.raises(ValueError, match="pad_mode"):
        c4.down4(torch.from_numpy(x), torch.from_numpy(w), "zeros")
    with pytest.raises(ValueError, match="pad_mode"):
        c4.down4s_fwd(torch.from_numpy(x), torch.from_numpy(w), "wrap")


# ------------------------------------------------------------ group norm


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("c", [16, 48])
def test_group_norm_matches_flax(dtype, c):
    """flax nn.GroupNorm(num_groups=None, group_size=16): epsilon 1e-6,
    f32 statistics, and an f32 output for bf16 input too.  Held to 1e-5
    of the largest magnitude (f32 sums in another order)."""
    rng = np.random.default_rng(c)
    x = (2.0 + 3.0 * rng.standard_normal((2, 6, 5, c))).astype(np.float32)
    scale = (1 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(c)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    ref = fnn.GroupNorm(num_groups=None, group_size=16)
    want = ref.apply({"params": {"scale": scale, "bias": bias}},
                     jnp.asarray(x).astype(jdt))
    gn = GroupNorm(c)
    with torch.no_grad():
        gn.scale.copy_(torch.from_numpy(scale))
        gn.bias.copy_(torch.from_numpy(bias))
        got = gn(torch.from_numpy(x).to(tdt))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
    with pytest.raises(ValueError, match="group size"):
        GroupNorm(c + 8)


# ---- K8's plan and tiling on the host (csrc/conv4x4_slab.cu)

# (N, H, W, c8, O, up): the frame's five down convs, their f32 dgrads
# and five transpose convs at 512^2, then the unit tests' shapes, N = 2
# with a row count no tile divides, odd W, and a 16-wide C = O = 512
K8_SHAPES = [
    (1, 512, 512, 64, 128, False), (1, 256, 256, 128, 256, False),
    (1, 128, 128, 256, 512, False), (1, 64, 64, 512, 512, False),
    (1, 32, 32, 512, 512, False), (1, 64, 64, 512, 1024, False),
    (1, 128, 128, 256, 1024, False), (1, 256, 256, 128, 512, False),
    (1, 512, 512, 64, 256, False), (1, 16, 16, 512, 512, True),
    (1, 32, 32, 1024, 512, True), (1, 64, 64, 1024, 256, True),
    (1, 128, 128, 512, 128, True), (1, 256, 256, 256, 64, True),
    (2, 10, 12, 8, 7, False), (2, 7, 150, 16, 24, True),
    (2, 5, 9, 40, 130, False), (2, 18, 34, 64, 72, True),
    (2, 14, 14, 8, 8, False), (1, 64, 63, 64, 64, False),
    (1, 45, 77, 64, 64, True), (2, 16, 16, 512, 512, False),
    (2, 16, 16, 512, 512, True)]


def _plan_tiles(n, h, wd, o, up, bn, wgs, sw):
    gh, gw = (h, wd) if up else (h // 2, wd // 2)
    rows = 64 * wgs // sw
    return (-(-gw // sw) * -(-(n * gh) // rows) * -(-o // bn)
            * (2 if up else 1))


@pytest.mark.parametrize("n,h,wd,c8,o,up", K8_SHAPES)
def test_conv4s_plan_covers_every_unit_in_fixed_runs(n, h, wd, c8, o, up):
    """Every unit in exactly one split, no split empty, runs of at least
    K8_MIN_UNITS where there is more than one; at most one wave of tiles
    where K is split; tiles of 64 rows a warpgroup in whole row segments;
    the same plan on every call (a rerun adds in one order)."""
    bn, wgs, sw, splits, per = c4.conv4s_plan(n, h, wd, c8, o, up)
    assert bn in (64, 128) and wgs in (1, 2)
    assert bn == 64 or o > 64
    gw = wd if up else wd // 2
    units = (4 if up else 8) * -(-c8 // c4.K8_UNIT)
    assert splits * per >= units > (splits - 1) * per
    assert splits == 1 or per >= c4.K8_MIN_UNITS
    tiles = _plan_tiles(n, h, wd, o, up, bn, wgs, sw)
    assert splits == 1 or tiles * splits <= c4.K8_TARGET_BLOCKS
    if gw <= 32:     # short rows: 64 / sw whole rows a tile
        assert wgs == 1 and sw in (16, 32) and sw >= gw and 64 % sw == 0
    else:            # segments of 64 or 128 positions, 1 or 2 a tile
        assert sw in (64, 128) and sw <= 64 * wgs and (sw == 64 or gw >= 128)
    assert c4.conv4s_plan(n, h, wd, c8, o, up) == (bn, wgs, sw, splits, per)


def _k8_emulate(x: np.ndarray, w: np.ndarray, up: bool, reflect: bool,
                plan) -> np.ndarray:
    """csrc/conv4x4_slab.cu's arithmetic in float64, block by block: each
    unit's two taps from the weight map's coordinates (w as [8][2][C][O],
    tap row * 2 + kx // 2, kx % 2), its bands from the tensor maps'
    (down4s: x's even or odd columns; zeros outside; reflect rows by
    index and the patched columns), products summed per split and the
    splits in order."""
    bn, wgs, sw, splits, per = plan
    n, h, wd, c = x.shape
    o = w.shape[-1]
    c8 = -(-c // 8) * 8
    c64 = -(-c8 // 64) * 64     # TMA's zeros past C
    xp = np.zeros((n, h, wd, c64))
    xp[..., :c] = x
    wv = np.zeros((4, 4, c64, o))
    wv[:, :, :c] = w
    wv = wv.reshape(8, 2, c64, o)
    gh, gw = (h, wd) if up else (h // 2, wd // 2)
    bm = 64 * wgs
    rows = bm // sw
    t_units = 4 if up else 8
    units = t_units * -(-c8 // 64)
    maps = ([xp] if up else [xp[:, :, 0::2], xp[:, :, 1::2]])
    out_shape = (n, 2 * h, 2 * wd, o) if up else (n, gh, gw, o)
    parts = np.zeros((splits,) + out_shape)

    wide = sw >= 64    # one band of sw + 1 a segment, else a box a tap

    def band(xm, img, xr, col):   # sw + 1 or sw positions from col
        cnt = sw + 1 if wide else sw
        b = np.zeros((cnt, c64))
        if 0 <= img < n and 0 <= xr < h:
            for q in range(cnt):
                if 0 <= col + q < xm.shape[2]:
                    b[q] = xm[img, xr, col + q]
        return b

    for a in (0, 1) if up else (0,):
        for r0 in range(0, n * gh, rows):
            for j0 in range(0, gw, sw):
                for s in range(splits):
                    acc = np.zeros((2 if up else 1, bm, o))
                    for u in range(s * per, min(s * per + per, units)):
                        ch, hi, lo = u // t_units, (u % t_units) >> 1, u & 1
                        cs = slice(64 * ch, 64 * ch + 64)
                        taps = ([wv[2 * (a + 2 * hi) + lo, i]
                                 for i in (0, 1)] if up else
                                [wv[2 * hi + i, lo] for i in (0, 1)])
                        xm = maps[0] if up or lo == 1 else maps[1]
                        col = j0 - 1 + lo if up else (j0 - 1 if lo == 0
                                                      else j0)
                        tiles = [np.zeros((bm, 64)), np.zeros((bm, 64))]
                        for k in range(rows):
                            img, i = divmod(r0 + k, gh)
                            xr = i + a + hi - 1 if up else 2 * i + hi - 1
                            if reflect:
                                xr = -xr if xr < 0 else (
                                    2 * h - 2 - xr if xr >= h else xr)
                            if wide:
                                bd = band(xm, img, xr, col)[:, cs]
                                tl = [bd[:sw], bd[1:sw + 1]]
                            else:
                                tl = [band(xm, img, xr, col + t)[:, cs]
                                      for t in (0, 1)]
                            seg = slice(k * sw, k * sw + sw)
                            for t in (0, 1):
                                tiles[t][seg] = tl[t]
                            if reflect and lo == 0 and j0 == 0:
                                tiles[0][k * sw] = tiles[1][k * sw]
                            pr = gw - 1 - j0
                            if reflect and lo == 1 and wd % 2 == 0 \
                                    and pr < sw:
                                tiles[1][k * sw + pr] = tiles[0][k * sw + pr]
                        for t in (0, 1):
                            acc[t if up else 0] += tiles[t] @ taps[t][cs]
                    for m in range(bm):
                        k, jj = divmod(m, sw)
                        if r0 + k >= n * gh or j0 + jj >= gw:
                            continue
                        img, i = divmod(r0 + k, gh)
                        j = j0 + jj
                        if up:
                            for b in (0, 1):
                                parts[s, img, 2 * i + a, 2 * j + b] = acc[b, m]
                        else:
                            parts[s, img, i, j] = acc[0, m]
    y = parts[0]
    for s in range(1, splits):
        y = y + parts[s]
    return y


@pytest.mark.parametrize("n,h,wd,c,o,up,pad_mode,tile", [
    (2, 10, 12, 5, 7, False, "reflect", None),
    (2, 10, 12, 5, 7, False, "same", None),
    (1, 9, 9, 8, 9, False, "reflect", None),
    (2, 8, 70, 16, 5, False, "reflect", None),
    (1, 7, 132, 8, 3, False, "reflect", (2, 128)),
    (1, 5, 260, 8, 3, False, "reflect", (2, 64)),
    (2, 5, 9, 40, 6, True, None, None), (1, 6, 40, 72, 4, True, None, None),
    (1, 4, 66, 8, 5, True, None, None), (1, 3, 132, 8, 5, True, None, (2, 64)),
    (1, 3, 131, 8, 5, True, None, (2, 128))])
def test_k8_tiling_computes_the_plain_conv(n, h, wd, c, o, up, pad_mode,
                                           tile):
    """The kernel's decomposition, emulated in float64 with its plan or
    the (wgs, sw) given (short-row tiles, one-row and two-row tiles of 64
    and 128 positions, odd W and H, even W under reflect, split K, ragged
    C and O), gives the plain
    version's output within 1e-5 of its max (the plain version sums in
    float32): a tap, band position or patch out of place moves an output
    by a product, orders of magnitude more."""
    rng = np.random.default_rng(h * wd + c)
    x = rng.standard_normal((n, h, wd, c))
    w = rng.standard_normal((4, 4, c, o)) / np.sqrt(16 * c)
    plan = c4.conv4s_plan(n, h, wd, -(-c // 8) * 8, o, up)
    if tile:
        plan = (plan[0], *tile) + plan[3:]
    got = _k8_emulate(x, w, up, pad_mode == "reflect", plan)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    want = (c4.convt4_torch(xt, wt) if up
            else c4.down4_torch(xt, wt, pad_mode)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# ---- K6's plan and tiling on the host (csrc/conv4x4.cu)


@pytest.mark.parametrize("n,h,wd,c8,o,up", K8_SHAPES)
def test_conv4_plan_covers_every_unit_in_fixed_runs(n, h, wd, c8, o, up):
    """Every unit (a parity plane's or an output row parity's 64 channels)
    in exactly one split, no split empty, runs of at least K6_MIN_UNITS
    where there is more than one, convt4's of whole 64-channel chunks (both
    output row parities); at most one wave of tiles where K is
    split; tiles of 64 rows a warpgroup in whole row segments of one
    image; BN 64 for convt4 (four accumulators); the same plan on every
    call (a rerun adds in one order)."""
    bn, wgs, sw, splits, per = c4.conv4_plan(n, h, wd, c8, o, up)
    assert bn in (64, 128) and wgs in (1, 2)
    assert bn == 64 or (not up and o > 64)
    gh, gw = (h, wd) if up else (h // 2, wd // 2)
    units = (2 if up else 4) * -(-c8 // c4.K8_UNIT)
    assert splits * per >= units > (splits - 1) * per
    assert splits == 1 or per >= c4.K6_MIN_UNITS
    assert not up or per % 2 == 0     # convt4: whole chunks a run
    rows = 64 * wgs // sw
    assert rows * sw == 64 * wgs
    tiles = n * -(-gh // rows) * -(-gw // sw) * -(-o // bn)
    assert splits == 1 or tiles * splits <= c4.K8_TARGET_BLOCKS
    if gw <= 32:     # short rows: 64 / sw whole rows a tile
        assert wgs == 1 and sw in (16, 32) and sw >= gw
    else:            # segments of 64 positions, 1 or 2 a tile
        assert sw == 64
    assert c4.conv4_plan(n, h, wd, c8, o, up) == (bn, wgs, sw, splits, per)


def _k6_emulate(x: np.ndarray, w: np.ndarray, up: bool, reflect: bool,
                plan) -> np.ndarray:
    """csrc/conv4x4.cu's arithmetic in float64, tile by tile: each unit's
    taps from the weight map's boxes (w as [8][2][C][O], 2 ky + kx // 2,
    kx % 2: down4 boxes (pc, 2 ky .. + 1), convt4 (0 .. 1, 2 ky .. + 1)),
    its band of R + 1 rows from the tensor maps (down4: x's rows and
    columns of parity (1 - pr, 1 - pc), row by index, reflected; zeros
    outside; the patched columns), each tap's 64 rows at its band
    position, products summed per split and the splits in order."""
    bn, wgs, sw, splits, per = plan
    n, h, wd, c = x.shape
    o = w.shape[-1]
    c8 = -(-c // 8) * 8
    c64 = -(-c8 // 64) * 64     # TMA's zeros past C
    xp = np.zeros((n, h, wd, c64))
    xp[..., :c] = x
    wm = np.zeros((4, 4, c64, o))
    wm[:, :, :c] = w
    wm = wm.reshape(8, 2, c64, o)
    gh, gw = (h, wd) if up else (h // 2, wd // 2)
    bm = 64 * wgs
    rows = bm // sw
    e_ = 2 if up else 1         # a band row's extra positions
    upc = 2 if up else 4        # units of a chunk
    units = upc * (c64 // 64)
    wide = sw >= 64
    segr = -(-(sw + e_) // 8) * 8
    maps = ([xp] if up else
            [xp[:, q // 2::2, q % 2::2] for q in range(4)])
    out_shape = (n, 2 * h, 2 * wd, o) if up else (n, gh, gw, o)
    parts = np.zeros((splits,) + out_shape)

    def box(xm, img, row, col, cnt):   # cnt positions from col, zeros out
        b = np.zeros((cnt, c64))
        if 0 <= row < xm.shape[1]:
            for q in range(cnt):
                if 0 <= col + q < xm.shape[2]:
                    b[q] = xm[img, row, col + q]
        return b

    def band_pos(cb, kk, pos):
        if wide:
            return kk * segr + pos + cb
        return (cb * (rows + 1) + kk) * sw + pos

    nband = (rows + 1) * segr if wide else (e_ + 1) * (rows + 1) * sw
    for img in range(n):
        for i0 in range(0, gh, rows):
            for j0 in range(0, gw, sw):
                for s in range(splits):
                    acc = np.zeros((4 if up else 1, bm, o))
                    for u in range(s * per, min(s * per + per, units)):
                        ch, sub = divmod(u, upc)
                        cs = slice(64 * ch, 64 * ch + 64)
                        pr, pc = sub >> 1, sub & 1
                        if up:   # slot 4 r + kx: tap (sub + 2 r, kx)
                            taps = [wm[2 * (sub + 2 * (sl >> 2))
                                       + (sl & 3) // 2, (sl & 3) % 2, cs]
                                    for sl in range(8)]
                        else:    # slot 2 a + b: tap (pr + 2 a, pc + 2 b)
                            taps = [wm[2 * (pr + 2 * (sl >> 1)) + (sl & 1),
                                       pc, cs] for sl in range(4)]
                        xm = maps[0] if up else maps[(1 - pr) * 2 + 1 - pc]
                        col = j0 - 1 if up else j0 + pc - 1
                        band = np.zeros((nband, c64))
                        for kk in range(rows + 1):
                            if up:
                                xr = i0 + kk + sub - 1
                            else:
                                r = 2 * (i0 + kk) + pr - 1
                                if reflect:
                                    r = -r if r < 0 else (
                                        2 * h - 2 - r if r >= h else r)
                                xr = (r - (1 - pr)) // 2
                            if wide:
                                p0 = band_pos(0, kk, 0)
                                band[p0:p0 + sw + e_] = box(
                                    xm, img, xr, col, sw + e_)
                            else:
                                for cb in range(e_ + 1):
                                    p0 = band_pos(cb, kk, 0)
                                    band[p0:p0 + sw] = box(
                                        xm, img, xr, col + cb, sw)
                        pright = gw - 1 - j0
                        for kk in range(rows + 1):
                            if reflect and not up and pc == 0 and j0 == 0:
                                band[band_pos(0, kk, 0)] = \
                                    band[band_pos(1, kk, 0)]
                            if (reflect and not up and pc == 1
                                    and wd % 2 == 0 and pright < sw):
                                band[band_pos(1, kk, pright)] = \
                                    band[band_pos(0, kk, pright)]
                        band = band[:, cs]
                        for wg in range(wgs):
                            k, pos = divmod(64 * wg, sw)
                            rs = slice(64 * wg, 64 * wg + 64)
                            for sl, tap in enumerate(taps):
                                if up:
                                    r, kx = sl >> 2, sl & 3
                                    a0 = band_pos((kx & 1) + (kx >> 1),
                                                  k + r, pos)
                                    p = 2 * sub + (kx & 1)
                                else:
                                    a0 = band_pos(sl & 1, k + (sl >> 1), pos)
                                    p = 0
                                acc[p, rs] += band[a0:a0 + 64] @ tap
                    for m in range(bm):
                        k, jj = divmod(m, sw)
                        i, j = i0 + k, j0 + jj
                        if i >= gh or j >= gw:
                            continue
                        if up:
                            for p in range(4):
                                parts[s, img, 2 * i + p // 2,
                                      2 * j + p % 2] = acc[p, m]
                        else:
                            parts[s, img, i, j] = acc[0, m]
    y = parts[0]
    for s in range(1, splits):
        y = y + parts[s]
    return y


@pytest.mark.parametrize("n,h,wd,c,o,up,pad_mode,tile", [
    (2, 10, 12, 5, 7, False, "reflect", None),
    (2, 10, 12, 5, 7, False, "same", None),
    (1, 9, 9, 8, 9, False, "reflect", None),
    (1, 9, 11, 8, 9, False, "same", None),
    (2, 8, 70, 16, 5, False, "reflect", None),
    (1, 7, 132, 8, 3, False, "reflect", (2, 64)),
    (1, 8, 8, 136, 9, False, "reflect", None),
    (1, 6, 10, 24, 130, False, "same", None),
    (2, 5, 9, 40, 6, True, None, None), (1, 6, 40, 72, 4, True, None, None),
    (1, 4, 66, 8, 5, True, None, None), (1, 3, 131, 8, 5, True, None, (2, 64)),
    (1, 6, 12, 200, 4, True, None, None)])
def test_k6_tiling_computes_the_plain_conv(n, h, wd, c, o, up, pad_mode,
                                           tile):
    """K6's decomposition, emulated in float64 with its plan or the (wgs,
    sw) given (the four parity-plane maps and their offsets, the four
    taps a down4 band serves, the reflect rows by index and the patched
    columns, convt4's four parities from one band, short-row tiles and
    two-row tiles of 64 positions, split K, ragged C and O, odd H and W),
    gives the plain version's output within 1e-5 of its max (the plain
    version sums in float32): a tap, band position or patch out of place
    moves an output by a product, orders of magnitude more."""
    rng = np.random.default_rng(h * wd + c)
    x = rng.standard_normal((n, h, wd, c))
    w = rng.standard_normal((4, 4, c, o)) / np.sqrt(16 * c)
    plan = c4.conv4_plan(n, h, wd, -(-c // 8) * 8, o, up)
    if tile:
        plan = (plan[0], *tile) + plan[3:]
    got = _k6_emulate(x, w, up, pad_mode == "reflect", plan)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    want = (c4.convt4_torch(xt, wt) if up
            else c4.down4_torch(xt, wt, pad_mode)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
