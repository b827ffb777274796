"""Port parity of P1, the GEMM chain of tools/tpu_probe_r5.py: the plain
version `gemm_chain_torch` against the probe's XLA twin `gemm_chain_xla`
and against its Pallas kernel `_gemm_chain_kernel`, run here through
pl.pallas_call in interpret mode (the probe's own `gemm_chain_pallas`
takes no interpret flag).  The probe is loaded from its path.  Then the
kernel's plan (`gemm_chain_plan`) and a float64 emulation of its tiling
against the plain version.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rnr_tpu_torch.ops.gemm_chain_cuda import (GEMM_MAX_WST, GEMM_MAX_XST,
                                               SMEM_LIMIT, gemm_chain,
                                               gemm_chain_plan,
                                               gemm_chain_smem,
                                               gemm_chain_torch)

torch.set_num_threads(2)

PROBE = Path(__file__).resolve().parent.parent / "tools" / "tpu_probe_r5.py"
# (M, K, N, T, rows of the Pallas kernel's tile, dividing M): section A's
# kinds of shape at a small M, and odd sizes that are no multiple of 8
SHAPES = [(256, 64, 64, 9, 64), (128, 192, 128, 9, 32), (64, 512, 64, 4, 64),
          (40, 24, 40, 3, 8), (21, 13, 11, 2, 7)]


@pytest.fixture(scope="module")
def probe():
    """tools/tpu_probe_r5.py as a module.  It sets JAX_COMPILATION_CACHE_DIR
    with setdefault when imported: set first, so that the process keeps
    its own environment."""
    mp = pytest.MonkeyPatch()
    mp.setenv("JAX_COMPILATION_CACHE_DIR", "")
    spec = importlib.util.spec_from_file_location("tpu_probe_r5", PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mp.undo()
    return mod


def _inputs(seed, m, k, n, t):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((t, k, n)) / np.sqrt(k * t)).astype(np.float32)
    return (jnp.asarray(x).astype(jnp.bfloat16),
            jnp.asarray(w).astype(jnp.bfloat16))


def _bf16_step(want: np.ndarray) -> float:
    """Both sides sum exact bf16 products in f32 (in another order) and
    round once to bf16: a value may land on its neighbour, one bf16 step
    (2^-7 of the leading power of two) at the largest magnitude."""
    return 2.0 ** (np.floor(np.log2(float(np.abs(want).max()))) - 7)


def _torch(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16)


@pytest.mark.parametrize("m,k,n,t,rows", SHAPES)
def test_gemm_chain_plain_matches_probe(probe, m, k, n, t, rows):
    x, w = _inputs(m + k + n + t, m, k, n, t)
    got = gemm_chain(_torch(x), _torch(w))
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    assert gemm_chain.launches == 0          # the CPU takes the plain version
    got = got.float().numpy()
    want_xla = np.asarray(probe.gemm_chain_xla(x, w).astype(jnp.float32))
    np.testing.assert_allclose(got, want_xla, rtol=0,
                               atol=_bf16_step(want_xla))
    want_pallas = pl.pallas_call(
        probe._gemm_chain_kernel(rows, k, n, t),
        grid=(m // rows,),
        in_specs=[pl.BlockSpec((rows, k), lambda i: (i, 0)),
                  pl.BlockSpec((t, k, n), lambda i: (0, 0, 0))],
        out_specs=pl.BlockSpec((rows, n), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((m, n), jnp.bfloat16),
        interpret=True)(x, w)
    want_pallas = np.asarray(want_pallas.astype(jnp.float32))
    np.testing.assert_allclose(got, want_pallas, rtol=0,
                               atol=_bf16_step(want_pallas))


def test_gemm_chain_f32_inputs_and_shape_check():
    """The plain version takes f32 inputs as given (the kernel only
    bf16): one rounding of the f32 sum; malformed shapes raise."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((6, 5)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 5, 4)).astype(np.float32))
    want = (x.double() @ w.double()).sum(0).float().to(torch.bfloat16)
    got = gemm_chain(x, w)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=0, atol=_bf16_step(want.float().numpy()))
    with pytest.raises(ValueError, match="gemm_chain"):
        gemm_chain(x, w[:, :4])
    with pytest.raises(ValueError, match="gemm_chain"):
        gemm_chain(x[None], w)


# ------------------------------------- P1's plan and tiling (csrc/gemm_chain.cu)

# (K, N, T) of tools/tpu_probe_r5.py's section A, as chip_smoke.py runs them
SECTION_A = [(64, 64, 9), (128, 64, 9), (192, 64, 9), (64, 128, 9),
             (128, 128, 9), (192, 128, 9), (256, 256, 9), (512, 512, 4)]
ODD = [(21, 13, 11, 2), (40, 24, 40, 3), (129, 40, 70, 3), (77, 13, 11, 2)]


def _section_a_rows(k, n, t):
    """M of a section A shape: 16 tiles of the rows that fit the probe's
    13 MB VMEM model (chip_smoke.py's gemm_rows)."""
    rows = 8320
    while (2 * rows * k * 2 + t * k * n * 2 + rows * n * 4
           + 2 * rows * n * 2) > 13 * 1024 * 1024:
        rows //= 2
    return 16 * rows


def _r8(v):
    return -(-v // 8) * 8


def _walk(m, n, plan):
    """(block, m0, n0) of each tile, in the order block b walks tiles b,
    b + grid, .. (n tile fastest), block by block."""
    bn, mw, _, _, _, grid = plan
    bm = 128 * mw
    n_tiles = -(-_r8(n) // bn)
    tiles = -(-m // bm) * n_tiles
    return [(b, tile // n_tiles * bm, tile % n_tiles * bn)
            for b in range(grid) for tile in range(b, tiles, grid)]


@pytest.mark.parametrize("m,k,n,t", [(_section_a_rows(k, n, t), k, n, t)
                                     for k, n, t in SECTION_A] + ODD)
def test_gemm_chain_plan_covers_each_output_once(m, k, n, t):
    """BN follows N (64, 128, then 256), MW 2 below BN 256; the persistent
    walk covers every output of [M, N] exactly once; rings of 2..4 x
    stages and 2..8 w stages (none where w is resident, which needs one n
    tile); the launch's shared memory within the 227 KB of a block; one
    block an SM, at most one a tile."""
    plan = gemm_chain_plan(m, k, n, t)
    bn, mw, res, xst, wst, grid = plan
    assert bn == (64 if _r8(n) <= 64 else 128 if _r8(n) <= 128 else 256)
    assert mw == (1 if bn == 256 else 2)
    assert 2 <= xst <= GEMM_MAX_XST
    if res:
        assert wst == 0 and -(-_r8(n) // bn) == 1
    else:
        assert 2 <= wst <= GEMM_MAX_WST
    assert gemm_chain_smem(*plan[:5], _r8(k), t) <= SMEM_LIMIT
    bm = 128 * mw
    tiles = _walk(m, n, plan)
    assert grid == min(len(tiles), 132)
    cover = np.zeros((-(-m // bm), -(-_r8(n) // bn)), np.int32)
    for _, m0, n0 in tiles:
        cover[m0 // bm, n0 // bn] += 1
    assert (cover == 1).all()
    # tiles reach past M and N only by their last row and column block
    last_m = max(m0 for _, m0, _ in tiles)
    assert last_m < m <= last_m + bm
    assert max(n0 for _, _, n0 in tiles) < n


def test_gemm_chain_plan_keeps_w_resident_where_it_fits():
    """w stays in shared memory at section A's first shape (9 x 64 x 64
    bf16, 72 KB, beside 4 x stages), not at the others; `resident` turns
    it off, and asking for it where it does not fit raises."""
    m = _section_a_rows(64, 64, 9)
    assert gemm_chain_plan(m, 64, 64, 9)[2:5] == (1, 4, 0)
    assert gemm_chain_plan(m, 64, 64, 9, resident=False)[2] == 0
    for k, n, t in SECTION_A[1:]:
        assert gemm_chain_plan(_section_a_rows(k, n, t), k, n, t)[2] == 0
    with pytest.raises(ValueError, match="shared memory"):
        gemm_chain_plan(1000, 128, 128, 9, resident=True)


def _emulate(x, w, plan):
    """The kernel's tiling in float64: the wrapper's zero padding of K and
    N to multiples of 8; per tile of the persistent walk, per K chunk of
    64 one x box [BM, 64] (zeros past M and K8, as TMA writes them), and
    per t the w box [64, BN] (zeros past K8 and N8), from w's resident
    copy (loaded once per block) or streamed, summed into the tile's
    accumulator in (chunk, t) order; each output stored once, rows past M
    and columns past N not stored."""
    bn, mw, res, _, _, _ = plan
    m, k = x.shape
    t, _, n = w.shape
    bm, chunks = 128 * mw, -(-_r8(k) // 64)
    xp = np.zeros((-(-m // bm) * bm, chunks * 64))
    xp[:m, :k] = x
    wp = np.zeros((t, chunks * 64, -(-_r8(n) // bn) * bn))
    wp[:, :k, :n] = w
    y = np.full((m, n), np.nan)
    resident, block = None, -1
    for b, m0, n0 in _walk(m, n, plan):
        if res and b != block:     # a block's one load of all of w
            resident = {(tt, c): wp[tt, c * 64:(c + 1) * 64, :bn].copy()
                        for tt in range(t) for c in range(chunks)}
            block = b
        acc = np.zeros((bm, bn))
        for c in range(chunks):
            xa = xp[m0:m0 + bm, c * 64:(c + 1) * 64]
            for tt in range(t):
                wa = (resident[(tt, c)] if res else
                      wp[tt, c * 64:(c + 1) * 64, n0:n0 + bn])
                acc += xa @ wa
        rows, cols = min(bm, m - m0), min(bn, n - n0)
        assert np.isnan(y[m0:m0 + rows, n0:n0 + cols]).all()
        y[m0:m0 + rows, n0:n0 + cols] = acc[:rows, :cols]
    assert not np.isnan(y).any()
    return y


# (M, K, N, T): section A's K, N and T at a small M (two tiles and a
# ragged third), and the odd shapes
EMU = ([(2 * 128 * (1 if n > 128 else 2) + 37, k, n, t)
        for k, n, t in SECTION_A] + ODD)


@pytest.mark.parametrize("m,k,n,t", EMU)
@pytest.mark.parametrize("resident", [None, False])
def test_gemm_chain_tiling_emulation_matches_plain(m, k, n, t, resident):
    """The float64 emulation of the kernel's tiling (plan as the wrapper
    takes it, and with w resident turned off) against gemm_chain_torch,
    within 1e-5 of max.  Inputs are small integers (bf16 exact), so every
    sum is exact in f32 and f64 and both sides round the same values to
    bf16: any tile, chunk, t or padding mislaid shows."""
    rng = np.random.default_rng(m + k + n + t)
    x = rng.integers(-3, 4, (m, k)).astype(np.float32)
    w = rng.integers(-3, 4, (t, k, n)).astype(np.float32)
    plan = gemm_chain_plan(m, k, n, t, resident)
    got = torch.from_numpy(_emulate(x, w, plan)).to(torch.bfloat16)
    want = gemm_chain_torch(torch.from_numpy(x).to(torch.bfloat16),
                            torch.from_numpy(w).to(torch.bfloat16))
    err = float((got.float() - want.float()).abs().max())
    assert err <= 1e-5 * float(want.float().abs().max())
