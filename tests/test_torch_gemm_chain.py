"""Port parity of P1, the GEMM chain of tools/tpu_probe_r5.py: the plain
version `gemm_chain_torch` against the probe's XLA twin `gemm_chain_xla`
and against its Pallas kernel `_gemm_chain_kernel`, run here through
pl.pallas_call in interpret mode (the probe's own `gemm_chain_pallas`
takes no interpret flag).  The probe is loaded from its path.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rnr_tpu_torch.ops.gemm_chain_cuda import gemm_chain

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
