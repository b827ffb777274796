"""One f32 training step of the port under the kernel conv routes
"pallas" (K3 and K6's plain versions), "p3s4" (K3 and K8's 4x4 pair),
"slab3" (the 3x3 slab conv K8a / K8b) and "slab" (the 3x3 slab conv and
K8's 4x4 pair) against rnr_tpu's under "pallas_interpret", "p3s4",
"slab3" and "slab" (Pallas interpret mode; the last three reach their
kernels on the CPU only with RNR_PALLAS_INTERPRET=1, set per test with
monkeypatch), at the SMALL config of test_torch_train.py.
"""

import dataclasses

import pytest

from rnr_tpu_torch.config import RNRConfig
from test_torch_relight_train import _jax_step, check_port_step
from test_torch_unet_backends import (FORCED_INTERPRET, JAX_BACKEND,
                                      _want_calls, calls)  # noqa: F401


@pytest.mark.parametrize("backend", ["pallas", "p3s4", "slab3", "slab"])
def test_train_step_f32_matches_jax(backend, monkeypatch, calls):
    """One f32 training step at the SMALL config of test_torch_train.py
    (dropout and the stochastic GCN off on both sides), rnr_tpu's Pallas
    kernels in interpret mode: the five loss terms to 1e-5 relative and
    every gradient to 1e-4 of its max, as check_port_step holds the other
    configurations; and the 4x4 pair's and the slab conv's wrappers called
    as rnr_tpu's VJPs call its kernels (reflect padding)."""
    if backend in FORCED_INTERPRET:
        monkeypatch.setenv("RNR_PALLAS_INTERPRET", "1")
    case = _jax_step({}, JAX_BACKEND[backend])
    assert RNRConfig.from_dict(dataclasses.asdict(
        case["cfg"])).render_net.conv_backend == JAX_BACKEND[backend]
    check_port_step(case)
    nd = case["cfg"].render_net.num_down_unet
    assert dict(calls) == _want_calls(backend, "reflect", nd)
