"""K4: stratified nearest neighbour (csrc/stratified_knn.cu) and its twin.

Replaces rnr_tpu/ops/knn_pallas.py::stratified_knn.  For each vertex i and
each column stratum of `stratum` vertices, the j maximising
2 x_i.x_j - |x_j|^2 (bf16 inputs, f32 scores, the first maximum wins
ties), clamped to V - 1.
"""

from __future__ import annotations

import torch

from rnr_tpu_torch.ops import _build
from rnr_tpu_torch.ops.backend import (check_launch, require, stream_of,
                                       use_kernel)

# the kernel's stratum width (csrc/stratified_knn.cu STRATUM) and the
# widest feature it takes
KERNEL_STRATUM = 16
MAX_C = 512


def stratified_knn_torch(x: torch.Tensor, stratum: int = 16) -> torch.Tensor:
    """Plain twin: a port of rnr_tpu's stratified_knn_xla oracle."""
    v = x.shape[0]
    xf = x.to(torch.bfloat16).to(torch.float32)
    sq = torch.sum(xf * xf, dim=1)
    score = 2.0 * (xf @ xf.T) - sq[None, :]
    n_strata = -(-v // stratum)
    pad = n_strata * stratum - v
    if pad:
        score = torch.nn.functional.pad(score, (0, pad), value=float("-inf"))
    score = score.reshape(v, n_strata, stratum)
    # torch.argmax returns the first maximal index, like jnp.argmax
    idx = torch.argmax(score, dim=-1).to(torch.int32) + (
        torch.arange(n_strata, dtype=torch.int32, device=x.device)[None, :]
        * stratum)
    return torch.clamp(idx, max=v - 1)


def stratified_knn(x: torch.Tensor, stratum: int = 16) -> torch.Tensor:
    """x [V, C] -> idx [V, ceil(V / stratum)] int32; integer indices, so
    x is taken detached (rnr_tpu's stop_gradient)."""
    x = x.detach()
    if not use_kernel(x):
        return stratified_knn_torch(x, stratum)
    v, c = x.shape
    if stratum != KERNEL_STRATUM:
        raise ValueError(f"stratified_knn kernel: stratum {stratum}, "
                         f"built for {KERNEL_STRATUM}")
    if c > MAX_C:
        raise ValueError(f"stratified_knn kernel: C={c} > {MAX_C}")
    xb = x.to(torch.bfloat16).contiguous()
    require(xb, "x", torch.bfloat16, (v, c))
    out = torch.empty((v, -(-v // stratum)), dtype=torch.int32,
                      device=x.device)
    f = _build.fn("stratified_knn", "rnr_stratified_knn", 2, 2)
    stratified_knn.launches += 1
    check_launch(f(xb.data_ptr(), out.data_ptr(), v, c, stream_of(xb)),
                 "stratified_knn")
    return out


stratified_knn.launches = 0
