"""P1: the GEMM chain y = bf16(sum over t of x . w[t]) (csrc/gemm_chain.cu)
and its plain version.

Replaces tools/tpu_probe_r5.py::gemm_chain_pallas (:81), the probe that
runs the 3x3 conv kernels' geometry as a bare chain of T products per
tile (its XLA twin is `gemm_chain_xla`, :101).  It lies on no path of the
package: chip_smoke.py's kernels phase runs it at the probe's section A
shapes against its plain version.
"""

from __future__ import annotations

import torch

from rnr_tpu_torch.ops import _build
from rnr_tpu_torch.ops.backend import (check_launch, require, stream_of,
                                       use_kernel)


def gemm_chain_torch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: T products of x [M, K] with w[t] [K, N] in f32 from
    the inputs as given, added in t order, one bf16 rounding at the end."""
    xf = x.to(torch.float32)
    acc = torch.zeros((x.shape[0], w.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for t in range(w.shape[0]):
        acc += xf @ w[t].to(torch.float32)
    return acc.to(torch.bfloat16)


def gemm_chain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K], w [T, K, N] -> [M, N] bf16: P1 on CUDA tensors (both
    bf16), the plain version on CPU tensors."""
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"gemm_chain: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)}, expected [M, K] and [T, K, N]")
    if not use_kernel(x, w):
        return gemm_chain_torch(x, w)
    m, k = x.shape
    t, _, n = w.shape
    xb, wb = x.contiguous(), w.contiguous()
    require(xb, "x", torch.bfloat16)
    require(wb, "w", torch.bfloat16)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    f = _build.fn("gemm_chain", "rnr_gemm_chain", 3, 4)
    gemm_chain.launches += 1
    check_launch(f(xb.data_ptr(), wb.data_ptr(), y.data_ptr(), m, k, n, t,
                   stream_of(xb)), "gemm_chain")
    return y


gemm_chain.launches = 0
