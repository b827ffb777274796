"""P1: the GEMM chain y = bf16(sum over t of x . w[t]) (csrc/gemm_chain.cu),
its plan and its plain version.

Replaces tools/tpu_probe_r5.py::gemm_chain_pallas (:81), the probe that
runs the 3x3 conv kernels' geometry as a bare chain of T products per
tile (its XLA twin is `gemm_chain_xla`, :101).  It lies on no path of the
package: chip_smoke.py's kernels phase runs it at the probe's section A
shapes against its plain version.
"""

from __future__ import annotations

import functools

import torch

from rnr_tpu_torch.ops import _build
from rnr_tpu_torch.ops.backend import (check_launch, require, stream_of,
                                       use_kernel)
from rnr_tpu_torch.ops.conv_cuda import SMS, pad_channels, round8

# csrc/gemm_chain.cu: K per chunk, consumer warpgroups, the largest rings,
# a block's shared memory on sm_90 and what a launch takes beside its
# rings (alignment slack, barriers)
GEMM_KC = 64
GEMM_WGS = 2
GEMM_MAX_XST, GEMM_MAX_WST = 4, 8
SMEM_LIMIT = 232448
SMEM_FIXED = 1024 + 256
# per BN: (MW, x stages, w stages) of a streamed w
_RINGS = {64: (2, 4, 8), 128: (2, 3, 5), 256: (1, 3, 3)}


def gemm_chain_torch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: T products of x [M, K] with w[t] [K, N] in f32 from
    the inputs as given, added in t order, one bf16 rounding at the end."""
    xf = x.to(torch.float32)
    acc = torch.zeros((x.shape[0], w.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for t in range(w.shape[0]):
        acc += xf @ w[t].to(torch.float32)
    return acc.to(torch.bfloat16)


def gemm_chain_smem(bn: int, mw: int, res: int, xst: int, wst: int,
                    k8: int, t: int) -> int:
    """Shared memory of a launch of the plan, as the kernel lays it out:
    the x ring (BM x 128 bytes a stage), w's ring of (chunk, t) units
    (BN x 128 bytes each) or, resident, all T x chunks of them, and each
    warpgroup's 64 staged output rows of BN + 8 bf16."""
    bm = 64 * GEMM_WGS * mw
    chunks = -(-k8 // GEMM_KC)
    w_bytes = (t * chunks if res else wst) * bn * 128
    return (SMEM_FIXED + xst * bm * 128 + w_bytes
            + GEMM_WGS * 64 * (bn + 8) * 2)


@functools.lru_cache(maxsize=256)
def gemm_chain_plan(m: int, k: int, n: int, t: int,
                    resident: bool | None = None) -> tuple:
    """(bn, mw, res, xst, wst, grid) of P1 on x [M, K], w [T, K, N].

    BN follows N (64, 128, or 256 from N = 129 on, N > 256 in tiles of
    256); MW m64 blocks a consumer warpgroup, 2 below BN 256, so a tile
    is BM = 128 MW rows.  res = 1 keeps all of w in shared memory for the
    block's life (only x streams): where N fits one tile and w's T x
    chunks units fit beside an x ring of two stages or more (section A's
    first shape: 72 KB); `resident` forces it off (False) or asks for it
    (True, a ValueError where it does not fit).  Else w streams through a
    ring of (chunk, t) units.  grid: one block an SM, at most one a tile
    (persistent).  Cached: a call's wrapper pays no planning."""
    k8, n8 = round8(k), round8(n)
    bn = 64 if n8 <= 64 else 128 if n8 <= 128 else 256
    mw, xst, wst = _RINGS[bn]
    bm = 64 * GEMM_WGS * mw
    tiles = -(-m // bm) * -(-n8 // bn)
    fits = -(-n8 // bn) == 1 and gemm_chain_smem(bn, mw, 1, 2, 0, k8,
                                                  t) <= SMEM_LIMIT
    if resident and not fits:
        raise ValueError(f"gemm_chain_plan: w of {t} x {k} x {n} does not "
                         "stay in shared memory")
    res = int(fits if resident is None else resident)
    if res:
        wst = 0
        xst = GEMM_MAX_XST
        while gemm_chain_smem(bn, mw, 1, xst, 0, k8, t) > SMEM_LIMIT:
            xst -= 1
    return bn, mw, res, xst, wst, min(tiles, SMS)


def gemm_chain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K], w [T, K, N] -> [M, N] bf16: P1 on CUDA tensors (both
    bf16), the plain version on CPU tensors.  K and N other than
    multiples of 8 are zero-padded (TMA rows of 16-byte multiples)."""
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"gemm_chain: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)}, expected [M, K] and [T, K, N]")
    if not use_kernel(x, w):
        return gemm_chain_torch(x, w)
    m, k = x.shape
    t, _, n = w.shape
    k8, n8 = round8(k), round8(n)
    xb = pad_channels(x.contiguous(), k8)
    wb = w.contiguous()
    require(xb, "x", torch.bfloat16, (m, k8))
    require(wb, "w", torch.bfloat16, (t, k, n))
    if (k8, n8) != (k, n):
        wb = torch.zeros((t, k8, n8), dtype=torch.bfloat16, device=w.device)
        wb[:, :k, :n] = w
    # TMA takes 16-byte aligned bases
    xb = xb if xb.data_ptr() % 16 == 0 else xb.clone()
    wb = wb if wb.data_ptr() % 16 == 0 else wb.clone()
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    f = _build.fn("gemm_chain", "rnr_gemm_chain", 3, 10)
    gemm_chain.launches += 1
    check_launch(f(xb.data_ptr(), wb.data_ptr(), y.data_ptr(), m, k8, n, t,
                   *gemm_chain_plan(m, k, n, t), stream_of(xb)),
                 "gemm_chain")
    return y


gemm_chain.launches = 0
