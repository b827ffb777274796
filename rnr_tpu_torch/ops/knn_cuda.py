"""K4: stratified nearest neighbour (csrc/stratified_knn.cu) and its twin.

Replaces rnr_tpu/ops/knn_pallas.py::stratified_knn.  For each vertex i and
each column stratum of `stratum` vertices, the j maximising
2 x_i.x_j - |x_j|^2 (bf16 inputs, f32 scores, the first maximum wins
ties), clamped to V - 1.

The kernel computes the scores on the tensor cores (wgmma, bf16 products,
f32 sums) with the per-stratum argmax fused in registers; its sums run in
another order than the twin's cuBLAS product, so where two candidates'
scores lie within f32 rounding of each other the two may pick differently.
`score_bound` bounds that rounding and `compare_picks` holds the kernel to
the twin with it.
"""

from __future__ import annotations

import torch

from rnr_tpu_torch.ops import _build
from rnr_tpu_torch.ops.backend import (check_launch, require, stream_of,
                                       use_kernel)

# the kernel's stratum width (csrc/stratified_knn.cu STRATUM), the widest
# feature it takes, its column tile and the channel multiple its rows are
# padded to
KERNEL_STRATUM = 16
MAX_C = 512
COL_TILE = 256
CHANNEL_CHUNK = 64


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


def knn_work_bytes(v: int, c: int) -> int:
    """Bytes of the kernel's scratch: |x_j|^2 in f32 for every column of
    the column tiles, then the rows of x in bf16, zero-padded to a
    multiple of 64 channels (the rows its TMA boxes read)."""
    vpad = -(-v // COL_TILE) * COL_TILE
    return vpad * 4 + v * -(-c // CHANNEL_CHUNK) * CHANNEL_CHUNK * 2


def _scores(xd: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor):
    xi, xj = xd[rows], xd[cols]
    prod = xi * xj
    sq = (xj * xj).sum(-1)
    return 2 * prod.sum(-1) - sq, prod.abs().sum(-1), sq


def score_bound(x: torch.Tensor, rows: torch.Tensor,
                cols: torch.Tensor) -> torch.Tensor:
    """Bound on the f32 rounding of score(i, j) = 2 x_i.x_j - |x_j|^2, per
    pair (rows[k], cols[k]), in double from x's bf16 values:
    C 2^-23 (2 sum_k |x_ik x_jk| + sum_k x_jk^2) + 2^-24 |s|.  Each bf16
    product is exact in f32; each of the C sums of either dot product
    rounds by at most one unit of 2^-23 relative to the running sum
    (2^-23, not 2^-24, covers a tensor-core accumulation that does not
    round to nearest), and the final subtraction by 2^-24 |s|."""
    xd = x.detach().to(torch.bfloat16).double()
    s, absprod, sq = _scores(xd, rows, cols)
    return (x.shape[1] * 2.0 ** -23 * (2 * absprod + sq)
            + 2.0 ** -24 * s.abs())


def compare_picks(x: torch.Tensor, got: torch.Tensor,
                  want: torch.Tensor) -> dict:
    """Hold a kernel's picks `got` to the twin's `want` ([V, strata] int32):
    where they differ, the two picks' scores in double may differ by at
    most the sum of their two `score_bound`s (a near-tie), else the entry
    is a violation.  Returns the counts of differing entries, of exact
    ties (equal scores in double), of near-ties, the largest gap as a
    fraction of its allowance, and the violations as (row, stratum, got,
    want, gap, allowance)."""
    diff = (got != want).nonzero()
    out = dict(differ=int(diff.shape[0]), exact_ties=0, near_ties=0,
               worst_gap_over_bound=0.0, violations=[])
    if not out["differ"]:
        return out
    diff = diff.cpu()
    rows = diff[:, 0]
    a = got.cpu()[rows, diff[:, 1]].long()
    b = want.cpu()[rows, diff[:, 1]].long()
    xc = x.detach().cpu()
    xd = xc.to(torch.bfloat16).double()
    gap = (_scores(xd, rows, a)[0] - _scores(xd, rows, b)[0]).abs()
    allow = score_bound(xc, rows, a) + score_bound(xc, rows, b)
    out["exact_ties"] = int((gap == 0).sum())
    out["near_ties"] = int(((gap > 0) & (gap <= allow)).sum())
    out["worst_gap_over_bound"] = float((gap / allow).max())
    for k in (gap > allow).nonzero()[:, 0].tolist():
        out["violations"].append((int(rows[k]), int(diff[k, 1]), int(a[k]),
                                  int(b[k]), float(gap[k]), float(allow[k])))
    return out


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
    # the kernel's first pass reads f32 and rounds it to bf16 (exact for
    # a bf16 or f16 x)
    x = x.float().contiguous()
    require(x, "x", torch.float32, (v, c))
    # the indices and, 256-byte aligned after them, the kernel's scratch
    # in one allocation (one allocator call less per launch)
    ns = -(-v // stratum)
    out_bytes = -(-v * ns * 4 // 256) * 256
    buf = torch.empty(out_bytes + knn_work_bytes(v, c), dtype=torch.uint8,
                      device=x.device)
    out = buf[:v * ns * 4].view(torch.int32).view(v, ns)
    f = _build.fn("stratified_knn", "rnr_stratified_knn", 3, 2)
    stratified_knn.launches += 1
    check_launch(f(x.data_ptr(), buf.data_ptr(), buf.data_ptr() + out_bytes,
                   v, c, stream_of(x)), "stratified_knn")
    return out


stratified_knn.launches = 0
