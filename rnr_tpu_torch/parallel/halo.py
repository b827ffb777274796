"""The halo exchange of image rows across the sp ranks of a mesh.

rnr_tpu shards image rows over its mesh's sp axis and XLA's SPMD
partitioner inserts the exchanges its convolutions need.  The port
writes them: `halo_rows(x, mesh, k, pad_mode)` extends a rank's NHWC rows
by k rows above and k below, its sp neighbours' edge rows at an inner
edge and, at the frame's global top and bottom, what the conv's own
padding would put there (reflected rows for "reflect", zeros for
"same").  A conv then runs on the extended rows with its own padding and
drops the output rows that read that padding (models/unet.py): every
kernel stays as it is.

One algorithm for NCCL and Gloo: one all_gather, within the sp group, of
each rank's 2k edge rows, each rank taking its neighbours'; Gloo's is
staged through host memory.  The backward sends each halo row's gradient
back the same way to the rank that owns the row, which adds it to its
edge rows; at a global edge under "reflect" the gradient folds into the
mirrored rows.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _gather_rows(t: torch.Tensor, mesh) -> list[torch.Tensor]:
    """Every sp rank's `t` ([N, rows, W, C]) in sp order, on t's device;
    through host memory in f32 under Gloo (bf16 and f16 exactly)."""
    group = mesh.sp_group
    staged = dist.get_backend(group) == "gloo"
    src = t.float().cpu() if staged else t
    parts = [torch.empty_like(src) for _ in range(mesh.sp)]
    dist.all_gather(parts, src.contiguous(), group=group)
    if staged:
        parts = [p.to(t.device, t.dtype) for p in parts]
    return parts


class _HaloRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mesh, k: int, reflect: bool):
        ctx.mesh, ctx.k, ctx.reflect = mesh, k, reflect
        s, last = mesh.sp_index, mesh.sp - 1
        parts = _gather_rows(torch.cat([x[:, :k], x[:, -k:]], dim=1), mesh)
        if s > 0:
            top = parts[s - 1][:, k:]
        elif reflect:                        # global rows -k .. -1
            top = x[:, 1:k + 1].flip(1)
        else:
            top = torch.zeros_like(x[:, :k])
        if s < last:
            bottom = parts[s + 1][:, :k]
        elif reflect:                        # global rows H .. H + k - 1
            bottom = x[:, -k - 1:-1].flip(1)
        else:
            bottom = torch.zeros_like(x[:, :k])
        return torch.cat([top, x, bottom], dim=1)

    @staticmethod
    def backward(ctx, g):
        mesh, k = ctx.mesh, ctx.k
        s, last = mesh.sp_index, mesh.sp - 1
        g_top, g_bottom = g[:, :k], g[:, -k:]
        parts = _gather_rows(torch.cat([g_top, g_bottom], dim=1), mesh)
        gx = g[:, k:-k].clone()
        if s > 0:        # the rank above's bottom halo: this rank's top rows
            gx[:, :k] += parts[s - 1][:, k:]
        elif ctx.reflect:
            gx[:, 1:k + 1] += g_top.flip(1)
        if s < last:     # the rank below's top halo: this rank's bottom rows
            gx[:, -k:] += parts[s + 1][:, :k]
        elif ctx.reflect:
            gx[:, -k - 1:-1] += g_bottom.flip(1)
        return gx, None, None, None


def halo_rows(x: torch.Tensor, mesh, k: int, pad_mode: str) -> torch.Tensor:
    """NHWC x (this rank's rows of the frame) extended by k rows above and
    k below from its sp neighbours, the frame's own edges filled as
    `pad_mode` pads them ("reflect": reflected rows, "same": zeros);
    differentiable.  A collective of the sp group: its ranks call it
    together.  Reflection needs k + 1 rows a rank."""
    if pad_mode not in ("reflect", "same"):
        raise ValueError(f"pad_mode {pad_mode!r}")
    if x.shape[1] < k + 1:
        raise ValueError(f"a halo of {k} rows needs {k + 1} rows a rank, "
                         f"not {x.shape[1]}")
    return _HaloRows.apply(x, mesh, k, pad_mode == "reflect")
