"""Data and row parallelism over ranks (port of
rnr_tpu/parallel/sharding.py).

rnr_tpu lays a (dp, sp) mesh over its devices: dp shards the batch of
views, sp the image rows, and XLA's SPMD partitioner inserts the U-Net's
halo exchanges and turns the norms' and the loss's reductions into
collectives.  PyTorch has no such partitioner, so the port writes them.
A mesh is laid out as rnr_tpu's: rank r has dp index r // sp and sp
index r % sp, and holds sp share s of the rows of its dp share of the
global batch: the frame's H rows in units of 2**num_down (the U-Net's
innermost row), ceil(u / sp) units to the first u % sp indices and
floor(u / sp) to the rest (`row_split`), so that every level's rows split
at the same places.  The steps of train/steps.py take a mesh (make_sharded_*
are rnr_tpu's names for them): each rank runs the single-device step on
its rows of the global batch, with

- batch norm over the global batch: BatchActNorm's mean and variance
  over (N, H, W) come from all-reduced sums in f32, mean first, then the
  centred second moment (`global_batch_norm`); the GCN's norms are
  replicated and need nothing;
- under sp (`row_shards`): every conv route on halo-extended rows
  (parallel/halo.py), and group norm's per-sample sums all-reduced over
  the sp group;
- each rank's share of the loss (`train/steps.py::make_rnr_loss_fn`),
  so that the shares sum to the global batch's loss, the border crop at
  the frame's global top and bottom only (`crop_rows`), and the
  gradients summed over the ranks in one flat all-reduce before Adam:
  parameters and Adam moments stay bit-equal across ranks;
- per-image metrics from each image's sums over its sp group;
- randomness split in two: the GCN's stochastic picks from the caller's
  generator, the same on every rank (the GCN runs whole on every rank),
  the dropout masks from a generator per rank seeded from (seed, rank)
  (rnr_tpu slices one global mask);
- each rank's own kernel routes (rnr_tpu switches the U-Net to its
  `xla` convs under a mesh because a Pallas conv would need a
  hand-written halo exchange; the port has one).

A frame of H rows runs over sp ranks only where H % 2**num_down == 0
and H / 2**num_down >= 2 sp (`check_rows`): the innermost level then has
at least 2 rows a rank, which a reflect halo needs.  rnr_tpu shards any H
that sp divides (GSPMD carries the levels that sp does not divide; its
device_put refuses the rest).  On one rank (`ONE_RANK`, a
mesh of None) the norms are the module's own, dropout draws from the
caller's generator and the collectives sum one term.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from rnr_tpu_torch.models.unet import (BatchActNorm, Conv, ConvTranspose,
                                       GroupNorm)
from rnr_tpu_torch.parallel.distributed import (local_rows, make_groups, rank,
                                                world_size)
from rnr_tpu_torch.parallel.halo import halo_rows


@dataclasses.dataclass(frozen=True)
class Mesh:
    """dp x sp ranks: rank r holds rows sp_index of samples shard
    dp_index.  `grouped`: the collectives run over `group` (the world
    when None; a mesh made inside a process group), else they sum one
    term.  `sp_group`: this rank's sp ranks, for the halo exchange and
    the per-image sums."""

    dp: int
    sp: int
    world: int
    rank: int
    grouped: bool = False
    group: object = None
    sp_group: object = None

    @property
    def shape(self) -> tuple[int, int]:
        return (self.dp, self.sp)

    @property
    def dp_index(self) -> int:
        return self.rank // self.sp

    @property
    def sp_index(self) -> int:
        return self.rank % self.sp

    axis_names = ("dp", "sp")

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the ranks in place (not differentiable)."""
        if self.grouped:
            dist.all_reduce(t, group=self.group)
        return t

    def sp_sum(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over this rank's sp group in place (not
        differentiable)."""
        if self.sp > 1:
            dist.all_reduce(t, group=self.sp_group)
        return t

    def sp_mesh(self) -> "Mesh":
        """The mesh of this rank's sp group alone (dp 1): its frames
        rendered apart from the other dp indices' (test_rnr)."""
        if self.dp == 1:
            return self
        return Mesh(dp=1, sp=self.sp, world=self.sp, rank=self.sp_index,
                    grouped=self.grouped, group=self.sp_group,
                    sp_group=self.sp_group)


ONE_RANK = Mesh(dp=1, sp=1, world=1, rank=0)


def mesh_shape(n: int, dp: int | None = None) -> tuple[int, int]:
    """(dp, sp) of n devices, dp 1 when None (rnr_tpu's default, which
    shards image rows over sp = n); raises ValueError where dp does not
    divide n."""
    dp = dp or 1
    sp = n // dp
    if dp * sp != n:
        raise ValueError(f"cannot factor {n} devices into dp={dp} x sp={sp}")
    return dp, sp


def check_rows(h: int, sp: int, num_down: int) -> None:
    """Raises ValueError unless a frame of h rows splits over sp ranks
    through a U-Net of num_down levels: h % 2**num_down == 0 and
    h / 2**num_down >= 2 sp (2 innermost rows a rank)."""
    unit = 2 ** num_down
    if sp > 1 and (h % unit or h // unit < 2 * sp):
        raise ValueError(
            f"{h} rows over sp={sp} with {num_down} U-Net downs: the rows "
            f"must be a multiple of 2**num_down = {unit}, at least 2 * sp * "
            f"2**num_down = {2 * sp * unit} (2 innermost rows a rank)")


def row_split(h: int, sp: int, unit: int = 1) -> list[tuple[int, int]]:
    """(rows, first row) of each sp index for a frame of h rows: its
    h // unit units of `unit` rows, ceil(u / sp) to the first u % sp
    indices and floor(u / sp) to the rest; equal shards where sp divides
    u."""
    q, r = divmod(h // unit, sp)
    out, first = [], 0
    for i in range(sp):
        rows = (q + (i < r)) * unit
        out.append((rows, first))
        first += rows
    return out


def make_mesh(n_devices: int | None = None, dp: int | None = None) -> Mesh:
    """The (dp, sp) mesh over n_devices ranks (the process group's world
    size when None).  dp defaults to 1, as rnr_tpu's, which then shards
    image rows over sp = n.  More than one rank needs the process group
    (init_distributed) of exactly n ranks; every rank makes the mesh
    (its sp and dp groups are made by all)."""
    n = n_devices or world_size()
    dp, sp = mesh_shape(n, dp)
    if n > 1 and world_size() != n:
        raise RuntimeError(f"a mesh of {n} ranks needs a process group of "
                           f"{n} (parallel.init_distributed), not "
                           f"{world_size()}")
    grouped = dist.is_initialized() and world_size() == n
    sp_group = make_groups(dp, sp)[0] if grouped and n > 1 else None
    return Mesh(dp=dp, sp=sp, world=n, rank=rank() if grouped else 0,
                grouped=grouped, sp_group=sp_group)


def batch_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's samples of a global batch of n (dim 0, over dp);
    raises where dp does not divide n."""
    local, off = local_rows(n, mesh.dp, mesh.dp_index)
    return slice(off, off + local)


def row_sharding(mesh: Mesh, h: int, unit: int = 1) -> slice:
    """This rank's image rows of a frame of h (dim 1, over sp), in units
    of `unit` rows (`row_split`)."""
    local, off = row_split(h, mesh.sp, unit)[mesh.sp_index]
    return slice(off, off + local)


def _shard(v: torch.Tensor, mesh: Mesh, unit: int) -> torch.Tensor:
    """This rank's samples and rows of a map [N, H, ...], contiguous (the
    kernels read their inputs densely)."""
    return v[batch_sharding(mesh, v.shape[0]),
             row_sharding(mesh, v.shape[1], unit)].contiguous()


def shard_batch(batch: dict, mesh: Mesh, unit: int = 1) -> dict:
    """The rank's samples and rows (in units of `unit`) of every map of a
    global batch ([N, H, ...], DNR's)."""
    return {k: _shard(v, mesh, unit) for k, v in batch.items()}


def shard_rnr_batch(batch: dict, mesh: Mesh, unit: int = 1) -> dict:
    """The rank's samples and rows (in units of `unit`) of a global
    G-buffer batch: [N, H, ...] maps sliced over (dp, sp); gcn_pos and
    arrays of fewer than 3 dims whole."""
    return {k: v if k == "gcn_pos" or v.ndim < 3 else _shard(v, mesh, unit)
            for k, v in batch.items()}


def crop_rows(mesh: Mesh, b: int) -> slice:
    """The rows of this rank's shard that a border crop of b keeps: b are
    dropped at the frame's global top (sp index 0) and bottom (the last
    sp index) only."""
    top = b if mesh.sp_index == 0 else 0
    bottom = -b if b and mesh.sp_index == mesh.sp - 1 else None
    return slice(top, bottom)


class _AllSum(torch.autograd.Function):
    """The sum over the ranks of `group` (the world when None), every
    rank receiving it; its backward sums the ranks' gradients (the
    adjoint of a sum handed to every rank)."""

    @staticmethod
    def forward(ctx, t, group=None):
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _global_var_mean(x32: torch.Tensor, mesh: Mesh, rows: tuple[int, int]):
    """(var, mean) over (N, H, W) of every rank's rows, as torch.var_mean
    (unbiased=False) of the global batch: the mean from the all-reduced
    sum, then the variance from the all-reduced centred squares;
    differentiable (the all-reduce's backward sums the ranks'
    gradients).  `rows`: (this rank's, the frame's) rows at full
    resolution; every level's rows split in the same ratio (units of the
    innermost row), so the level's global rows are x's times theirs."""
    count = (x32.shape[0] * mesh.dp * x32.shape[2]
             * (x32.shape[1] * rows[1] // rows[0]))
    mean = _AllSum.apply(x32.sum(dim=(0, 1, 2), keepdim=True),
                         mesh.group) / count
    d = x32 - mean
    var = _AllSum.apply((d * d).sum(dim=(0, 1, 2), keepdim=True),
                        mesh.group) / count
    return var, mean


@contextlib.contextmanager
def _set(mods: list, attr: str, value):
    for m in mods:
        setattr(m, attr, value)
    try:
        yield
    finally:
        for m in mods:
            setattr(m, attr, None)


@contextlib.contextmanager
def global_batch_norm(model: torch.nn.Module, mesh: Mesh,
                      rows: tuple[int, int] | None = None):
    """Inside: every BatchActNorm of `model` normalises by the global
    batch's moments (a forward, and the backward that recomputes remat'd
    blocks, both run inside).  `rows`: (this rank's, the frame's) rows,
    (1, sp) when None (equal shards).  On one rank nothing changes."""
    if mesh.world == 1:
        yield
        return
    norms = [m for m in model.modules() if isinstance(m, BatchActNorm)]
    with _set(norms, "moments", functools.partial(
            _global_var_mean, mesh=mesh, rows=rows or (1, mesh.sp))):
        yield


@contextlib.contextmanager
def row_shards(model: torch.nn.Module, mesh: Mesh, halo: bool = True):
    """Inside (sp > 1): every Conv and ConvTranspose of `model` runs on
    its rows extended by the halo exchange (`halo_rows`) and every
    GroupNorm sums its per-sample statistics over the sp group, both
    differentiably (a forward, and the backward that recomputes remat'd
    blocks, both run inside).  halo=False leaves the convs on the rank's
    own rows, each padding them as a whole frame: the control that shows
    what the halo does.  On sp = 1 nothing changes."""
    if mesh.sp == 1:
        yield
        return
    mods = list(model.modules())
    convs = [m for m in mods if isinstance(m, (Conv, ConvTranspose))]
    norms = [m for m in mods if isinstance(m, GroupNorm)]

    def extend(x, k, pad_mode):
        return halo_rows(x, mesh, k, pad_mode)

    def group_sum(t):
        return _AllSum.apply(t, mesh.sp_group)

    with _set(convs if halo else [], "halo", extend), \
            _set(norms, "group_sum", group_sum):
        yield


def all_reduce_grads(model: torch.nn.Module, mesh: Mesh) -> None:
    """Sum every gradient over the ranks in one flat all-reduce.
    Parameters without a gradient (the same on every rank) keep none."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if not grads or not mesh.grouped:
        return
    flat = mesh.sum_(torch.cat([g.reshape(-1) for g in grads]))
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def dropout_generator(mesh: Mesh, seed: int, device) -> torch.Generator | None:
    """This rank's dropout generator, seeded from (seed, rank); None on
    one rank (dropout then draws from the caller's generator)."""
    if mesh.world == 1:
        return None
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, mesh.rank])
                      .generate_state(1)[0]))
    return g


def global_metrics(mesh: Mesh, means: dict, shares: dict) -> dict:
    """The global batch's metrics from one all-reduce: `means` averaged
    over the ranks (each rank's samples' whole-frame values: the same on
    every sp index of a dp index, however its rows split), `shares` (of
    the loss) summed; detached."""
    keys = list(means) + list(shares)
    vals = torch.stack([means[k] / mesh.world for k in means]
                       + [shares[k].detach() for k in shares])
    return dict(zip(keys, mesh.sum_(vals).unbind()))


# rnr_tpu's names for the steps of train/steps.py over `mesh` (imported
# at the call: train/steps.py imports this module)

def make_sharded_rnr_train_step(model, optimizer, mesh: Mesh,
                                lighting_idx: int = 0, seed: int = 0
                                ) -> Callable:
    from rnr_tpu_torch.train.steps import make_rnr_train_step
    return make_rnr_train_step(model, optimizer, lighting_idx, mesh, seed)


def make_sharded_dnr_train_step(cfg, mods, optimizer, mesh: Mesh,
                                seed: int = 0) -> Callable:
    from rnr_tpu_torch.train.steps import make_dnr_train_step
    return make_dnr_train_step(cfg, mods, optimizer, mesh, seed)


def make_sharded_rnr_eval_step(model, mesh: Mesh, lighting_idx: int = 0,
                               output_keys: tuple[str, ...] | None = ("img",)
                               ) -> Callable:
    from rnr_tpu_torch.train.steps import make_rnr_eval_step
    return make_rnr_eval_step(model, lighting_idx, output_keys, mesh)
