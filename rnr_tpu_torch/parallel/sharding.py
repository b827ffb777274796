"""Data parallelism over ranks (port of rnr_tpu/parallel/sharding.py,
its dp axis).

rnr_tpu lays a (dp, sp) mesh over its devices: dp shards the batch of
views, sp the image rows, and XLA's SPMD partitioner inserts the U-Net's
halo exchanges for sp.  PyTorch has no such partitioner, so the port has
dp only (sp is ROADMAP.md Queue 1 item 10).  The steps of
train/steps.py take a mesh (make_sharded_* are rnr_tpu's names for
them): each rank runs the single-device step on its rows of the global
batch, with

- batch norm over the global batch: BatchActNorm's mean and variance
  over (N, H, W) come from all-reduced sums in f32, mean first, then the
  centred second moment (`global_batch_norm`); group norm and the GCN's
  norms are per sample or replicated and need nothing;
- each rank's share of the loss (`train/steps.py::make_rnr_loss_fn`),
  so that the shares sum to the global batch's loss, and the gradients
  summed over the ranks in one flat all-reduce before Adam: parameters
  and Adam moments stay bit-equal across ranks;
- randomness split in two: the GCN's stochastic picks from the caller's
  generator, the same on every rank, the dropout masks from a generator
  per rank seeded from (seed, rank) (rnr_tpu slices one global mask);
- each rank's own kernel routes on whole frames (rnr_tpu switches the
  U-Net to its `xla` convs under a mesh only because sp needs halos).

On one rank (`ONE_RANK`, a mesh of None) the norms are the module's
own, dropout draws from the caller's generator and the collectives sum
one term.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from rnr_tpu_torch.models.unet import BatchActNorm
from rnr_tpu_torch.parallel.distributed import local_rows, rank, world_size

SP_NOT_PORTED = ("sp > 1 (image rows across devices) is not ported: it "
                 "needs a halo exchange around every conv route (ROADMAP.md "
                 "Queue 1 item 10); --mesh_dp must equal --mesh_devices for "
                 "now")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """dp ranks, each holding whole frames; sp is always 1.  `grouped`:
    the collectives run over the process group (a mesh made inside one
    of `world` ranks), else they sum one term."""

    dp: int
    sp: int
    world: int
    rank: int
    grouped: bool = False

    @property
    def shape(self) -> tuple[int, int]:
        return (self.dp, self.sp)

    axis_names = ("dp", "sp")

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the ranks in place (not differentiable)."""
        if self.grouped:
            dist.all_reduce(t)
        return t


ONE_RANK = Mesh(dp=1, sp=1, world=1, rank=0)

def mesh_shape(n: int, dp: int | None = None) -> tuple[int, int]:
    """(dp, sp) of n devices, dp 1 when None (rnr_tpu's default, which
    shards image rows over sp = n); raises ValueError where dp does not
    divide n and NotImplementedError where sp > 1."""
    dp = dp or 1
    sp = n // dp
    if dp * sp != n:
        raise ValueError(f"cannot factor {n} devices into dp={dp} x sp={sp}")
    if sp > 1:
        raise NotImplementedError(SP_NOT_PORTED)
    return dp, sp


def make_mesh(n_devices: int | None = None, dp: int | None = None) -> Mesh:
    """The (dp, sp) mesh over n_devices ranks (the process group's world
    size when None).  dp defaults to 1, as rnr_tpu's (which then shards
    image rows over sp = n): sp > 1 raises NotImplementedError.  More
    than one rank needs the process group (init_distributed) of exactly
    n ranks."""
    n = n_devices or world_size()
    dp, _ = mesh_shape(n, dp)
    if n > 1 and world_size() != n:
        raise RuntimeError(f"a mesh of {n} ranks needs a process group of "
                           f"{n} (parallel.init_distributed), not "
                           f"{world_size()}")
    grouped = dist.is_initialized() and world_size() == n
    return Mesh(dp=dp, sp=1, world=n, rank=rank() if grouped else 0,
                grouped=grouped)


def replicated(mesh: Mesh) -> slice:
    """The rows every rank holds: all."""
    return slice(None)


def batch_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a global batch of n; raises where dp does not
    divide n."""
    local, off = local_rows(n, mesh.dp, mesh.rank)
    return slice(off, off + local)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """The rank's rows of every array of a global batch (DNR's maps)."""
    return {k: v[batch_sharding(mesh, v.shape[0])] for k, v in batch.items()}


def shard_rnr_batch(batch: dict, mesh: Mesh) -> dict:
    """The rank's rows of a global G-buffer batch: [N, H, ...] maps
    sliced over dp; gcn_pos and arrays of fewer than 3 dims whole."""
    return {k: v[replicated(mesh) if k == "gcn_pos" or v.ndim < 3
                 else batch_sharding(mesh, v.shape[0])]
            for k, v in batch.items()}


class _AllSum(torch.autograd.Function):
    """The sum over the ranks, every rank receiving it; its backward sums
    the ranks' gradients (the adjoint of a sum handed to every rank)."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone()
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def _global_var_mean(x32: torch.Tensor, world: int):
    """(var, mean) over (N, H, W) of every rank's rows, as torch.var_mean
    (unbiased=False) of the global batch: the mean from the all-reduced
    sum, then the variance from the all-reduced centred squares;
    differentiable (the all-reduce's backward sums the ranks'
    gradients)."""
    count = x32.shape[0] * x32.shape[1] * x32.shape[2] * world
    mean = _AllSum.apply(x32.sum(dim=(0, 1, 2), keepdim=True)) / count
    d = x32 - mean
    var = _AllSum.apply((d * d).sum(dim=(0, 1, 2), keepdim=True)) / count
    return var, mean


@contextlib.contextmanager
def global_batch_norm(model: torch.nn.Module, mesh: Mesh):
    """Inside: every BatchActNorm of `model` normalises by the global
    batch's moments (a forward, and the backward that recomputes remat'd
    blocks, both run inside).  On one rank nothing changes."""
    if mesh.world == 1:
        yield
        return
    norms = [m for m in model.modules() if isinstance(m, BatchActNorm)]

    def moments(x32):
        return _global_var_mean(x32, mesh.world)

    for m in norms:
        m.moments = moments
    try:
        yield
    finally:
        for m in norms:
            m.moments = None


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
    """The global batch's metrics from one all-reduce: `means` (equal rows
    on every rank) averaged, `shares` (of the loss) summed; detached."""
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
