"""Processes and ranks (port of rnr_tpu/parallel/distributed.py).

rnr_tpu runs one program over a JAX device mesh.  The port runs one
process per device: a rank, on `cuda:{local rank}` (or the CPU), joined
with the others by torch.distributed, NCCL on the card and Gloo on the
CPU.  `train_rnr --mesh_devices N --mesh_dp N` spawns N ranks on one
host; `--coordinator_address HOST:PORT --num_processes P --process_id I`
joins P hosts, each starting `--local_device_count` ranks (one when not
given):

  python -m rnr_tpu_torch.drivers.train_rnr ... \\
      --coordinator_address HOST0:1234 --num_processes 2 --process_id $I

Gloo's own rendezvous and collective timeout is 30 s, short enough for
a loaded host to miss it; every group here waits `TIMEOUT_S`.
"""

from __future__ import annotations

import datetime
import multiprocessing
import socket

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as torch_mp

TIMEOUT_S = 600


def free_port() -> int:
    """A free TCP port on this host, for a rendezvous on localhost."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(coordinator_address: str | None,
                     num_processes: int | None, process_id: int | None,
                     local_device_count: int | None = None, *,
                     local_rank: int = 0, platform: str = "cuda",
                     backend: str | None = None) -> bool:
    """Join this rank to the process group when a coordinator is given;
    returns whether it did.  World: num_processes x local_device_count
    ranks (one a process when the count is None); this rank is
    process_id x that count + local_rank.  The backend is NCCL for
    platform "cuda" (the rank's device, rank_device, made current) and
    Gloo for "cpu", unless `backend` names one (Gloo also takes CUDA
    tensors: two ranks on one card, which NCCL refuses; the caller then
    picks the device)."""
    if coordinator_address is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("--coordinator_address requires --num_processes "
                         "and --process_id")
    per = local_device_count or 1
    if not 0 <= local_rank < per:
        raise ValueError(f"local rank {local_rank} of {per}")
    backend = backend or ("nccl" if platform == "cuda" else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(rank_device(local_rank, platform))
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes * per, rank=process_id * per + local_rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return True


def rank_device(local_rank: int, platform: str = "cuda") -> torch.device:
    """The device a rank owns: cuda:{local rank}, or the CPU."""
    if platform == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", local_rank)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """True on the rank that writes logs, images and checkpoints."""
    return rank() == 0


def fetch_global(x: torch.Tensor, sp: int = 1, group=None) -> np.ndarray:
    """A tensor sharded over the ranks of `group` (the world when None)
    as one host array, a collective that every rank of the group calls.
    The group's ranks are laid out as (dp, sp): rank r holds sp share s
    of the rows (dim 1, shares of any size: sharding.row_split) of
    samples shard d (dim 0), d = r // sp, s = r % sp; the frames come
    back whole, rows over sp, then samples over dp.  Each rank's rows are
    padded to the largest share for the gather, then cropped.  Gloo
    gathers from host memory."""
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.float()
    n = world_size() if group is None else dist.get_world_size(group)
    if n > 1:
        if dist.get_backend(group) == "gloo":
            x = x.cpu()
        rows = torch.tensor([x.shape[1]], device=x.device)
        counts = [torch.empty_like(rows) for _ in range(n)]
        dist.all_gather(counts, rows, group=group)
        counts = [int(c) for c in counts]
        pad = torch.zeros((x.shape[0], max(counts) - x.shape[1],
                           *x.shape[2:]), dtype=x.dtype, device=x.device)
        parts = [torch.empty((x.shape[0], max(counts), *x.shape[2:]),
                             dtype=x.dtype, device=x.device)
                 for _ in range(n)]
        dist.all_gather(parts, torch.cat([x, pad], dim=1), group=group)
        parts = [p[:, :c] for p, c in zip(parts, counts)]
        x = torch.cat([torch.cat(parts[d:d + sp], dim=1)
                       for d in range(0, n, sp)])
    return x.cpu().numpy()


def make_groups(dp: int, sp: int) -> tuple:
    """(this rank's sp group, its dp group) of a (dp, sp) mesh over the
    world: the sp groups hold ranks d·sp .. d·sp + sp - 1 (one per dp
    index d), the dp groups ranks s, s + sp, ... (one per sp index s).
    Every rank creates every group, in the same order (new_group is a
    collective of the world)."""
    me = rank()
    wait = datetime.timedelta(seconds=TIMEOUT_S)
    groups = [dist.new_group([d * sp + s for s in range(sp)], timeout=wait)
              for d in range(dp)]
    groups += [dist.new_group([d * sp + s for d in range(dp)], timeout=wait)
               for s in range(sp)]
    return groups[me // sp], groups[dp + me % sp]


def host_local_batch_slice(global_batch: int) -> tuple[int, int]:
    """(rows of each rank, this rank's first row) of a global batch split
    over the ranks; raises where the ranks do not divide it."""
    return local_rows(global_batch, world_size(), rank())


def local_rows(global_batch: int, parts: int, index: int) -> tuple[int, int]:
    """(rows of each part, part `index`'s first row)."""
    if global_batch % parts:
        raise ValueError(f"global batch {global_batch} % {parts} ranks != 0")
    local = global_batch // parts
    return local, local * index


def _rank_entry(local_rank: int, fn, queue, args) -> None:
    queue.put((local_rank, fn(local_rank, *args)))


def run_ranks(fn, n: int, *args) -> list:
    """fn(local_rank, *args) in `n` spawned processes; their results by
    local rank.  fn and its arguments and results are pickled: a function
    of a module, numpy arrays and plain values, no CUDA tensors.  A rank
    that raises stops the others and raises here."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.SimpleQueue()
    procs = torch_mp.start_processes(_rank_entry, args=(fn, queue, args),
                                     nprocs=n, join=False,
                                     start_method="spawn")
    results: dict = {}
    done = False
    while not done:
        done = procs.join(timeout=0.2)
        while not queue.empty():         # drained before every join
            i, r = queue.get()
            results[i] = r
    return [results[i] for i in range(n)]
