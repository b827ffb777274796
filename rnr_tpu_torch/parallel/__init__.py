"""Data parallelism over ranks: process groups (distributed.py) and the
dp-sharded steps (sharding.py)."""

from rnr_tpu_torch.parallel.distributed import (fetch_global,
                                                host_local_batch_slice,
                                                init_distributed,
                                                is_main_process, run_ranks)
from rnr_tpu_torch.parallel.sharding import (Mesh, batch_sharding,
                                             make_mesh,
                                             make_sharded_dnr_train_step,
                                             make_sharded_rnr_eval_step,
                                             make_sharded_rnr_train_step,
                                             replicated, shard_rnr_batch)

__all__ = ["Mesh", "batch_sharding", "fetch_global", "host_local_batch_slice",
           "init_distributed", "is_main_process", "make_mesh",
           "make_sharded_dnr_train_step", "make_sharded_rnr_eval_step",
           "make_sharded_rnr_train_step", "replicated", "run_ranks",
           "shard_rnr_batch"]
