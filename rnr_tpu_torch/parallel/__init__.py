"""Data and row parallelism over ranks: process groups
(distributed.py), the halo exchange of image rows (halo.py) and the
(dp, sp)-sharded steps (sharding.py)."""

from rnr_tpu_torch.parallel.distributed import (fetch_global,
                                                host_local_batch_slice,
                                                init_distributed,
                                                is_main_process, run_ranks)
from rnr_tpu_torch.parallel.halo import halo_rows
from rnr_tpu_torch.parallel.sharding import (Mesh, batch_sharding,
                                             make_mesh,
                                             make_sharded_dnr_train_step,
                                             make_sharded_rnr_eval_step,
                                             make_sharded_rnr_train_step,
                                             row_sharding, shard_rnr_batch)

__all__ = ["Mesh", "batch_sharding", "fetch_global", "halo_rows",
           "host_local_batch_slice", "init_distributed", "is_main_process",
           "make_mesh", "make_sharded_dnr_train_step",
           "make_sharded_rnr_eval_step", "make_sharded_rnr_train_step",
           "row_sharding", "run_ranks", "shard_rnr_batch"]
