"""Parallelism over `torch.distributed` (`bdm_tpu/parallel/`): data
parallelism (`mesh`: one process a rank, the batch split over ranks) and
the point-sharded large-N path (`point_sharded`: the point axis split over
the ranks of a group). `parallel.dryrun.dryrun_multichip` runs both on
spawned ranks."""

from bdm_tpu_torch.parallel.mesh import (ShardedNoise, backend_rule,
                                         batch_group, get_world_for_batch,
                                         init_distributed, is_main,
                                         replicate, shard_batch, spawn_ranks)

__all__ = ["ShardedNoise", "backend_rule", "batch_group",
           "get_world_for_batch", "init_distributed", "is_main", "replicate",
           "shard_batch", "spawn_ranks"]
