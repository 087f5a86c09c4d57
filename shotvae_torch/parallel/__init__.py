"""Data parallelism over ``torch.distributed``, one process per card."""

from shotvae_torch.parallel.mesh import (DataParallel, global_mean,
                                         rank_generator, set_bn_group, setup,
                                         spawn_ranks)

__all__ = ["DataParallel", "global_mean", "rank_generator", "set_bn_group",
           "setup", "spawn_ranks"]
