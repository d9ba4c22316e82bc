"""Multi-GPU driver: one process per card over ``torch.distributed``
(port of ``jurassic_tpu/parallel``)."""
from .mesh import (Mesh, init_distributed, make_mesh, rank_channels,
                   rank_rows, world)
from .sharded import (ShardedForwardModel, global_put, global_put_local,
                      host_gather)

__all__ = ["Mesh", "ShardedForwardModel", "global_put", "global_put_local",
           "host_gather", "init_distributed", "make_mesh", "rank_channels",
           "rank_rows", "world"]
