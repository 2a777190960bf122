"""Domain decomposition (counterpart of `fea_large_tpu/dist/`): the generic
and the structured sharded solvers on `torch.distributed`, one process per
shard (dist/launch.py, dist/comm.py)."""

from fea_large_tpu_torch.dist.partition import Partition, partition_mesh  # noqa: F401
from fea_large_tpu_torch.dist.sharded import ShardedNewtonSolver  # noqa: F401
from fea_large_tpu_torch.dist.structured import (  # noqa: F401
    StructuredPartition,
    structured_partition,
)
from fea_large_tpu_torch.dist.structured_solver import (  # noqa: F401
    StructuredShardedSolver,
    make_sharded_solver,
)
