"""The sharded path (port of ``recmodels_tpu/parallel/``): a mesh over a
``torch.distributed`` process group, tables split by rows over it with an
all-to-all id exchange, the data-parallel steps, and the processes' start
(``multihost``)."""

from recmodels_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, make_mesh
from recmodels_tpu_torch.parallel.multihost import host_shard, initialize, is_primary
from recmodels_tpu_torch.parallel.sharded_embedding import ShardedTables
from recmodels_tpu_torch.parallel.train_step import (
    build_parallel_accum,
    build_parallel_engine,
    build_parallel_scan,
    build_parallel_steps,
    gather_state,
    shard_state,
    state_specs,
)

__all__ = [
    "make_mesh",
    "DATA_AXIS",
    "Mesh",
    "ShardedTables",
    "build_parallel_accum",
    "build_parallel_engine",
    "build_parallel_scan",
    "build_parallel_steps",
    "gather_state",
    "host_shard",
    "initialize",
    "is_primary",
    "shard_state",
    "state_specs",
]
