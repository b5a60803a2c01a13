"""Multi-device ray sharding and multi-process distribution: the JAX
package's ``raystrack_tpu.parallel`` names, on ``torch.distributed``."""
from .sharding import RAY_AXIS, ray_mesh, trace_chunk_sharded
from .distribute import (
    backfill_reciprocity,
    mesh_area,
    partition_emitters,
    view_factor_matrix_partition,
    view_factor_sky_partition,
    view_factor_workflow_partition,
)
from .multihost import (
    initialize,
    view_factor_matrix_multihost,
    view_factor_sky_multihost,
    view_factor_workflow_multihost,
)

__all__ = [
    "ray_mesh",
    "trace_chunk_sharded",
    "RAY_AXIS",
    "partition_emitters",
    "view_factor_matrix_partition",
    "view_factor_sky_partition",
    "view_factor_workflow_partition",
    "backfill_reciprocity",
    "mesh_area",
    "initialize",
    "view_factor_matrix_multihost",
    "view_factor_sky_multihost",
    "view_factor_workflow_multihost",
]
