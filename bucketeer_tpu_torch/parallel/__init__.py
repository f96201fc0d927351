"""Multi-GPU parallelism: device mesh, data-parallel tile batching, and
row-sharded DWT with halo copies between shards (SURVEY.md §2.3, §5)."""
from .batch import run_tiles_sharded
from .mesh import (DATA_AXIS, TILE_AXIS, DeviceMesh, batch_sharding,
                   make_mesh, replicated, row_sharding, unshard,
                   visible_devices)
from .sharded_dwt import sharded_dwt2d_forward

__all__ = [
    "DATA_AXIS", "TILE_AXIS", "batch_sharding", "make_mesh", "replicated",
    "row_sharding", "run_tiles_sharded", "sharded_dwt2d_forward",
    "DeviceMesh", "unshard", "visible_devices",
]
