"""Data-parallel tile batching over the ``data`` mesh axis.

The Lambda fan-out analog (reference: README.md:176 — up to 1000
concurrent converter functions; handlers/LoadCsvHandler.java:256-263
dispatches one item at a time): here a batch of same-shape tiles is
split along its leading dimension over the mesh's data axis and each
piece is transformed (codec/pipeline.py) on its own device — tiles are
independent, so the devices exchange nothing.
"""
from __future__ import annotations

import numpy as np
import torch

from ..analysis.contracts import contract
from ..codec.pipeline import TilePlan, _stageable, _step_map, \
    _transform_batch
from .mesh import DATA_AXIS, DeviceMesh, batch_sharding


@contract(shapes={"tiles": [("B", "h", "w"), ("B", "h", "w", "C")]},
          dtypes={"tiles": "number"})
def run_tiles_sharded(plan: TilePlan, tiles: np.ndarray,
                      mesh: DeviceMesh) -> np.ndarray:
    """Like :func:`bucketeer_tpu_torch.codec.pipeline.run_tiles` but with
    the batch dimension split over the mesh's data axis: piece i is
    transformed on the first device of data row i. Pads the batch up to
    a multiple of the axis size (padding tiles are stripped on return).
    Every piece's transform is queued before the first comes back, so
    separate cards overlap."""
    if tiles.ndim == 3:
        tiles = tiles[..., None]
    b = tiles.shape[0]
    n = mesh.shape[DATA_AXIS]
    pad = (-b) % n
    if pad:
        tiles = np.concatenate(
            [tiles, np.zeros((pad,) + tiles.shape[1:], tiles.dtype)])
    staged = torch.from_numpy(np.ascontiguousarray(_stageable(tiles)))
    outs = []
    for part in batch_sharding(staged, mesh):
        step_map = (None if plan.lossless else
                    torch.as_tensor(_step_map(plan), device=part.device))
        outs.append(_transform_batch(plan, step_map, part))
    return np.concatenate([o.cpu().numpy() for o in outs])[:b]
