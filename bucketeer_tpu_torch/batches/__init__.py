"""The compressed-domain batch data plane on the card.

The coefficient reads produce per-subband coefficient tensors for ONE
image (:func:`decode_to_coefficients`), and the scheduler has a
multi-device pool — this package assembles MANY images into the batch a
training job consumes ("RGB no more", PAPERS.md: ViTs train on
minimally-decoded frequency coefficients, so the JP2 store doubles as a
dataloader).

- :mod:`.recipe`   — :class:`BatchRecipe` + strict request validation
  (typed :class:`InvalidParam`, never a 500);
- :mod:`.assemble` — fan the per-image coefficient decodes across the
  device pool as ``kind="batchread"`` work, merge compatible dequant
  launches (engine/scheduler.py ``_launch_dequant``), and place one
  per-subband batched tensor over the visible devices, split along the
  batch axis or replicated;
- :mod:`.store`    — the ``BTB1`` batch container: per-band BTT1 blobs
  behind one manifest header, progressively truncatable plane-by-plane
  ("RD-Optimized Trit-Plane Coding", PAPERS.md, is the playbook: cheap
  low-plane batches first).
"""
from .assemble import BatchResult, assemble_batch, set_metrics_sink
from .recipe import BatchRecipe, parse_recipe
from .store import (batch_stats, decode_batch, encode_batch,
                    truncate_batch)

__all__ = ["BatchRecipe", "parse_recipe", "BatchResult",
           "assemble_batch", "set_metrics_sink", "encode_batch",
           "decode_batch", "truncate_batch", "batch_stats"]
