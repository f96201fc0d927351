"""Row-sharded multi-level 2-D DWT with halo copies between shards.

This is the spatial/context-parallel analog for this workload (SURVEY.md
§5 "long-context"): where the reference routes over-sized images *whole*
to a dedicated second service instance
(reference: verticles/LargeImageVerticle.java:72-97,
handlers/LoadCsvHandler.java:270-281), the port decomposes — one huge
tile's rows are split over the ``tile`` mesh axis, and before each
vertical lifting pass every shard takes a 4-row halo from each
row-neighbour shard as a copy onto its own device (peer to peer between
cards; none when the two mesh entries name one device). The horizontal
pass is fully local.

Correctness argument: every lifting step reads ±1 row of the other
parity, and valid data shrinks by one row per step from each halo edge;
4 halo rows cover the 4-step 9/7 schedule (2-step 5/3 a fortiori), so
after cropping the halos every local row equals the unsharded transform.
Global symmetric boundary extension is reproduced at the outer shards by
reflecting their own edge rows. Each shard keeps an even number of rows
at every level, so the even/odd polyphase split — and therefore the
subband row ordering — is shard-local with no resharding between levels.
Every lifting step is the elementwise form of ``codec/dwt.py``, so each
kept sample is computed by the same operations on the same values as in
the unsharded transform, and rounds alike.
"""
from __future__ import annotations

import numpy as np
import torch

from ..analysis.contracts import contract
from ..codec.dwt import (ALPHA, BETA, DELTA, GAMMA, K_HI, K_LO,
                         _fwd53_last, _fwd97_last)
from ..codec.pipeline import (_epilogue, _mallat, _prologue, _stageable,
                              _step_map)
from .mesh import (TILE_AXIS, DeviceMesh, _nbytes, record_copies,
                   row_sharding, unshard)

HALO = 4  # covers the 4-step 9/7 lifting support


def _halo_pad(shards: list) -> list:
    """Pad each shard's local rows (..., Hs, W) with HALO rows from its
    row-neighbour shards, copied onto its device; the outer shards
    reflect their own boundary (symmetric extension). Each direction is
    one ``halo`` collective on the mesh's copy seam (shard i on tile
    entry i)."""
    out = []
    last = len(shards) - 1
    halo = [_nbytes(x[..., :HALO, :]) for x in shards]
    record_copies("halo", [(halo[i - 1], i - 1, i)
                           for i in range(1, last + 1)])
    record_copies("halo", [(halo[i + 1], i + 1, i)
                           for i in range(last)])
    for i, x in enumerate(shards):
        if i == 0:
            up = torch.flip(x[..., 1:HALO + 1, :], dims=(-2,))
        else:
            up = shards[i - 1][..., -HALO:, :].to(x.device)
        if i == last:
            down = torch.flip(x[..., -HALO - 1:-1, :], dims=(-2,))
        else:
            down = shards[i + 1][..., :HALO, :].to(x.device)
        out.append(torch.cat([up, x, down], dim=-2))
    return out


def _vlift_fwd(xp: torch.Tensor, reversible: bool) -> torch.Tensor:
    """Forward vertical lifting over a halo-padded block. Row parity of
    the padded local index equals global parity (shard heights and HALO
    are even). ``torch.roll`` wraps at the block's edges; the rows it
    corrupts there (one more per step) all lie in the halos, which are
    cropped."""
    rows = torch.arange(xp.shape[-2], device=xp.device)
    even = (rows % 2 == 0)[:, None]
    odd = (rows % 2 == 1)[:, None]

    def nbr(y):
        return torch.roll(y, 1, dims=-2) + torch.roll(y, -1, dims=-2)

    if reversible:
        xp = torch.where(odd, xp - (nbr(xp) >> 1), xp)
        xp = torch.where(even, xp + ((nbr(xp) + 2) >> 2), xp)
    else:
        xp = xp.to(torch.float32)
        xp = torch.where(odd, xp + ALPHA * nbr(xp), xp)
        xp = torch.where(even, xp + BETA * nbr(xp), xp)
        xp = torch.where(odd, xp + GAMMA * nbr(xp), xp)
        xp = torch.where(even, xp + DELTA * nbr(xp), xp)
    return xp


def _local_dwt(levels: int, reversible: bool, shards: list):
    """Multi-level DWT of row shards, each on its own device: returns
    (ll shards, [{"HL", "LH", "HH"}: shards] per level)."""
    fwd = _fwd53_last if reversible else _fwd97_last
    ll = shards if reversible else [s.to(torch.float32) for s in shards]
    bands = []
    for _ in range(levels):
        hs = ll[0].shape[-2]
        if hs % 2 or hs < HALO + 1:
            raise ValueError(
                f"shard rows {hs} must be even and > {HALO} at every "
                f"level; pick tile_parallel/levels so H/(shards*2^levels) "
                f"stays >= {HALO + 1}")
        nxt, level = [], {"HL": [], "LH": [], "HH": []}
        for xp in _halo_pad(ll):
            core = _vlift_fwd(xp, reversible)[..., HALO:-HALO, :]
            v_lo, v_hi = core[..., 0::2, :], core[..., 1::2, :]
            if not reversible:
                v_lo, v_hi = K_LO * v_lo, K_HI * v_hi
            lo, hl = fwd(v_lo)
            lh, hh = fwd(v_hi)
            nxt.append(lo)
            level["HL"].append(hl)
            level["LH"].append(lh)
            level["HH"].append(hh)
        ll = nxt
        bands.append(level)
    return ll, bands


def can_row_shard(h: int, levels: int, n_shards: int) -> bool:
    """True when ``h`` rows split over ``n_shards`` satisfy the sharded
    DWT's invariants at every level: each shard keeps an even row count
    (polyphase split stays shard-local) and more rows than the halo."""
    if n_shards < 2 or h % n_shards:
        return False
    per = h // n_shards
    return per % (1 << levels) == 0 and (per >> levels) >= 3


def _gather(ll: list, bands: list, device):
    """The shard lists of :func:`_local_dwt` as whole bands on
    ``device``."""
    return (unshard(ll, -2, device),
            [{k: unshard(v, -2, device) for k, v in b.items()}
             for b in bands])


@contract(shapes={"x": [("H", "W"), ("C", "H", "W")]},
          dtypes={"x": "number"})
def sharded_dwt2d_forward(x: torch.Tensor, levels: int, reversible: bool,
                          mesh: DeviceMesh):
    """Multi-level forward DWT of one giant tile, rows split over the
    ``tile`` mesh axis.

    x: (H, W) or (C, H, W) with H divisible by (tile-axis size × 2^levels).
    Returns (ll, bands) as :func:`bucketeer_tpu_torch.codec.dwt.
    dwt2d_forward` does, put back together on ``x``'s device.
    """
    x = torch.as_tensor(x)
    return _gather(*_local_dwt(levels, reversible,
                               row_sharding(x, mesh, dim=-2)), x.device)


@contract(shapes={"tile": [("H", "W"), ("H", "W", "C")]},
          dtypes={"tile": "number"})
def sharded_transform_tile(plan, tile: np.ndarray,
                           mesh: DeviceMesh) -> np.ndarray:
    """The single-giant-tile encode transform, rows split over the
    ``tile`` mesh axis: each shard's rows go to its device, where the
    level shift and RCT/ICT (``pipeline._prologue``, elementwise) and
    the sharded DWT run; the bands meet on the mesh's first device for
    the Mallat layout and quantization (``pipeline._epilogue``).
    Produces exactly what :func:`bucketeer_tpu_torch.codec.pipeline.
    run_tiles` returns for a batch of one — a (C, H, W) int32 Mallat
    plane on the host — so the encoder's host Tier-1 path consumes it
    unchanged.

    This is the large-image decompose route (SURVEY.md §5): where the
    reference ships oversized scans whole to a second service instance
    (verticles/LargeImageVerticle.java:72-97), the mesh splits one
    tile's rows across devices and copies DWT halos between them.
    Caller must check :func:`can_row_shard` first.
    """
    if not can_row_shard(plan.tile_h, plan.levels,
                         mesh.shape[TILE_AXIS]):
        raise ValueError(
            f"{plan.tile_h} rows cannot shard over "
            f"{mesh.shape[TILE_AXIS]} devices at {plan.levels} levels; "
            "check can_row_shard() before routing")
    tile = _stageable(np.asarray(tile))
    if tile.ndim == 2:
        tile = tile[..., None]
    shards = row_sharding(torch.from_numpy(np.ascontiguousarray(tile)),
                          mesh, dim=0)
    planes = [_prologue(plan, s[None])[0] for s in shards]
    device = mesh.device_list[0]
    ll, bands = _gather(*_local_dwt(plan.levels, plan.lossless, planes),
                        device)
    step_map = (None if plan.lossless else
                torch.as_tensor(_step_map(plan), device=device))
    return _epilogue(plan, step_map, _mallat(ll, bands)).cpu().numpy()
