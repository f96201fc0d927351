"""Modeled cost for the merged launch span and the pipeline mapper.

The launch span carries a ``modeled_s`` attribute next to its measured
duration so every device launch is a measured-vs-modeled data point —
the drift signal that tells "the kernel got faster" from "the model was
wrong". The model is the checked-in manifest's cost fingerprint
(``.graftaudit-torch-manifest.json``, written by ``python -m
bucketeer_tpu_torch.analysis --write-manifest``) for the front-end
program, rooflined through :mod:`..analysis.graftcost`'s machine models
and scaled linearly from the nearest canonical batch bucket —
deliberately cheap (one JSON read per process, no audit at serve time)
and deliberately approximate (the manifest models canonical variants,
not every tile shape).

The machine is the launch's own device: ``h100`` for a CUDA device,
``cpu`` for the CPU — never what happens to be installed.
"""
from __future__ import annotations

import json
import threading
from pathlib import Path

from ..analysis.deviceaudit import MANIFEST_NAME

_LOCK = threading.Lock()
_CACHE: dict = {"loaded": False, "entries": None, "programs": None}

MANIFEST = Path(__file__).resolve().parents[2] / MANIFEST_NAME


def _pow2_at_least(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


def _load_programs() -> dict | None:
    try:
        data = json.loads(MANIFEST.read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError):
        return None
    return data.get("programs") or None


def _rows_entries(programs: dict) -> list | None:
    """[(program_key, bucket_B, cost_dict)] for the front-end row
    programs; None when there are none."""
    entries = []
    for key, rec in programs.items():
        if not key.startswith("frontend.rows/"):
            continue
        cost = rec.get("cost")
        try:
            b = int(key.rsplit("/B", 1)[-1])
        except ValueError:
            continue
        if cost:
            entries.append((key, b, cost))
    return entries or None


def _cached() -> tuple:
    """(rows entries, programs) of the manifest, read once per process
    (``_CACHE`` is the test seam, as in the JAX package)."""
    with _LOCK:
        if not _CACHE["loaded"]:
            programs = _load_programs()
            _CACHE["programs"] = programs
            _CACHE["entries"] = (_rows_entries(programs) if programs
                                 else None)
            _CACHE["loaded"] = True
        return _CACHE["entries"], _CACHE["programs"]


def _machine(device):
    from ..analysis import graftcost

    return graftcost.machine_for(device)


def _roofline(cost: dict, machine) -> float:
    return (max(cost.get("flops", 0) / machine.peak_flops,
                cost.get("hbm_bytes", 0) / machine.hbm_bytes_per_s)
            + cost.get("scan_depth", 0) * machine.seq_step_s
            + cost.get("launches", 0) * machine.launch_s)


def modeled_launch_seconds(n_tiles: int, device="cuda") -> tuple | None:
    """(modeled seconds, source label) for a merged rows-mode front-end
    launch of ``n_tiles`` tiles on ``device``, or None when no model is
    available. Picks the manifest entry with the nearest canonical
    bucket and scales the roofline time by padded_tiles / bucket."""
    entries, _ = _cached()
    if not entries or n_tiles <= 0:
        return None
    machine = _machine(device)
    padded = _pow2_at_least(n_tiles)
    key, bucket, cost = min(
        entries, key=lambda e: (abs(e[1] - padded), e[0]))
    scaled = _roofline(cost, machine) * (padded / bucket)
    return scaled, f"{key}@{machine.name}"


def modeled_stage_costs(device="cuda") -> tuple | None:
    """(front_end_seconds, fused_t1_seconds) for the scheduler's
    bi-criteria pipeline mapper on ``device``, or None when the manifest
    is unavailable. The front-end stage is the cxd-mode program
    (``frontend.cxd/...``) and the Tier-1 stage the fused CX/D+MQ
    program (``cxdmq.fused/...``, not the kernel entry — the JAX
    package's choice), both rooflined through the same machine model
    as :func:`modeled_launch_seconds`. Absolute scale cancels in the
    mapper's ratios, so canonical-variant costs are exactly enough."""
    _, programs = _cached()
    if not programs:
        return None
    machine = _machine(device)
    front = t1 = None
    for key, rec in programs.items():
        cost = rec.get("cost")
        if not cost:
            continue
        if key.startswith("frontend.cxd/") and front is None:
            front = _roofline(cost, machine)
        elif key.startswith("cxdmq.fused/") and \
                not key.startswith("cxdmq.fused.pallas/") and t1 is None:
            t1 = _roofline(cost, machine)
    if front is None or t1 is None or front <= 0 or t1 <= 0:
        return None
    return front, t1


def reset_cache() -> None:
    """Test seam: drop the memoized manifest."""
    with _LOCK:
        _CACHE.update(loaded=False, entries=None, programs=None)
