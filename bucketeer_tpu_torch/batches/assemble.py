"""Batch assembly: fan-out, merged dequant, placement over a batch mesh.

One admitted ``kind="batchread"`` request produces one
:class:`BatchResult`: per-item coefficient decodes fan out across a
thread pool (each rides the scheduler's device queue as a
``_DequantJob``, where compatible launches from sibling items merge
into one combined launch), and the surviving items assemble into ONE
per-subband batched tensor, split over the visible devices along the
batch axis or copied to each of them (SNIPPETS.md [2]) — bit-exact
against stacking per-image :func:`decode_to_coefficients` calls,
because the dequantizer is elementwise per band.

Failure ladder (the production contract):

- unknown ids / mixed geometry / reduce beyond the coded levels /
  dtype mismatch — the *request* is wrong: typed
  :class:`InvalidParam`, detected by cheap main-header probes before
  any Tier-1 work runs;
- a corrupt item mid-decode — per-item typed failure in the batch
  manifest (``ok: false`` + error type), never all-or-nothing; only a
  batch with zero survivors raises :class:`DecodeError`;
- deadline expiry / scheduler shutdown — batch-fatal: the fan-out is
  drained (no pool worker stranded, no queued per-item job leaked)
  and the typed error propagates to the admission layer.
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import obs
from ..codec.decode import parser
from ..codec.decode.errors import DecodeError, InvalidParam
from ..engine.scheduler import DeadlineExceeded, SchedulerClosed
from ..parallel import mesh as mesh_mod
from ..tensor import coeffs as tcoeffs
from .recipe import BatchRecipe

# Fan-out width: item decode threads per batch. Tier-1 is host work,
# so past the device-pool size extra threads only deepen the dequant
# merge window's fill — small by default.
_FANOUT = int(os.environ.get("BUCKETEER_BATCH_FANOUT", "8"))

_SINK = None

# One persistent fan-out pool for every batch: thread startup costs
# ~10ms of GIL-contended wall each on this class of host, which a
# per-request executor pays N times per batch — straight off the
# margin over decode-then-stack.
_POOL = None
_POOL_LOCK = threading.Lock()


def _fanout_pool() -> ThreadPoolExecutor:
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(
                max_workers=max(1, _FANOUT),
                thread_name_prefix="batchread")
        return _POOL


def set_metrics_sink(sink) -> None:
    """Install the Metrics sink batch assembly records into (item
    failure counts, assembly seconds) — same pattern as
    tensor.codec.set_metrics_sink."""
    global _SINK
    _SINK = sink


@dataclass
class BatchResult:
    """One assembled batch: ``bands`` maps each subband key to the
    list of per-device tensors that hold the logical ``(N, C, H_b,
    W_b)`` batch, whose leading axis is the batch, placed per
    ``layout``: ``sharded`` = one piece of N / n_devices items per
    device of the batch mesh, in batch order; ``replicated`` = one full
    copy per device. ``ids`` are the surviving items in batch order —
    row ``i`` of every band belongs to ``ids[i]``; ``manifest`` records
    every *recipe* item, failed ones with their typed error."""
    ids: tuple
    bands: dict                  # (res, name) -> [tensor per device]
    deltas: dict                 # (res, name) -> quantizer step
    manifest: list               # [{"id", "ok", ["error", "message"]}]
    meta: dict = field(default_factory=dict)
    layout: str = "replicated"

    @property
    def n_items(self) -> int:
        return len(self.ids)

    @property
    def device(self) -> str:
        """The device type the bands lie on."""
        return next(iter(self.bands.values()))[0].device.type

    def _logical(self, parts: list) -> list:
        return parts if self.layout == "sharded" else parts[:1]

    @property
    def nbytes(self) -> int:
        """Bytes of one logical batch (a replicated batch's copies are
        counted once)."""
        return sum(p.numel() * p.element_size()
                   for parts in self.bands.values()
                   for p in self._logical(parts))

    def to_host(self) -> dict:
        """Materialize every batched band on host as one ``(N, C, H_b,
        W_b)`` numpy array — the batch plane's one device->host seam;
        training consumers keep the per-device tensors instead."""
        return {key: np.concatenate([p.cpu().numpy()
                                     for p in self._logical(parts)])
                for key, parts in self.bands.items()}


def _error_entry(image_id: str, exc: BaseException) -> dict:
    return {"id": image_id, "ok": False,
            "error": type(exc).__name__, "message": str(exc)}


def _probe_items(recipe: BatchRecipe, blobs: dict):
    """Cheap main-header pass over every item before any Tier-1 work:
    request-shaped problems (mixed geometry, reduce beyond levels,
    dtype mismatch) become one typed InvalidParam; per-item corrupt
    headers become upfront manifest failures. Returns (ok ids,
    manifest entries for the failures, reference geometry)."""
    geom = {}
    failed = []
    for image_id in recipe.ids:
        try:
            geom[image_id] = parser.probe(blobs[image_id])
        except DecodeError as exc:
            failed.append(_error_entry(image_id, exc))
    ok_ids = [i for i in recipe.ids if i in geom]
    if not ok_ids:
        raise DecodeError(
            "every item in the batch failed the header probe")

    sigs = {i: (g["width"], g["height"], g["n_comps"], g["levels"],
                g["reversible"]) for i, g in geom.items()}
    ref_id = ok_ids[0]
    ref = sigs[ref_id]
    mixed = sorted(i for i in ok_ids if sigs[i] != ref)
    if mixed:
        raise InvalidParam(
            f"mixed geometry: {', '.join(mixed)} differ from "
            f"{ref_id} (batch items must share width/height/"
            f"components/levels/reversibility)")
    if recipe.reduce > ref[3]:
        raise InvalidParam(
            f"reduce={recipe.reduce} beyond the {ref[3]} coded "
            f"decomposition levels")
    want = {"int32": True, "float32": False}.get(recipe.dtype)
    if want is not None and ref[4] != want:
        have = "int32" if ref[4] else "float32"
        raise InvalidParam(
            f"dtype={recipe.dtype} but the codestreams are "
            f"{'reversible' if ref[4] else 'irreversible'} ({have})")
    if recipe.region is not None:
        x, y, w, h = recipe.region
        if x >= ref[0] or y >= ref[1]:
            raise InvalidParam(
                f"region origin ({x}, {y}) outside the "
                f"{ref[0]}x{ref[1]} image")
    return ok_ids, failed, geom[ref_id]


def _placement(n: int, layout: str, device):
    """The batch mesh and the layout for an ``n``-item batch: one data
    axis over every visible device of ``device``'s type, split along
    the batch when it divides the mesh (SNIPPETS.md [2] rule),
    replicated otherwise. ``layout="sharded"`` fails closed instead of
    falling back."""
    mesh = mesh_mod.make_mesh(mesh_mod.visible_devices(device))
    if layout == "replicated":
        return mesh, "replicated"
    divides = n % mesh.size == 0
    if layout == "sharded" and not divides:
        raise InvalidParam(
            f"layout=sharded but the {n}-item batch does not divide "
            f"the {mesh.size}-device mesh")
    return mesh, "sharded" if divides else "replicated"


def assemble_batch(recipe: BatchRecipe, *, data_for=None,
                   device="cuda") -> BatchResult:
    """Assemble one batch on ``device``'s type under the CALLER's
    admission: run this through ``scheduler.submit_batchread`` so the
    deadline hook and the merged-dequant launch hook are installed
    (``coeff_services``) — standalone calls still work, with inline
    dequant and no deadline.

    ``data_for(image_id)`` returns the item's JP2/JPX bytes or None
    for unknown ids (the server binds the derivative store; tests and
    scripts bind dicts)."""
    import time as _time

    if data_for is None:
        from ..converters import derivative_path

        def data_for(image_id):
            path = derivative_path(image_id)
            if path is None or not os.path.exists(path):
                return None
            with open(path, "rb") as fh:
                return fh.read()

    t0 = _time.perf_counter()
    blobs, unknown = {}, []
    for image_id in recipe.ids:
        data = data_for(image_id)
        if data is None:
            unknown.append(image_id)
        else:
            blobs[image_id] = data
    if unknown:
        raise InvalidParam(f"unknown image ids: {', '.join(unknown)}")

    ok_ids, upfront_failed, _ = _probe_items(recipe, blobs)

    # The admitted request thread owns the scheduler hooks
    # (thread-locals): capture them here, re-install in every item
    # worker with the fan-out width bound so the device worker's merge
    # window knows how many compatible dequant launches to wait for.
    check, launch = tcoeffs.current_services()
    n = len(ok_ids)
    # Only min(n, fan-out width) items decode concurrently, so that is
    # the most compatible dequant launches the merge window can ever
    # see at once — advertising n would burn the window waiting for
    # stragglers that cannot arrive.
    expected = min(n, max(1, _FANOUT))
    bound_launch = None
    if launch is not None:
        def bound_launch(reversible, deltas, arrays, dev):
            return launch(reversible, deltas, arrays, dev,
                          _expected=expected)
    parent_ctx = obs.current_context()
    request_id = obs.current_request_id()

    def decode_item(idx: int):
        image_id = ok_ids[idx]
        with obs.request_context(request_id), \
                obs.use_context(parent_ctx), \
                obs.span("batchread.item", image_id=image_id,
                         index=idx), \
                tcoeffs.coeff_services(check=check,
                                       launch=bound_launch):
            return tcoeffs.decode_to_coefficients(
                blobs[image_id], region=recipe.region,
                reduce=recipe.reduce, layers=recipe.layers,
                device=device)

    sets: list = [None] * n
    failures: dict = {}
    fatal: BaseException | None = None
    futs = {_fanout_pool().submit(decode_item, i): i
            for i in range(n)}
    # The result loop waits on EVERY item, fatal or not: a batch-fatal
    # error never leaves a pool worker holding a queued dequant job
    # the caller no longer waits for.
    for fut in futs:
        i = futs[fut]
        try:
            sets[i] = fut.result()
        except (DeadlineExceeded, SchedulerClosed) as exc:
            fatal = fatal or exc
        except DecodeError as exc:
            failures[i] = _error_entry(ok_ids[i], exc)
            if _SINK is not None:
                _SINK.count("batchread.item_failures")
    if fatal is not None:
        raise fatal

    manifest = list(upfront_failed)
    kept_ids, kept_sets = [], []
    for i, image_id in enumerate(ok_ids):
        if i in failures:
            manifest.append(failures[i])
        else:
            manifest.append({"id": image_id, "ok": True})
            kept_ids.append(image_id)
            kept_sets.append(sets[i])
    # Manifest rows in recipe order, like the batch axis.
    order = {image_id: k for k, image_id in enumerate(recipe.ids)}
    manifest.sort(key=lambda e: order[e["id"]])
    if not kept_sets:
        raise DecodeError("every item in the batch failed to decode")

    ref = kept_sets[0]
    mesh, layout = _placement(len(kept_sets), recipe.layout, device)
    with obs.span("batchread.assemble", items=len(kept_sets),
                  layout=layout, bands=len(ref.bands)):
        keys = list(ref.bands)
        cols = [[cs.bands[key] for cs in kept_sets] for key in keys]
        shared = all(
            isinstance(v, tcoeffs.BandSlice)
            and v.parent is col[0].parent
            for col in cols for v in col)
        if shared:
            # Every item rode ONE merged dequant launch: gather its
            # rows out of the shared batched output in batch order.
            parents = [col[0].parent for col in cols]
            idx = torch.as_tensor([v.index for v in cols[0]],
                                  device=parents[0].device)
            stacked = [p.index_select(0, idx) for p in parents]
        else:
            # Items landed in different launches (window split,
            # partial failure mid-wave), maybe on different pool
            # devices: stack per item on the first item's device.
            stacked = []
            for col in cols:
                parts = [v.materialize()
                         if isinstance(v, tcoeffs.BandSlice) else v
                         for v in col]
                stacked.append(torch.stack(
                    [p.to(parts[0].device) for p in parts]))
        # Mesh placement last: the stack/gather ran on the dequant
        # pool device; the split or the copies go to the batch mesh
        # (no copy where a mesh entry IS that device).
        place = (mesh_mod.batch_sharding if layout == "sharded"
                 else mesh_mod.replicated)
        bands = {key: place(t, mesh) for key, t in zip(keys, stacked)}

    meta = {"width": ref.width, "height": ref.height,
            "n_comps": ref.n_comps, "bitdepth": ref.bitdepth,
            "levels": ref.levels, "reduce": ref.reduce,
            "reversible": ref.reversible, "used_mct": ref.used_mct,
            "region": recipe.region, "layers": recipe.layers,
            "n_devices": mesh.size}
    if _SINK is not None:
        _SINK.count("batchread.batches")
        _SINK.count("batchread.items", len(kept_sets))
        _SINK.record("batchread.assemble",
                     _time.perf_counter() - t0)
    return BatchResult(ids=tuple(kept_ids), bands=bands,
                       deltas=dict(ref.deltas), manifest=manifest,
                       meta=meta, layout=layout)
