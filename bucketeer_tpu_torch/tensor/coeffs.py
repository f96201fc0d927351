"""Compressed-domain coefficient delivery: stop the decode after
Tier-1 + dequantization and hand the caller per-subband coefficient
tensors on its device.

Vision models can be fed minimally decoded transform coefficients
instead of pixels; this module is that read path for our codestreams.
:func:`decode_to_coefficients` runs Tier-2 parsing and host Tier-1
exactly like ``decode()`` and then *stops*: no inverse DWT, no inverse
color transform, no level shift. The decoded half-magnitudes go to the
device in one host-to-device copy and dequantize there as torch ops
(:func:`run_dequant_inline`); the bands are returned as **torch
tensors on that device** ("cuda" unless the caller asks for "cpu") — a
training job consumes them with no host round-trip, and composing with
the stream index makes ``region=`` reads a sharded, random-access
coefficient input pipeline.

Subband layout contract (the shape tests pin):

- bands are keyed ``(res, name)``: ``(0, "LL")`` plus
  ``(r, "HL"/"LH"/"HH")`` for ``r = 1 .. levels - reduce``;
- each band is one ``(C, H_b, W_b)`` plane assembled across the tile
  grid: tile ``(ty, tx)``'s band rectangle sits at the prefix-sum
  origin of the preceding tiles' band extents (per-tile DWT means the
  global plane is a grid of per-tile bands, not one whole-image
  transform — documented, deterministic, and exactly what "slicing the
  subband state out of a full decode" produces);
- values are exact coefficients: reversible streams give int32
  ``sign * (|hval| >> 1)``, irreversible float32
  ``float32(hval) * float32(delta_b/2)`` — one IEEE multiply, which
  rounds alike on the card and the CPU (the decode inverse's own
  dequantization, stopped early);
- ``region=(x, y, w, h)`` (full-resolution reference-grid coords) maps
  through ``reduce`` to the sample window and then per band through
  the band's dyadic factor ``d`` (``d = level`` for detail bands,
  ``levels - reduce`` for LL) as
  ``[w0 >> d, ceil(w1 / 2^d))`` clamped to the band — the exact crop
  of the full coefficient read the parity tests assert, with Tier-1
  running only for code-blocks intersecting those windows.
"""
from __future__ import annotations

import struct
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..codec.decode import decoder as decoder_mod
from ..codec.decode import index as sindex
from ..codec.decode import parser
from ..codec.decode.device import require_device
from ..codec.decode.errors import DecodeError, InvalidParam
from ..codec.encoder import _ceil_div
from ..codec.pipeline import _band_geometry


def band_keys(levels: int) -> list:
    """Canonical band order: LL first, then resolutions coarse to fine,
    HL/LH/HH within each — the order the dequant program's inputs and
    every ``bands`` dict iterate in."""
    return [(0, "LL")] + [(r, n) for r in range(1, levels + 1)
                          for n in ("HL", "LH", "HH")]


def band_downsample(res: int, levels: int) -> int:
    """log2 of the band's dyadic subsampling relative to the reduced
    sample grid: LL is ``levels`` deep, the detail bands of resolution
    ``r`` sit at level ``levels - r + 1``."""
    return levels if res == 0 else levels - res + 1


def band_window(w0: int, w1: int, d: int, extent: int) -> tuple:
    """Map a sample window edge pair through a band's dyadic factor:
    ``[w0 >> d, ceil(w1 / 2^d))`` clamped to the band extent — the
    subband-slicing rule of the module contract."""
    a = min(w0 >> d, extent)
    b = min(_ceil_div(w1, 1 << d), extent)
    return a, max(a, b)


@dataclass
class CoefficientSet:
    """The product of :func:`decode_to_coefficients`: per-subband
    coefficient planes (torch tensors on the read's device) plus the
    geometry to interpret them. ``windows`` is None for full reads; for
    region reads it maps each band to the ``(y0, y1, x0, x1)``
    rectangle of the global band plane the returned array covers."""
    width: int
    height: int
    n_comps: int
    bitdepth: int
    levels: int              # levels remaining after ``reduce``
    reduce: int
    reversible: bool
    used_mct: bool
    bands: dict              # (res, name) -> tensor (C, H_b, W_b)
    deltas: dict             # (res, name) -> signaled quantizer step
    region: tuple | None = None
    windows: dict | None = None

    @property
    def nbytes(self) -> int:
        return sum(int(a.nbytes) for a in self.bands.values())

    def to_host(self) -> dict:
        """Every band as a host numpy array — the set's one
        device-to-host seam; in-process consumers feed the device
        tensors onward instead."""
        return {key: (arr.materialize() if isinstance(arr, BandSlice)
                      else arr).cpu().numpy()
                for key, arr in self.bands.items()}

    def clone(self) -> "CoefficientSet":
        """A copy whose bands share no storage with this set's (a lazy
        BandSlice is materialized first), on the same device: the bands
        (of the set's one dtype) are copied into one new buffer by one
        concatenation, and each is a view of its own part of it."""
        bands = {key: arr.materialize() if isinstance(arr, BandSlice)
                 else arr for key, arr in self.bands.items()}
        flat = torch.cat([arr.reshape(-1) for arr in bands.values()])
        parts = flat.split([arr.numel() for arr in bands.values()])
        return replace(self, bands={
            key: part.view(arr.shape)
            for (key, arr), part in zip(bands.items(), parts)},
            deltas=dict(self.deltas),
            windows=None if self.windows is None else dict(self.windows))


# --- scheduler seam -------------------------------------------------------

_TLS = threading.local()


@contextmanager
def coeff_services(check=None, launch=None):
    """Install per-thread hooks for the duration of a coefficient read
    — the coefficient analog of ``tensor_services``:

    - ``check()`` is polled at per-tile Tier-1 boundaries (the
      scheduler's deadline hook for ``kind="batchread"`` jobs);
    - ``launch(reversible, deltas, arrays, device)`` (``device`` the
      torch.device the read asked for) replaces the inline
      dequant dispatch, so a scheduler can queue the dequant on its
      device pool, where compatible launches from concurrent batch
      items merge into one. Must return the same tuple of per-band
      device tensors the inline path produces.
    """
    prev = (getattr(_TLS, "check", None), getattr(_TLS, "launch", None))
    _TLS.check, _TLS.launch = check, launch
    try:
        yield
    finally:
        _TLS.check, _TLS.launch = prev


def _poll() -> None:
    check = getattr(_TLS, "check", None)
    if check is not None:
        check()


def current_services() -> tuple:
    """The calling thread's installed ``(check, launch)`` hooks, or
    ``(None, None)``. The batch assembler reads these on the admitted
    request thread and re-installs them (with the fan-out width bound)
    in each of its item worker threads — thread-locals don't cross the
    fan-out otherwise."""
    return (getattr(_TLS, "check", None),
            getattr(_TLS, "launch", None))


# --- the dequant back half ------------------------------------------------

def dequant(reversible: bool, deltas: tuple, hvs: list) -> tuple:
    """The coefficient dequantizer as torch ops on the planes' device:
    per-band (C, H_b, W_b) int32 half-magnitude planes to coefficient
    planes of the same shapes — int32 ``sign * (|hv| >> 1)`` on a
    reversible stream, else float32 ``float32(hv) * float32(delta/2)``
    (the factor is rounded to float32 on the host, so the product is
    one IEEE float32 multiply on any device)."""
    out = []
    for hv, delta in zip(hvs, deltas):
        if reversible:
            mag = hv.abs() >> 1
            out.append(torch.where(hv < 0, -mag, mag))
        else:
            out.append(hv.to(torch.float32)
                       * float(np.float32(delta * 0.5)))
    return tuple(out)


class BandSlice:
    """One image's row of a merged batched-dequant output: a lazy view
    ``parent[index]`` a scheduler's combined launch hands back to each
    fanned-out item instead of paying a device slice per band per
    image. A batch assembler can recognize sibling views of one parent
    and gather the whole batch at once; any other consumer
    materializes transparently via :func:`numpy.asarray`."""

    __slots__ = ("parent", "index")

    def __init__(self, parent, index: int):
        self.parent = parent
        self.index = index

    @property
    def shape(self):
        return self.parent.shape[1:]

    @property
    def dtype(self):
        return self.parent.dtype

    def materialize(self):
        return self.parent[self.index]

    def to_host(self) -> np.ndarray:
        """The row as a host numpy array: the slice's device-to-host
        seam."""
        return self.materialize().cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        arr = self.to_host()
        return arr if dtype is None else arr.astype(dtype)


def _run_dequant(reversible: bool, deltas: tuple, arrays: list, device):
    launch = getattr(_TLS, "launch", None)
    if launch is not None:
        return launch(reversible, deltas, arrays, device)
    return run_dequant_inline(reversible, deltas, arrays, device)


def run_dequant_inline(reversible: bool, deltas: tuple, arrays: list,
                       device="cuda"):
    """Dequantize on ``device`` directly (bypassing any installed
    ``coeff_services`` launch hook): the host planes go over in one
    copy of their concatenation and are split on the device. A merged
    launch may pass per-image planes stacked along a leading batch
    axis — the dequantizer is elementwise per band, so the batched
    outputs slice back per image bit-exactly."""
    device = require_device(device)
    arrays = [np.ascontiguousarray(a, dtype=np.int32) for a in arrays]
    flat = torch.from_numpy(np.concatenate(
        [a.ravel() for a in arrays] or [np.zeros(0, np.int32)])).to(device)
    sizes = [a.size for a in arrays]
    hvs = [part.reshape(a.shape) for part, a in
           zip(torch.split(flat, sizes), arrays)]
    return dequant(reversible, tuple(deltas), hvs)


# --- geometry helpers -----------------------------------------------------

def _tile_grid(ps: parser.ParsedStream) -> tuple:
    return (_ceil_div(ps.height, ps.tile_h),
            _ceil_div(ps.width, ps.tile_w))


def _band_dims(rh: int, rw: int, levels: int) -> dict:
    """(res, name) -> (y0, x0, bh, bw) of the tile-local Mallat layout
    (offsets index the tile's (C, rh, rw) half-magnitude planes)."""
    out = {}
    for name, lvl, y0, x0, bh, bw in _band_geometry(rh, rw, levels):
        res = 0 if name == "LL" else levels - lvl + 1
        out[(res, name)] = (y0, x0, bh, bw)
    return out


def _grid_extents(ps: parser.ParsedStream, reduce: int,
                  levels: int) -> tuple:
    """Per-band global assembly geometry: ({key: (row_offsets,
    col_offsets)}, {key: (H, W)}) where offsets are the prefix sums of
    per-tile-row / per-tile-column band extents."""
    n_ty, n_tx = _tile_grid(ps)
    row_h = [_ceil_div(min(ps.tile_h, ps.height - ty * ps.tile_h),
                       1 << reduce) for ty in range(n_ty)]
    col_w = [_ceil_div(min(ps.tile_w, ps.width - tx * ps.tile_w),
                       1 << reduce) for tx in range(n_tx)]
    offs, dims = {}, {}
    for key in band_keys(levels):
        roffs, total_h = [0], 0
        for rh in row_h:
            bd = _band_dims(rh, col_w[0], levels)[key]
            total_h += bd[2]
            roffs.append(total_h)
        coffs, total_w = [0], 0
        for cw in col_w:
            bd = _band_dims(row_h[0], cw, levels)[key]
            total_w += bd[3]
            coffs.append(total_w)
        offs[key] = (roffs, coffs)
        dims[key] = (total_h, total_w)
    return offs, dims


@dataclass
class _CoeffPlan:
    """Quacks like device.RegionPlan for the Tier-1 window fill
    (decoder._tile_region_hvals consumes ``slots`` only): per-band
    window rectangles in band coordinates, *without* the DWT halo — no
    synthesis runs, so no halo is owed."""
    slots: tuple


# --- the public entry -----------------------------------------------------

def _full_impl(data: bytes, reduce: int, layers,
               device) -> CoefficientSet:
    t0 = time.perf_counter()
    ps = parser.parse(data, reduce=reduce, layers=layers)
    t_parse = time.perf_counter() - t0
    levels = ps.levels - reduce
    offs, dims = _grid_extents(ps, reduce, levels)
    keys = band_keys(levels)
    planes = {key: np.zeros((ps.n_comps,) + dims[key], dtype=np.int32)
              for key in keys}

    n_tx = _tile_grid(ps)[1]
    n_blocks = n_dec = 0
    t_mq = 0.0
    for tile in ps.tiles:
        _poll()
        hv, nb, nd, tm, _ = decoder_mod._tile_hvals(ps, tile, reduce)
        n_blocks += nb
        n_dec += nd
        t_mq += tm
        ty, tx = divmod(tile.idx, n_tx)
        rh, rw = hv.shape[1:]
        bd = _band_dims(rh, rw, levels)
        for key in keys:
            y0, x0, bh, bw = bd[key]
            roffs, coffs = offs[key]
            planes[key][:, roffs[ty]:roffs[ty] + bh,
                        coffs[tx]:coffs[tx] + bw] = \
                hv[:, y0:y0 + bh, x0:x0 + bw]

    deltas = {key: float(ps.quants[key].delta) for key in keys}
    t0 = time.perf_counter()
    out = _run_dequant(ps.reversible,
                       tuple(deltas[k] for k in keys),
                       [planes[k] for k in keys], device)
    t_dq = time.perf_counter() - t0
    _record(ps, t_parse, t_mq, t_dq, n_blocks, n_dec, region=False)
    return CoefficientSet(
        ps.width, ps.height, ps.n_comps, ps.bitdepth, levels, reduce,
        ps.reversible, ps.used_mct, dict(zip(keys, out)), deltas)


def _region_impl(data: bytes, reduce: int, layers, region,
                 idx, device) -> CoefficientSet:
    t0 = time.perf_counter()
    if idx is not None:
        ps = sindex.skeleton(idx)
        if reduce < 0:
            raise InvalidParam(f"invalid reduce {reduce}")
        if layers is not None and layers < 1:
            raise InvalidParam(f"invalid layers {layers}")
        if reduce > ps.levels:
            raise InvalidParam(
                f"reduce={reduce} exceeds {ps.levels} decomposition "
                "levels")
    else:
        ps = parser.parse(data, reduce=reduce, layers=layers)
    t_parse = time.perf_counter() - t0

    levels = ps.levels - reduce
    ry0, ry1, rx0, rx1 = decoder_mod._map_region(
        region, ps.width, ps.height, reduce)
    offs, _ = _grid_extents(ps, reduce, levels)
    keys = band_keys(levels)
    n_ty, n_tx = _tile_grid(ps)

    work = []               # (tidx, (ty, tx), plan, band windows)
    for tidx in range(n_ty * n_tx):
        y0, x0, th, tw = decoder_mod._tile_geometry(ps, tidx)
        ty0, tx0 = decoder_mod._reduced_dims(y0, x0, reduce)
        rh, rw = decoder_mod._reduced_dims(th, tw, reduce)
        wy0, wy1 = max(ry0 - ty0, 0), min(ry1 - ty0, rh)
        wx0, wx1 = max(rx0 - tx0, 0), min(rx1 - tx0, rw)
        if wy0 >= wy1 or wx0 >= wx1:
            continue
        bd = _band_dims(rh, rw, levels)
        wins = {}
        slots = []
        for res in range(1, levels + 1):
            for name in ("HL", "LH", "HH"):
                d = band_downsample(res, levels)
                _, _, bh, bw = bd[(res, name)]
                by0, by1 = band_window(wy0, wy1, d, bh)
                bx0, bx1 = band_window(wx0, wx1, d, bw)
                wins[(res, name)] = (by0, by1, bx0, bx1)
                slots.append((name, levels - res + 1, by0, by1, bx0,
                              bx1, float(ps.quants[(res, name)].delta)))
        d = band_downsample(0, levels)
        _, _, bh, bw = bd[(0, "LL")]
        by0, by1 = band_window(wy0, wy1, d, bh)
        bx0, bx1 = band_window(wx0, wx1, d, bw)
        wins[(0, "LL")] = (by0, by1, bx0, bx1)
        slots.append(("LL", levels, by0, by1, bx0, bx1,
                      float(ps.quants[(0, "LL")].delta)))
        work.append((tidx, divmod(tidx, n_tx),
                     _CoeffPlan(tuple(slots)), wins))

    if idx is not None:
        t0 = time.perf_counter()
        max_layers = ps.n_layers if layers is None else min(
            layers, ps.n_layers)
        sindex.parse_tiles(
            data, idx, ps,
            {tidx: decoder_mod._slot_windows(plan, levels)
             for tidx, _, plan, _ in work},
            levels, max_layers)
        t_parse += time.perf_counter() - t0

    # Output window rectangles on the global band planes, from the
    # participating tiles' windows (adjacent tiles' windows abut, so
    # min/max over tiles is exact).
    out_win = {}
    for key in keys:
        rect = None
        for _, (ty, tx), _, wins in work:
            by0, by1, bx0, bx1 = wins[key]
            roffs, coffs = offs[key]
            gy0, gy1 = roffs[ty] + by0, roffs[ty] + by1
            gx0, gx1 = coffs[tx] + bx0, coffs[tx] + bx1
            if rect is None:
                rect = [gy0, gy1, gx0, gx1]
            else:
                rect = [min(rect[0], gy0), max(rect[1], gy1),
                        min(rect[2], gx0), max(rect[3], gx1)]
        out_win[key] = tuple(rect) if rect else (0, 0, 0, 0)

    planes = {key: np.zeros((ps.n_comps,
                             out_win[key][1] - out_win[key][0],
                             out_win[key][3] - out_win[key][2]),
                            dtype=np.int32) for key in keys}
    tiles_by_idx = {t.idx: t for t in ps.tiles}
    n_blocks = n_dec = 0
    t_mq = 0.0
    for tidx, (ty, tx), plan, wins in work:
        _poll()
        arrays, nb, nd, tm, _ = decoder_mod._tile_region_hvals(
            ps, tiles_by_idx[tidx], reduce, plan)
        n_blocks += nb
        n_dec += nd
        t_mq += tm
        # Slot order is details (res 1..L) then LL; re-key and place.
        slot_keys = [(res, name) for res in range(1, levels + 1)
                     for name in ("HL", "LH", "HH")] + [(0, "LL")]
        for key, arr in zip(slot_keys, arrays):
            by0, by1, bx0, bx1 = wins[key]
            roffs, coffs = offs[key]
            oy = roffs[ty] + by0 - out_win[key][0]
            ox = coffs[tx] + bx0 - out_win[key][2]
            planes[key][:, oy:oy + (by1 - by0),
                        ox:ox + (bx1 - bx0)] = arr

    deltas = {key: float(ps.quants[key].delta) for key in keys}
    t0 = time.perf_counter()
    out = _run_dequant(ps.reversible,
                       tuple(deltas[k] for k in keys),
                       [planes[k] for k in keys], device)
    t_dq = time.perf_counter() - t0
    _record(ps, t_parse, t_mq, t_dq, n_blocks, n_dec, region=True)
    return CoefficientSet(
        ps.width, ps.height, ps.n_comps, ps.bitdepth, levels, reduce,
        ps.reversible, ps.used_mct, dict(zip(keys, out)), deltas,
        region=tuple(int(v) for v in region), windows=out_win)


def _record(ps, t_parse, t_mq, t_dq, n_blocks, n_dec,
            region: bool) -> None:
    sink = decoder_mod._metrics_sink
    if sink is None:
        return
    sink.record("decode.t2_parse", t_parse, items=ps.n_packets)
    sink.record("decode.mq", t_mq, items=n_dec)
    sink.record("decode.coeff_dequant", t_dq)
    sink.count("decode.coeff_requests")
    sink.count("decode.blocks", n_blocks)
    sink.count("decode.mq_symbols", n_dec)
    if region:
        sink.count("decode.region_blocks", n_blocks)
    if ps.n_packets_skipped:
        sink.count("decode.packets_skipped", ps.n_packets_skipped)


def decode_to_coefficients(data: bytes, region: tuple | None = None,
                           reduce: int = 0, layers: int | None = None,
                           index=None, device="cuda") -> CoefficientSet:
    """Decode a JP2/JPX file or raw codestream to per-subband
    coefficient tensors on ``device`` (Tier-1 + dequantization only —
    no inverse DWT, color transform, or level shift). ``device="cuda"``
    without CUDA raises before any work; ``"cpu"`` keeps the bands on
    the host.

    ``reduce``/``layers`` as in :func:`codec.decode.decode`;
    ``region=(x, y, w, h)`` returns only the mapped band windows, with
    Tier-1 running solely for the intersecting code-blocks (pass
    ``index`` — a StreamIndex — to also seek Tier-2 straight to the
    intersecting packets). The result is bit-exact against slicing
    the same bands out of a full coefficient read (the
    :func:`band_window` rule). Malformed input raises the typed
    :class:`DecodeError`; impossible parameters raise
    :class:`InvalidParam`."""
    if not isinstance(data, (bytes, bytearray, memoryview)):
        raise TypeError("decode_to_coefficients() expects bytes")
    device = require_device(device)
    try:
        if region is not None:
            return _region_impl(bytes(data), int(reduce), layers,
                                region, index, device)
        return _full_impl(bytes(data), int(reduce), layers, device)
    except DecodeError:
        raise
    except (IndexError, KeyError, ValueError, OverflowError,
            struct.error) as exc:
        raise DecodeError(f"malformed codestream: {exc}") from exc
