"""Decode orchestration: parse -> host Tier-1 -> device inverse.

The read-path mirror of ``codec/encoder.py``: Tier-2 parsing and the MQ
pass decode stay on host (byte twiddling and an inherently serial state
machine), the arithmetic back half (dequantize + inverse DWT + inverse
RCT/ICT + level shift) runs as torch ops on ``device`` ("cuda" unless
the caller asks for "cpu"), batched across same-shape tiles like the
encode pipeline. There is no fallback: a read for the card on a machine
without CUDA raises before any work.

``decode(data, reduce=r)`` stops at resolution level ``r`` — Tier-1
never touches the skipped subbands' code-blocks, which is the bulk of
the file (JPEG 2000's resolution scalability) — and ``layers=l``
truncates every code-block at quality layer ``l``.
"""
from __future__ import annotations

import struct
import time

import numpy as np

from ..encoder import _ceil_div
from ..pipeline import _band_geometry
from . import index as sindex
from . import parser, t1_dec
from .device import (RegionPlan, make_inverse_plan, make_region_plan,
                     require_device, run_inverse, run_region_inverse)
from .errors import DecodeError, InvalidParam

# Optional per-stage timing/counter sink: any object with ``record`` and
# ``count`` (the JAX package's server metrics have that shape).
_metrics_sink = None


def set_metrics_sink(sink) -> None:
    """Install a metrics sink with ``record(stage, seconds, pixels=0,
    items=0)`` and ``count(name, n=1)``. None disables."""
    global _metrics_sink
    _metrics_sink = sink


def _tile_hvals(ps: parser.ParsedStream, tile: parser.DecTile,
                reduce: int) -> tuple:
    """Tier-1 decode one tile's kept code-blocks and assemble them into
    (C, rh, rw) int32 half-magnitude Mallat planes. Returns
    (planes, n_blocks, n_decisions, mq_seconds, asm_seconds)."""
    levels_used = ps.levels - reduce
    rh, rw = _reduced_dims(tile.th, tile.tw, reduce)
    local = {}
    for name, lvl, y0, x0, bh, bw in _band_geometry(rh, rw, levels_used):
        res = 0 if name == "LL" else levels_used - lvl + 1
        local[(res, name)] = (y0, x0, bh, bw)

    specs = []
    places = []           # (comp, local y, local x, block h, block w)
    for c, resolutions in enumerate(tile.comp_res):
        for res in range(levels_used + 1):
            for band in resolutions[res]:
                ly0, lx0, lbh, lbw = local[(res, band.name)]
                if (lbh, lbw) != (band.by1 - band.by0,
                                  band.bx1 - band.bx0):
                    raise DecodeError(
                        f"band {band.name}@r{res}: reduced geometry "
                        "disagrees with the coded band rectangle")
                for (cy, cx), blk in sorted(band.blocks.items()):
                    gy0 = max(cy << ps.ycb, band.by0)
                    gy1 = min((cy + 1) << ps.ycb, band.by1)
                    gx0 = max(cx << ps.xcb, band.bx0)
                    gx1 = min((cx + 1) << ps.xcb, band.bx1)
                    specs.append((blk.data, blk.nbps, blk.npasses,
                                  band.name, gy1 - gy0, gx1 - gx0))
                    places.append((c, ly0 + gy0 - band.by0,
                                   lx0 + gx0 - band.bx0))

    t0 = time.perf_counter()
    hvs, n_dec = t1_dec.decode_blocks(specs)
    t_mq = time.perf_counter() - t0

    t0 = time.perf_counter()
    planes = np.zeros((ps.n_comps, rh, rw), dtype=np.int32)
    for (c, y, x), hv in zip(places, hvs):
        bh, bw = hv.shape
        planes[c, y:y + bh, x:x + bw] = hv
    t_asm = time.perf_counter() - t0
    return planes, len(specs), n_dec, t_mq, t_asm


def _reduced_dims(a: int, b: int, reduce: int) -> tuple:
    """Map a (y, x) coordinate or extent pair from the reference grid to
    the reduced grid: ceil-divide by 2^reduce (T.800 B-15 for LL)."""
    s = 1 << reduce
    return _ceil_div(a, s), _ceil_div(b, s)


# --- region reads ---------------------------------------------------------

def _map_region(region, width: int, height: int, reduce: int) -> tuple:
    """Validate a full-resolution (x, y, w, h) region and map it to the
    covering rectangle on the reduced grid: floor(lo / 2^r) ..
    ceil(hi / 2^r), the exact crop indices of a ``reduce``-d full
    decode. Extents are clipped to the image (IIIF semantics); an
    origin outside the image or a non-positive extent is the caller's
    error, not the data's."""
    try:
        coords = []
        for v in region:
            iv = int(v)
            if iv != v:            # reject 1.5 etc., not just "a"
                raise ValueError(v)
            coords.append(iv)
        x, y, w, h = coords
    except (TypeError, ValueError, OverflowError):
        raise InvalidParam(f"invalid region {region!r}: expected four "
                           "integers x,y,w,h") from None
    if w <= 0 or h <= 0:
        raise InvalidParam(f"invalid region {region!r}: zero or "
                           "negative extent")
    if not (0 <= x < width and 0 <= y < height):
        raise InvalidParam(
            f"region origin ({x}, {y}) outside the {width}x{height} "
            "image")
    x1, y1 = min(x + w, width), min(y + h, height)
    s = 1 << reduce
    return (y // s, _ceil_div(y1, s), x // s, _ceil_div(x1, s))


def _tile_geometry(ps: parser.ParsedStream, tidx: int) -> tuple:
    """(y0, x0, th, tw) of a tile by index — pure arithmetic, usable
    before the tile is parsed (the indexed read path)."""
    n_tx = _ceil_div(ps.width, ps.tile_w)
    ty, tx = divmod(tidx, n_tx)
    y0, x0 = ty * ps.tile_h, tx * ps.tile_w
    return (y0, x0, min(ps.tile_h, ps.height - y0),
            min(ps.tile_w, ps.width - x0))


def _slot_windows(plan: RegionPlan, levels_used: int) -> dict:
    """RegionPlan slots -> {(res, name): (wy0, wy1, wx0, wx1)} band-local
    windows, the shape index.parse_tiles and the Tier-1 fill consume."""
    out = {}
    for name, lvl, by0, by1, bx0, bx1, _ in plan.slots:
        res = 0 if name == "LL" else levels_used - lvl + 1
        out[(res, name)] = (by0, by1, bx0, bx1)
    return out


def _tile_region_hvals(ps: parser.ParsedStream, tile: parser.DecTile,
                       reduce: int, plan: RegionPlan) -> tuple:
    """Tier-1 decode only the code-blocks intersecting the planned
    windows and assemble per-slot (C, bh, bw) window arrays. Returns
    (arrays, n_blocks, n_decisions, mq_seconds, asm_seconds)."""
    levels_used = ps.levels - reduce
    rh, rw = _reduced_dims(tile.th, tile.tw, reduce)
    expected = {}
    for name, lvl, _, _, bh, bw in _band_geometry(rh, rw, levels_used):
        res = 0 if name == "LL" else levels_used - lvl + 1
        expected[(res, name)] = (bh, bw)

    arrays = [np.zeros((ps.n_comps, by1 - by0, bx1 - bx0),
                       dtype=np.int32)
              for _, _, by0, by1, bx0, bx1, _ in plan.slots]
    specs = []
    places = []              # (slot idx, comp, block-local rect)
    for si, (name, lvl, wy0, wy1, wx0, wx1, _) in enumerate(plan.slots):
        res = 0 if name == "LL" else levels_used - lvl + 1
        for c, resolutions in enumerate(tile.comp_res):
            band = next(b for b in resolutions[res] if b.name == name)
            if expected[(res, name)] != (band.by1 - band.by0,
                                         band.bx1 - band.bx0):
                raise DecodeError(
                    f"band {name}@r{res}: reduced geometry disagrees "
                    "with the coded band rectangle")
            for blk, ly0, ly1, lx0, lx1 in sindex._blocks_in_window(
                    band, ps, (wy0, wy1, wx0, wx1)):
                specs.append((blk.data, blk.nbps, blk.npasses, name,
                              ly1 - ly0, lx1 - lx0))
                places.append((si, c, ly0, ly1, lx0, lx1))

    t0 = time.perf_counter()
    hvs, n_dec = t1_dec.decode_blocks(specs)
    t_mq = time.perf_counter() - t0

    t0 = time.perf_counter()
    for (si, c, ly0, ly1, lx0, lx1), hv in zip(places, hvs):
        _, _, wy0, wy1, wx0, wx1, _ = plan.slots[si]
        oy0, oy1 = max(ly0, wy0), min(ly1, wy1)
        ox0, ox1 = max(lx0, wx0), min(lx1, wx1)
        arrays[si][c, oy0 - wy0:oy1 - wy0, ox0 - wx0:ox1 - wx0] = \
            hv[oy0 - ly0:oy1 - ly0, ox0 - lx0:ox1 - lx0]
    t_asm = time.perf_counter() - t0
    return arrays, len(specs), n_dec, t_mq, t_asm


def _decode_region_impl(data: bytes, reduce: int, layers: int | None,
                        region, idx: sindex.StreamIndex | None, device):
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

    levels_used = ps.levels - reduce
    ry0, ry1, rx0, rx1 = _map_region(region, ps.width, ps.height, reduce)
    out = np.zeros((ry1 - ry0, rx1 - rx0, ps.n_comps), dtype=np.int32)

    def delta_of(lvl, name, _lu=levels_used):
        res = 0 if name == "LL" else _lu - lvl + 1
        return ps.quants[(res, name)].delta

    n_tiles = (_ceil_div(ps.width, ps.tile_w)
               * _ceil_div(ps.height, ps.tile_h))
    work = []                # (tidx, reduced tile origin, plan)
    for tidx in range(n_tiles):
        y0, x0, th, tw = _tile_geometry(ps, tidx)
        ty0, tx0 = _reduced_dims(y0, x0, reduce)
        rh, rw = _reduced_dims(th, tw, reduce)
        wy0, wy1 = max(ry0 - ty0, 0), min(ry1 - ty0, rh)
        wx0, wx1 = max(rx0 - tx0, 0), min(rx1 - tx0, rw)
        if wy0 >= wy1 or wx0 >= wx1:
            continue
        plan = make_region_plan(
            rh, rw, ps.n_comps, levels_used, ps.reversible, ps.bitdepth,
            ps.used_mct, delta_of, wy0, wy1, wx0, wx1)
        work.append((tidx, (ty0, tx0), plan))

    if idx is not None:
        t0 = time.perf_counter()
        max_layers = ps.n_layers if layers is None else min(
            layers, ps.n_layers)
        sindex.parse_tiles(
            data, idx, ps,
            {tidx: _slot_windows(plan, levels_used)
             for tidx, _, plan in work},
            levels_used, max_layers)
        t_parse += time.perf_counter() - t0

    tiles_by_idx = {t.idx: t for t in ps.tiles}
    n_blocks = n_dec = 0
    t_mq = t_asm = t_dev = 0.0
    for tidx, (ty0, tx0), plan in work:
        tile = tiles_by_idx[tidx]
        arrays, nb, nd, tm, ta = _tile_region_hvals(ps, tile, reduce,
                                                    plan)
        n_blocks += nb
        n_dec += nd
        t_mq += tm
        t_asm += ta
        t0 = time.perf_counter()
        tile_img = run_region_inverse(plan, arrays, device)
        t_dev += time.perf_counter() - t0
        # The tile's window is [max(ry0-ty0,0), ...) tile-local; place
        # it back at its global reduced position inside the crop.
        oy = ty0 + max(ry0 - ty0, 0) - ry0
        ox = tx0 + max(rx0 - tx0, 0) - rx0
        out[oy:oy + tile_img.shape[0],
            ox:ox + tile_img.shape[1]] = tile_img

    if _metrics_sink is not None:
        _metrics_sink.record("decode.t2_parse", t_parse,
                             items=ps.n_packets)
        _metrics_sink.record("decode.mq", t_mq, items=n_dec)
        _metrics_sink.record("decode.t1", t_asm, items=n_blocks)
        _metrics_sink.record("decode.device_inverse", t_dev,
                             pixels=out.shape[0] * out.shape[1])
        _metrics_sink.count("decode.blocks", n_blocks)
        _metrics_sink.count("decode.region_blocks", n_blocks)
        _metrics_sink.count("decode.mq_symbols", n_dec)
        if ps.n_packets_skipped:
            _metrics_sink.count("decode.packets_skipped",
                                ps.n_packets_skipped)

    dtype = np.uint8 if ps.bitdepth <= 8 else np.uint16
    out = out.astype(dtype)
    return out[..., 0] if ps.n_comps == 1 else out


def _decode_impl(data: bytes, reduce: int, layers: int | None, device):
    t0 = time.perf_counter()
    ps = parser.parse(data, reduce=reduce, layers=layers)
    t_parse = time.perf_counter() - t0

    levels_used = ps.levels - reduce
    out_h, out_w = _reduced_dims(ps.height, ps.width, reduce)
    out = np.zeros((out_h, out_w, ps.n_comps), dtype=np.int32)

    n_blocks = n_dec = 0
    t_mq = t_asm = 0.0
    groups: dict = {}         # (rh, rw) -> ([planes], [(ry0, rx0)])
    for tile in ps.tiles:
        planes, nb, nd, tm, ta = _tile_hvals(ps, tile, reduce)
        n_blocks += nb
        n_dec += nd
        t_mq += tm
        t_asm += ta
        y0, x0 = tile.origin
        ry0, rx0 = _reduced_dims(y0, x0, reduce)
        key = planes.shape[1:]
        groups.setdefault(key, ([], []))[0].append(planes)
        groups[key][1].append((ry0, rx0))

    t0 = time.perf_counter()
    for (rh, rw), (planes_list, origins) in groups.items():
        def delta_of(lvl, name, _lu=levels_used):
            res = 0 if name == "LL" else _lu - lvl + 1
            return ps.quants[(res, name)].delta

        plan = make_inverse_plan(
            rh, rw, ps.n_comps, levels_used, ps.reversible, ps.bitdepth,
            ps.used_mct, delta_of)
        batch = np.stack(planes_list)
        samples = run_inverse(plan, batch, device)
        for (ry0, rx0), tile_img in zip(origins, samples):
            out[ry0:ry0 + rh, rx0:rx0 + rw] = tile_img
    t_dev = time.perf_counter() - t0

    if _metrics_sink is not None:
        px = ps.width * ps.height
        _metrics_sink.record("decode.t2_parse", t_parse, pixels=px,
                             items=ps.n_packets)
        _metrics_sink.record("decode.mq", t_mq, items=n_dec)
        _metrics_sink.record("decode.t1", t_asm, pixels=out_h * out_w,
                             items=n_blocks)
        _metrics_sink.record("decode.device_inverse", t_dev,
                             pixels=out_h * out_w)
        _metrics_sink.count("decode.blocks", n_blocks)
        _metrics_sink.count("decode.mq_symbols", n_dec)
        if ps.n_packets_skipped:
            _metrics_sink.count("decode.packets_skipped",
                                ps.n_packets_skipped)

    dtype = np.uint8 if ps.bitdepth <= 8 else np.uint16
    out = out.astype(dtype)
    return out[..., 0] if ps.n_comps == 1 else out


def decode(data: bytes, reduce: int = 0, layers: int | None = None,
           region: tuple | None = None, index=None,
           device="cuda") -> np.ndarray:
    """Decode a JP2/JPX file or raw codestream to a numpy image.

    ``reduce=r`` reconstructs at 1/2^r scale from the low-frequency
    subbands only (OpenJPEG's ``-r``); ``layers=l`` truncates at quality
    layer ``l``. Returns (H, W) or (H, W, 3), uint8 for depths <= 8 and
    uint16 above. Malformed or unsupported input raises
    :class:`DecodeError` — never a raw IndexError/struct.error (the
    explicit bounds checks are primary; the blanket catch below is the
    contract's backstop at this trust boundary).

    ``region=(x, y, w, h)`` — full-resolution reference-grid
    coordinates — reconstructs only that window: Tier-1 runs solely for
    the code-blocks intersecting the mapped subband rectangles (plus
    the DWT halo) and the inverse synthesizes only the window.
    The result is the bit-exact crop
    ``full[y//2^r : ceil((y+h)/2^r), x//2^r : ceil((x+w)/2^r)]`` of the
    corresponding full decode. ``index`` (a
    :class:`index.StreamIndex` built by :func:`index.build_index`)
    additionally lets Tier-2 seek straight to the intersecting packets
    instead of walking every packet header.

    The inverse transform runs on ``device``; Tier-2 and Tier-1 run on
    the host. ``device="cuda"`` without a usable CUDA device raises
    RuntimeError before any work.
    """
    if not isinstance(data, (bytes, bytearray, memoryview)):
        raise TypeError("decode() expects bytes")
    device = require_device(device)
    try:
        if region is not None:
            return _decode_region_impl(bytes(data), int(reduce), layers,
                                       region, index, device)
        return _decode_impl(bytes(data), int(reduce), layers, device)
    except DecodeError:
        raise
    except (IndexError, KeyError, ValueError, OverflowError,
            struct.error) as exc:
        raise DecodeError(f"malformed codestream: {exc}") from exc
