"""Code-block-addressable Tier-2 stream index: random access for
region/zoom reads.

A deep-zoom viewer asks for a 512² window of a 100-MPix derivative; the
sequential parser would still walk every packet header in the file to
*find* the handful of packets that matter. The index removes that walk:
built once per stream (and cached by file identity in
``converters/reader.py``), it records for every packet its precinct key
``(comp, res, p_idx)``, quality layer, and ``(offset, length)`` into the
tile's concatenated tile-part bytes — so a region request seeks straight
to the packets of the precincts its window intersects and never parses
the rest of the stream (the reader still loads the file bytes whole —
the decode API is bytes-in — but all per-packet header and entropy
work is confined to the window).

Two build paths:

- **PLT markers** (``ORGgen_plt=yes`` in the reference recipe, and our
  encoder's ``gen_plt``): packet lengths are signaled in the tile-part
  headers, so the index is pure arithmetic — enumerate the packet
  sequence from the coded geometry, accumulate the signaled lengths, and
  never parse a single packet header.
- **Tag-tree walk** otherwise: one full header walk
  (``parser.parse(collect_index=True)``) records the offsets the hard
  way. Still once per stream, amortized across every later region read.

Random access is sound at precinct granularity: every piece of
packet-header state (inclusion/zero-bitplane tag trees, per-block
Lblock) is local to one precinct, chained only across that precinct's
own layers — which the index replays in layer order.
"""
from __future__ import annotations

from dataclasses import dataclass

from .. import codestream as cs
from ..encoder import _ceil_div, _packet_sequence
from . import parser as p
from .errors import DecodeError


@dataclass
class StreamIndex:
    """Per-stream random-access metadata. ``packets[tidx]`` lists
    ``(comp, res, p_idx, layer, offset, length)`` in codestream packet
    order, offsets relative to the tile's concatenated tile-part bytes;
    ``tile_spans[tidx]`` maps those bytes back into the codestream."""
    siz: tuple               # (width, height, n_comps, bitdepth, tw, th)
    cod: dict                # parser._parse_cod shape
    guard: int
    quants: dict             # (res, name) -> SubbandQuant
    tile_spans: dict         # tidx -> [(start, end)] codestream offsets
    packets: dict            # tidx -> [(comp, res, p_idx, layer, off, len)]
    source: str              # "plt" | "walk"
    n_packets: int

    @property
    def nbytes(self) -> int:
        """Rough in-memory footprint estimate — the index tier is
        count-bounded, but this is the size contract tests hold the
        index to (~6 small ints per packet entry plus fixed headers)."""
        return 120 * self.n_packets + 4096


def skeleton(idx: StreamIndex) -> p.ParsedStream:
    """A ParsedStream carrying the indexed stream's coded parameters
    with no tiles parsed — the starting point of an indexed region
    read (``parse_tiles`` fills in exactly the tiles a window needs)."""
    width, height, n_comps, bitdepth, tile_w, tile_h = idx.siz
    cod = idx.cod
    ps = p.ParsedStream(width, height, n_comps, bitdepth, tile_w, tile_h,
                        cod["levels"], cod["n_layers"],
                        cod["progression"], cod["mct"],
                        cod["reversible"], idx.guard,
                        cod["xcb"], cod["ycb"], idx.quants, [],
                        use_sop=cod["use_sop"], use_eph=cod["use_eph"])
    ps.precinct_exps = (cod["precinct_exps"]
                        or p._default_exps(cod["levels"]))
    return ps


def _plt_varints(payload: bytes, out: list) -> None:
    """Decode one PLT segment's packet lengths into ``out``: a Zplt
    byte, then 7-bit big-endian varints (A.7.3). A varint split across
    PLT segments is legal in T.800 but not worth the cross-segment
    state here — a None sentinel sends the caller to the walk path."""
    val = 0
    pending = False
    for b in payload[1:]:
        val = (val << 7) | (b & 0x7F)
        pending = True
        if not b & 0x80:
            out.append(val)
            val = 0
            pending = False
    if pending:
        out.append(None)


def build_index(data: bytes) -> StreamIndex:
    """Build the stream index: PLT arithmetic when the stream signals
    complete packet lengths, one tag-tree header walk otherwise."""
    code = p.unbox_jp2(data)
    r = p._Reader(code)
    if r.u16() != cs.SOC:
        raise DecodeError("missing SOC marker")
    siz, cod, guard, quants = p._parse_main_header(r)
    width, height, n_comps, bitdepth, tile_w, tile_h = siz
    n_tiles = _ceil_div(width, tile_w) * _ceil_div(height, tile_h)

    tile_spans: dict = {}
    plt_lens: dict = {}
    plt_next_z: dict = {}

    def on_segment(isot: int, marker: int, payload: bytes) -> None:
        if marker == cs.PLT:
            lens = plt_lens.setdefault(isot, [])
            # Zplt orders PLT segments logically; T.800 allows them to
            # be *stored* out of that order, in which case naive
            # concatenation would permute the offsets (and the
            # count/sum consistency checks could not tell). Demand
            # physical == logical order, else take the walk path.
            expected = plt_next_z.setdefault(isot, 0)
            if not payload or payload[0] != expected:
                lens.append(None)
                return
            plt_next_z[isot] = (expected + 1) & 0xFF
            _plt_varints(payload, lens)

    for isot, body_start, part_end in p._iter_tile_parts(
            r, code, n_tiles, on_segment):
        tile_spans.setdefault(isot, []).append((body_start, part_end))
    if len(tile_spans) != n_tiles:
        raise DecodeError(
            f"{n_tiles - len(tile_spans)} of {n_tiles} tiles have no "
            "tile-part")

    idx = _from_plt(siz, cod, guard, quants, tile_spans, plt_lens)
    if idx is not None:
        return idx
    # No (or inconsistent) PLT: pay the header walk once.
    ps = p.parse(bytes(data), collect_index=True)
    return StreamIndex(siz, cod, guard, quants, ps.tile_spans,
                       ps.packet_index, "walk", ps.n_packets)


def _from_plt(siz, cod, guard, quants, tile_spans: dict,
              plt_lens: dict) -> StreamIndex | None:
    """PLT fast path: offsets by accumulating signaled lengths along the
    enumerated packet sequence. None when the signaled lengths don't
    cover the packet count and tile bytes exactly."""
    ps = StreamIndex(siz, cod, guard, quants, tile_spans, {}, "plt", 0)
    sk = skeleton(ps)
    packets: dict = {}
    total = 0
    for tidx in sorted(tile_spans):
        lens = plt_lens.get(tidx, [])
        if not lens or any(ln is None for ln in lens):
            return None
        tile = p._build_tile(sk, tidx)
        records = p._build_precincts(sk, tile, sk.precinct_exps)
        seq = list(_packet_sequence(sk.progression, records,
                                    sk.levels + 1, sk.n_comps,
                                    sk.n_layers))
        nbytes = sum(e - s for s, e in tile_spans[tidx])
        if len(lens) != len(seq) or sum(lens) != nbytes:
            return None
        entries = []
        off = 0
        for (rec, layer), ln in zip(seq, lens):
            entries.append((rec.comp, rec.res, rec.p_idx, layer, off, ln))
            off += ln
        packets[tidx] = entries
        total += len(entries)
    ps.packets = packets
    ps.n_packets = total
    return ps


def _blocks_in_window(band, ps: p.ParsedStream, win: tuple):
    """Yield (blk, ly0, ly1, lx0, lx1) for the band's code-blocks whose
    tile-local band rectangle intersects ``win`` = (wy0, wy1, wx0, wx1)
    in the same coordinates."""
    wy0, wy1, wx0, wx1 = win
    for (cy, cx), blk in sorted(band.blocks.items()):
        gy0 = max(cy << ps.ycb, band.by0)
        gy1 = min((cy + 1) << ps.ycb, band.by1)
        gx0 = max(cx << ps.xcb, band.bx0)
        gx1 = min((cx + 1) << ps.xcb, band.bx1)
        ly0, ly1 = gy0 - band.by0, gy1 - band.by0
        lx0, lx1 = gx0 - band.bx0, gx1 - band.bx0
        if ly0 < wy1 and ly1 > wy0 and lx0 < wx1 and lx1 > wx0:
            yield blk, ly0, ly1, lx0, lx1


def _rec_wanted(rec, windows: dict, ps: p.ParsedStream) -> bool:
    """Whether a precinct record holds any code-block intersecting its
    band's window (windows keyed by (res, band name))."""
    for prec in rec.band_precincts:
        win = windows.get((prec.band.res, prec.band.name))
        if win is None:
            continue
        for _ in _blocks_in_window(prec.band, ps, win):
            return True
    return False


def parse_tiles(data: bytes, idx: StreamIndex, ps: p.ParsedStream,
                tile_windows: dict, max_res: int,
                max_layers: int) -> None:
    """Indexed Tier-2: build the requested tiles' geometry and parse
    *only* the packets of precincts whose windows need them, seeking by
    the index instead of walking the stream. ``tile_windows`` maps
    tidx -> {(res, name): (wy0, wy1, wx0, wx1)} band-local windows.
    Parsed tiles are appended to ``ps.tiles``."""
    code = p.unbox_jp2(data)
    parsed = 0
    for tidx in sorted(tile_windows):
        windows = tile_windows[tidx]
        spans = idx.tile_spans.get(tidx)
        entries = idx.packets.get(tidx)
        if spans is None or entries is None:
            raise DecodeError(f"stream index has no tile {tidx}")
        tile = p._build_tile(ps, tidx)
        records = p._build_precincts(ps, tile, ps.precinct_exps)
        rec_of = {(r.comp, r.res, r.p_idx): r for r in records}
        wanted_cache: dict = {}
        # Index offsets are relative to the tile's concatenated
        # tile-part bytes; map each wanted packet back to its file span
        # and parse it in place — no O(tile payload) copy per read.
        # Tile-parts split only at packet boundaries (T.800 A.4.2), so
        # a packet always lives inside one span.
        bounds = []                  # (cum_start, cum_end, file_start)
        cum = 0
        for s, e in spans:
            bounds.append((cum, cum + (e - s), s))
            cum += e - s
        for comp, res, p_idx, layer, off, ln in entries:
            if res > max_res or layer >= max_layers:
                continue
            key = (comp, res, p_idx)
            rec = rec_of.get(key)
            if rec is None:
                raise DecodeError(
                    f"stream index precinct {key} not in tile {tidx} "
                    "geometry")
            want = wanted_cache.get(key)
            if want is None:
                want = wanted_cache[key] = _rec_wanted(rec, windows, ps)
            if not want:
                continue
            end = off + ln
            span = next((b for b in bounds
                         if b[0] <= off and end <= b[1]), None)
            if span is None:
                raise DecodeError(
                    "indexed packet overruns tile bytes"
                    if end > cum else
                    f"indexed packet straddles tile-part boundary in "
                    f"tile {tidx}")
            fpos = span[2] + (off - span[0])
            fend = fpos + ln
            pos = p._parse_packet(ps, code, fpos, fend, rec, layer,
                                  store=True)
            if pos != fend:
                raise DecodeError(
                    f"indexed packet length mismatch in tile {tidx}: "
                    f"parsed to {pos - fpos}, index says {ln}")
            parsed += 1
            ps.bytes_parsed += ln
        ps.tiles.append(tile)
    ps.n_packets += parsed
    ps.n_packets_skipped += idx.n_packets - parsed
