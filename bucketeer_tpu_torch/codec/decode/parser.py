"""Tier-2 decode: JP2 boxes, codestream markers, packet headers
(T.800 Annexes A, B, I) — the parse-side mirror of ``codestream.py`` /
``t2.py`` / ``encoder._build_precincts``.

Host-side by design, like the encode Tier-2: byte twiddling, not FLOPs.
The parser walks packets in the exact progression order the encoder's
``_packet_sequence`` emits them, reconstructing per-code-block segment
lists (layer, passes, bytes) that the Tier-1 decoder consumes.

Partial decode is native here, not a post-filter:

- ``reduce=r`` keeps resolutions ``0..levels-r``. Packet *headers* of
  higher resolutions still parse (they gate the byte positions of later
  packets), but their bodies are skipped without storing — and for
  resolution-major progressions (RPCL/RLCP, the reference recipe's
  ``Corder=RPCL``) the walk stops at the first too-fine packet, so a
  thumbnail read never touches the bulk of the file.
- ``layers=l`` stores only contributions from quality layers ``< l``
  (LRCP stops parsing outright once the layer index passes the cap).

Every malformed-input path raises :class:`DecodeError` — bounds are
checked before every read, tag-tree growth is capped, and geometry that
disagrees with the local Mallat layout is rejected rather than sliced
wrong.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

from .. import codestream as cs
from ..encoder import _band_rect, _ceil_div, _packet_sequence
from ..pipeline import _band_geometry
from ..quant import _LOG2_GAIN, SubbandQuant
from ..t2 import BitReader, TagTree, _floor_log2, get_npasses
from .errors import DecodeError, InvalidParam

# Allocation guards: a bit-flip in SIZ must not turn into a 100 GB
# band-array allocation. Caps are generous for real scans, fatal for
# fuzzed garbage.
MAX_PIXELS = int(os.environ.get("BUCKETEER_MAX_DECODE_PIXELS",
                                str(1 << 31)))
MAX_TILES = 65535          # Isot is 16-bit anyway
MAX_LAYERS = 65535
_ZBP_CAP = 80              # tag-tree growth bound (Mb can never exceed 32)

_JP2_SIG = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"


class _Reader:
    """Bounds-checked big-endian byte reader over the codestream."""

    def __init__(self, data: bytes, pos: int = 0) -> None:
        self.data = data
        self.pos = pos

    def need(self, n: int) -> None:
        if self.pos + n > len(self.data):
            raise DecodeError(
                f"truncated stream: need {n} bytes at offset {self.pos}")

    def u8(self) -> int:
        self.need(1)
        v = self.data[self.pos]
        self.pos += 1
        return v

    def u16(self) -> int:
        self.need(2)
        v = struct.unpack_from(">H", self.data, self.pos)[0]
        self.pos += 2
        return v

    def u32(self) -> int:
        self.need(4)
        v = struct.unpack_from(">I", self.data, self.pos)[0]
        self.pos += 4
        return v

    def raw(self, n: int) -> bytes:
        self.need(n)
        v = self.data[self.pos:self.pos + n]
        self.pos += n
        return v


def unbox_jp2(data: bytes) -> bytes:
    """Extract the contiguous codestream from a JP2/JPX file (the first
    ``jp2c`` box), or pass a raw codestream through."""
    if data[:2] == b"\xff\x4f":
        return data
    if not data.startswith(_JP2_SIG):
        raise DecodeError("neither a JP2/JPX signature nor a raw "
                          "JPEG 2000 codestream")
    r = _Reader(data, len(_JP2_SIG))
    while r.pos < len(data):
        start = r.pos
        length = r.u32()
        btype = r.raw(4)
        if length == 1:                       # extended 64-bit length
            r.need(8)
            length = struct.unpack_from(">Q", data, r.pos)[0]
            r.pos += 8
        header = r.pos - start
        if length == 0:                       # box runs to EOF
            end = len(data)
        else:
            if length < header:
                raise DecodeError(f"invalid box length {length}")
            end = start + length
            if end > len(data):
                raise DecodeError("truncated JP2 box")
        if btype == b"jp2c":
            return data[r.pos:end]
        r.pos = end
    raise DecodeError("no jp2c codestream box in JP2 file")


@dataclass
class DecBlock:
    """Decode-side Tier-2 state + collected segments for one code-block."""
    cy: int                  # global code-block grid cell
    cx: int
    included: bool = False
    nbps: int = 0            # Mb - zero bitplanes, set at first inclusion
    lblock: int = 3
    contribs: list = field(default_factory=list)  # [(layer, npasses, bytes)]

    @property
    def npasses(self) -> int:
        return sum(n for _, n, _ in self.contribs)

    @property
    def data(self) -> bytes:
        return b"".join(d for _, _, d in self.contribs)


@dataclass
class DecBand:
    """One subband of one tile-component, global band coordinates."""
    name: str
    res: int
    comp: int
    q: SubbandQuant
    bx0: int
    bx1: int
    by0: int
    by1: int
    blocks: dict = field(default_factory=dict)   # (cy, cx) -> DecBlock


@dataclass
class _DecPrecinct:
    nbw: int
    nbh: int
    band: DecBand
    blocks: list                 # [DecBlock] row-major, precinct-local
    incl: TagTree = None
    zbp: TagTree = None

    def __post_init__(self):
        self.incl = TagTree(self.nbw, self.nbh)
        self.zbp = TagTree(self.nbw, self.nbh)


@dataclass
class _DecRec:
    """Packet-ordering record, attribute-compatible with the encoder's
    ``_PrecinctRec`` so ``_packet_sequence`` orders both identically."""
    comp: int
    res: int
    p_idx: int
    ref_y: int
    ref_x: int
    band_precincts: list


@dataclass
class DecTile:
    idx: int
    origin: tuple            # (y0, x0)
    th: int
    tw: int
    comp_res: list           # [comp][res] -> [DecBand]


@dataclass
class ParsedStream:
    width: int
    height: int
    n_comps: int
    bitdepth: int
    tile_w: int
    tile_h: int
    levels: int
    n_layers: int
    progression: int
    used_mct: bool
    reversible: bool
    guard_bits: int
    xcb: int                 # code-block width exponent
    ycb: int
    quants: dict             # (res, name) -> SubbandQuant
    tiles: list              # [DecTile]
    use_sop: bool = False
    use_eph: bool = False
    n_packets: int = 0       # packets whose headers were parsed
    n_packets_skipped: int = 0   # skipped wholesale by partial decode
    bytes_total: int = 0     # codestream bytes
    bytes_parsed: int = 0    # tile bytes the packet walk actually visited
    precinct_exps: list | None = None    # signaled (or default) PPx/PPy
    # Filled by parse(collect_index=True) — the raw material of the
    # random-access stream index (decode/index.py):
    packet_index: dict | None = None  # tidx -> [(comp,res,p_idx,layer,off,len)]
    tile_spans: dict | None = None    # tidx -> [(start, end)] codestream spans


def _parse_siz(payload: bytes) -> tuple:
    if len(payload) < 36:
        raise DecodeError("SIZ too short")
    (_, xsiz, ysiz, xo, yo, xt, yt, xto, yto,
     n_comps) = struct.unpack_from(">HIIIIIIIIH", payload, 0)
    if xo or yo or xto or yto:
        raise DecodeError("nonzero image/tile offsets unsupported")
    if not (0 < xsiz and 0 < ysiz):
        raise DecodeError("empty image")
    if xsiz * ysiz > MAX_PIXELS:
        raise DecodeError(f"image {xsiz}x{ysiz} exceeds decode pixel cap")
    if n_comps not in (1, 3):
        raise DecodeError(f"{n_comps} components unsupported")
    if len(payload) < 36 + 3 * n_comps:
        raise DecodeError("SIZ component list truncated")
    depths = set()
    for c in range(n_comps):
        ssiz, xr, yr = payload[36 + 3 * c:39 + 3 * c]
        if ssiz & 0x80:
            raise DecodeError("signed components unsupported")
        if (xr, yr) != (1, 1):
            raise DecodeError("component subsampling unsupported")
        depths.add((ssiz & 0x7F) + 1)
    if len(depths) != 1:
        raise DecodeError("per-component bit depths unsupported")
    bitdepth = depths.pop()
    if not 1 <= bitdepth <= 16:
        raise DecodeError(f"bit depth {bitdepth} unsupported")
    if not (0 < xt and 0 < yt):
        raise DecodeError("zero tile size")
    n_tiles = _ceil_div(xsiz, xt) * _ceil_div(ysiz, yt)
    if n_tiles > MAX_TILES:
        raise DecodeError(f"{n_tiles} tiles exceeds tile cap")
    return xsiz, ysiz, n_comps, bitdepth, xt, yt


def _parse_cod(payload: bytes) -> dict:
    if len(payload) < 10:
        raise DecodeError("COD too short")
    scod = payload[0]
    prog, n_layers, mct = struct.unpack_from(">BHB", payload, 1)
    levels, cbw, cbh, style, transform = payload[5:10]
    if prog > 4:
        raise DecodeError(f"unknown progression {prog}")
    if not 1 <= n_layers <= MAX_LAYERS:
        raise DecodeError(f"invalid layer count {n_layers}")
    if levels > 32:
        raise DecodeError(f"invalid decomposition levels {levels}")
    if style != 0:
        raise DecodeError("code-block style (bypass/termall/...) "
                          "unsupported")
    if transform > 1:
        raise DecodeError(f"unknown wavelet transform {transform}")
    xcb, ycb = cbw + 2, cbh + 2
    if not (2 <= xcb <= 10 and 2 <= ycb <= 10 and xcb + ycb <= 12):
        raise DecodeError(f"invalid code-block size 2^{xcb}x2^{ycb}")
    out = {"progression": prog, "n_layers": n_layers, "mct": bool(mct),
           "levels": levels, "xcb": xcb, "ycb": ycb,
           "reversible": transform == 1,
           "use_sop": bool(scod & 2), "use_eph": bool(scod & 4),
           "precinct_exps": None}
    if scod & 1:
        if len(payload) < 10 + levels + 1:
            raise DecodeError("COD precinct list truncated")
        exps = []
        for r in range(levels + 1):
            b = payload[10 + r]
            exps.append((b & 0xF, b >> 4))
        out["precinct_exps"] = exps
    return out


def _parse_qcd(payload: bytes, levels: int, bitdepth: int) -> tuple:
    if not payload:
        raise DecodeError("QCD empty")
    sqcd = payload[0]
    style = sqcd & 0x1F
    guard = sqcd >> 5
    names = [(0, "LL")] + [(r, n) for r in range(1, levels + 1)
                           for n in ("HL", "LH", "HH")]
    quants = {}
    if style == 0:
        if len(payload) - 1 < len(names):
            raise DecodeError("QCD exponent list truncated")
        for i, (res, name) in enumerate(names):
            eps = payload[1 + i] >> 3
            quants[(res, name)] = SubbandQuant(eps, 0, 1.0,
                                               guard + eps - 1)
    elif style == 2:
        if len(payload) - 1 < 2 * len(names):
            raise DecodeError("QCD step list truncated")
        for i, (res, name) in enumerate(names):
            v = struct.unpack_from(">H", payload, 1 + 2 * i)[0]
            eps, mu = v >> 11, v & 0x7FF
            rb = bitdepth + _LOG2_GAIN[name]
            delta = (2.0 ** (rb - eps)) * (1.0 + mu / 2048.0)
            quants[(res, name)] = SubbandQuant(eps, mu, delta,
                                               guard + eps - 1)
    else:
        raise DecodeError(f"quantization style {style} unsupported")
    for q in quants.values():
        if q.n_bitplanes <= 0 or q.n_bitplanes > 32:
            raise DecodeError(
                f"implausible bit-plane count Mb={q.n_bitplanes}")
    return guard, quants


def _build_tile(ps: ParsedStream, tidx: int) -> DecTile:
    """Band geometry for one tile, mirroring ``encoder._tile_bands`` but
    with DecodeError instead of assert for foreign geometry."""
    n_tx = _ceil_div(ps.width, ps.tile_w)
    ty, tx = divmod(tidx, n_tx)
    y0, x0 = ty * ps.tile_h, tx * ps.tile_w
    th = min(ps.tile_h, ps.height - y0)
    tw = min(ps.tile_w, ps.width - x0)
    geo = _band_geometry(th, tw, ps.levels)
    comp_res = []
    for c in range(ps.n_comps):
        resolutions = [[] for _ in range(ps.levels + 1)]
        for name, lvl, _, _, bh, bw in geo:
            res = 0 if name == "LL" else ps.levels - lvl + 1
            bx0, bx1, by0, by1 = _band_rect(x0, x0 + tw, y0, y0 + th,
                                            res, name, ps.levels)
            if (by1 - by0, bx1 - bx0) != (bh, bw):
                raise DecodeError(
                    f"tile {tidx} band {name}@r{res}: global rect "
                    f"{(by1 - by0, bx1 - bx0)} disagrees with local "
                    f"Mallat geometry {(bh, bw)}")
            band = DecBand(name, res, c, ps.quants[(res, name)],
                           bx0, bx1, by0, by1)
            resolutions[res].append(band)
        order = {"LL": 0, "HL": 1, "LH": 2, "HH": 3}
        for bands in resolutions:
            bands.sort(key=lambda b: order[b.name])
        comp_res.append(resolutions)
    return DecTile(tidx, (y0, x0), th, tw, comp_res)


def _cell_range(band: DecBand, xcb: int, ycb: int) -> tuple:
    if band.bx1 <= band.bx0 or band.by1 <= band.by0:
        return 0, 0, 0, 0
    return (band.bx0 >> xcb, ((band.bx1 - 1) >> xcb) + 1,
            band.by0 >> ycb, ((band.by1 - 1) >> ycb) + 1)


def _build_precincts(ps: ParsedStream, tile: DecTile, exps: list) -> list:
    """Decode-side mirror of ``encoder._build_precincts``: same precinct
    partition, same record ordering inputs, fresh decoder tag trees."""
    y0, x0 = tile.origin
    tcx1, tcy1 = x0 + tile.tw, y0 + tile.th
    records = []
    for c, resolutions in enumerate(tile.comp_res):
        for r, bands in enumerate(resolutions):
            e = ps.levels - r
            trx0, trx1 = _ceil_div(x0, 1 << e), _ceil_div(tcx1, 1 << e)
            try0, try1 = _ceil_div(y0, 1 << e), _ceil_div(tcy1, 1 << e)
            if trx1 <= trx0 or try1 <= try0:
                continue
            ppx, ppy = exps[r]
            shift = 0 if r == 0 else 1
            if ppx - shift < ps.xcb or ppy - shift < ps.ycb:
                raise DecodeError(
                    "precincts smaller than the code-block unsupported")
            px_lo, px_hi = trx0 >> ppx, ((trx1 - 1) >> ppx) + 1
            py_lo, py_hi = try0 >> ppy, ((try1 - 1) >> ppy) + 1
            p_idx = 0
            for py in range(py_lo, py_hi):
                for px in range(px_lo, px_hi):
                    bps = []
                    for band in bands:
                        pbx0 = (px << ppx) >> shift
                        pbx1 = ((px + 1) << ppx) >> shift
                        pby0 = (py << ppy) >> shift
                        pby1 = ((py + 1) << ppy) >> shift
                        cx0, cx1, cy0, cy1 = _cell_range(band, ps.xcb,
                                                         ps.ycb)
                        kx0 = max(cx0, pbx0 >> ps.xcb)
                        kx1 = min(cx1, _ceil_div(pbx1, 1 << ps.xcb))
                        ky0 = max(cy0, pby0 >> ps.ycb)
                        ky1 = min(cy1, _ceil_div(pby1, 1 << ps.ycb))
                        nbw, nbh = max(0, kx1 - kx0), max(0, ky1 - ky0)
                        blocks = []
                        for cy in range(ky0, ky1):
                            for cx in range(kx0, kx1):
                                blk = DecBlock(cy, cx)
                                band.blocks[(cy, cx)] = blk
                                blocks.append(blk)
                        bps.append(_DecPrecinct(nbw, nbh, band, blocks))
                    ref_y = max(try0, py << ppy) << e
                    ref_x = max(trx0, px << ppx) << e
                    records.append(_DecRec(c, r, p_idx, ref_y, ref_x,
                                           bps))
                    p_idx += 1
    return records


def _default_exps(levels: int) -> list:
    return [(15, 15)] * (levels + 1)


def _parse_packet(ps: ParsedStream, buf: bytes, pos: int, end: int,
                  rec: _DecRec, layer: int, store: bool) -> int:
    """Parse one packet (header + body) at ``pos``; returns the position
    after the packet. ``store=False`` advances without keeping the body
    (partial decode of skipped resolutions/layers)."""
    if ps.use_sop and buf[pos:pos + 2] == b"\xff\x91":
        if pos + 6 > end:
            raise DecodeError("truncated SOP marker")
        pos += 6
    br = BitReader(buf, pos, end, DecodeError)
    pending = []
    if br.bit():
        for prec in rec.band_precincts:
            for i, blk in enumerate(prec.blocks):
                x, y = i % prec.nbw, i // prec.nbw
                if not blk.included:
                    v = prec.incl.decode(br, x, y, layer + 1,
                                         cap=ps.n_layers + 1)
                    contrib = v is not None
                    if contrib:
                        blk.included = True
                        zbp = prec.zbp.decode(br, x, y, 1 << 30,
                                              cap=_ZBP_CAP)
                        nbps = prec.band.q.n_bitplanes - zbp
                        if nbps < 0:
                            raise DecodeError(
                                f"zero-bitplane count {zbp} exceeds "
                                f"Mb {prec.band.q.n_bitplanes}")
                        blk.nbps = nbps
                else:
                    contrib = bool(br.bit())
                if not contrib:
                    continue
                npasses = get_npasses(br)
                nbits = blk.lblock + _floor_log2(npasses)
                while br.bit():
                    blk.lblock += 1
                    nbits += 1
                    if nbits > 32:
                        raise DecodeError("packet length signal overflow")
                length = br.bits(nbits)
                pending.append((blk, npasses, length))
    br.align()
    pos = br.pos
    if ps.use_eph:
        if buf[pos:pos + 2] != b"\xff\x92":
            raise DecodeError("missing EPH marker after packet header")
        pos += 2
    for blk, npasses, length in pending:
        if pos + length > end:
            raise DecodeError("packet body overruns tile-part")
        if store:
            blk.contribs.append((layer, npasses, buf[pos:pos + length]))
        pos += length
    return pos


def _parse_main_header(r: _Reader) -> tuple:
    """Consume SIZ/COD/QCD (skipping COM etc.) up to the first SOT.
    Returns (siz tuple, cod dict, guard_bits, quants)."""
    siz = cod = None
    guard = quants = None
    while True:
        marker = r.u16()
        if marker == cs.SOT:
            break
        if marker == cs.EOC:
            raise DecodeError("no tile-parts before EOC")
        if not 0xFF01 <= marker <= 0xFFFE:
            raise DecodeError(f"bad marker 0x{marker:04x} in main header")
        length = r.u16()
        if length < 2:
            raise DecodeError(f"bad segment length {length}")
        payload = r.raw(length - 2)
        if marker == cs.SIZ:
            siz = _parse_siz(payload)
        elif marker == cs.COD:
            cod = _parse_cod(payload)
        elif marker == cs.QCD:
            if siz is None:
                raise DecodeError("QCD before SIZ")
            if cod is None:
                raise DecodeError("QCD before COD")
            guard, quants = _parse_qcd(payload, cod["levels"], siz[3])
        elif marker in (cs.COC, cs.QCC):
            raise DecodeError("per-component COC/QCC overrides "
                              "unsupported")
        # COM / PLT / anything else with a length: skipped.
    if siz is None or cod is None or quants is None:
        raise DecodeError("main header missing SIZ, COD or QCD")
    return siz, cod, guard, quants


def probe(data: bytes) -> dict:
    """Cheap stream metadata: parse only the main header (no tile data
    is touched). Servers use this to pick response encodings (bit
    depth) and validate partial-decode parameters without decoding."""
    code = unbox_jp2(data)
    r = _Reader(code)
    if r.u16() != cs.SOC:
        raise DecodeError("missing SOC marker")
    siz, cod, _, _ = _parse_main_header(r)
    width, height, n_comps, bitdepth, tile_w, tile_h = siz
    return {"width": width, "height": height, "n_comps": n_comps,
            "bitdepth": bitdepth, "tile_w": tile_w, "tile_h": tile_h,
            "levels": cod["levels"], "n_layers": cod["n_layers"],
            "reversible": cod["reversible"],
            "progression": cod["progression"]}


def _iter_tile_parts(r: _Reader, code: bytes, n_tiles: int,
                     on_segment=None):
    """Walk the codestream's tile-parts from the first SOT (already
    consumed by the main-header parse) to EOC, validating SOT fields
    and the header segments up to SOD; yields ``(isot, body_start,
    part_end)`` per tile-part. ``on_segment(isot, marker, payload)``
    sees every header segment (the PLT index build); None skips them.
    The single walker keeps the sequential parse and the stream-index
    build accepting and rejecting exactly the same streams."""
    marker = cs.SOT
    while True:
        if marker == cs.EOC:
            return
        if marker != cs.SOT:
            raise DecodeError(f"expected SOT, got 0x{marker:04x}")
        sot_start = r.pos - 2
        if r.u16() != 10:
            raise DecodeError("bad SOT length")
        isot = r.u16()
        psot = r.u32()
        r.u8()            # TPsot
        r.u8()            # TNsot
        if isot >= n_tiles:
            raise DecodeError(f"tile index {isot} out of range")
        if psot == 0:
            raise DecodeError("Psot=0 (open-ended tile-part) unsupported")
        part_end = sot_start + psot
        if psot < 14 or part_end > len(code):
            raise DecodeError(f"tile-part length {psot} overruns stream")
        # Tile-part header segments until SOD.
        while True:
            m = r.u16()
            if m == cs.SOD:
                break
            if m in (cs.COD, cs.QCD, cs.COC, cs.QCC):
                raise DecodeError("tile-level coding-style overrides "
                                  "unsupported")
            if not 0xFF01 <= m <= 0xFFFE:
                raise DecodeError(
                    f"bad marker 0x{m:04x} in tile-part header")
            ln = r.u16()
            if ln < 2 or r.pos + ln - 2 > part_end:
                raise DecodeError("tile-part header segment overruns")
            payload = r.raw(ln - 2)       # PLT / COM
            if on_segment is not None:
                on_segment(isot, m, payload)
        yield isot, r.pos, part_end
        r.pos = part_end
        marker = r.u16()


def parse(data: bytes, reduce: int = 0, layers: int | None = None,
          collect_index: bool = False) -> ParsedStream:
    """Parse a JP2 file or raw codestream into per-block segment lists.

    ``reduce`` drops the finest ``reduce`` resolutions; ``layers`` caps
    the quality layers whose bodies are kept. Raises DecodeError on any
    malformed or unsupported input.

    ``collect_index=True`` additionally records per-packet (offset,
    length) pairs and per-tile byte spans on the returned stream
    (``packet_index`` / ``tile_spans``) — the tag-tree-walk path of
    :func:`index.build_index`. Requires a full parse (an early-stopped
    partial walk would index only a prefix).
    """
    if reduce < 0:
        raise InvalidParam(f"invalid reduce {reduce}")
    if layers is not None and layers < 1:
        raise InvalidParam(f"invalid layers {layers}")
    if collect_index and (reduce or layers is not None):
        raise ValueError("collect_index needs a full parse "
                         "(reduce=0, layers=None)")
    code = unbox_jp2(data)
    r = _Reader(code)
    if r.u16() != cs.SOC:
        raise DecodeError("missing SOC marker")
    siz, cod, guard, quants = _parse_main_header(r)

    width, height, n_comps, bitdepth, tile_w, tile_h = siz
    if reduce > cod["levels"]:
        raise InvalidParam(
            f"reduce={reduce} exceeds {cod['levels']} decomposition "
            "levels")
    max_layers = cod["n_layers"] if layers is None else layers
    ps = ParsedStream(width, height, n_comps, bitdepth, tile_w, tile_h,
                      cod["levels"], cod["n_layers"], cod["progression"],
                      cod["mct"], cod["reversible"], guard,
                      cod["xcb"], cod["ycb"], quants, [],
                      use_sop=cod["use_sop"], use_eph=cod["use_eph"],
                      bytes_total=len(code))

    # --- tile-parts: collect each tile's packet bytes in stream order ---
    n_tiles = _ceil_div(width, tile_w) * _ceil_div(height, tile_h)
    tile_bytes: dict = {}
    tile_spans: dict = {}
    for isot, body_start, part_end in _iter_tile_parts(r, code, n_tiles):
        tile_bytes.setdefault(isot, bytearray()).extend(
            code[body_start:part_end])
        tile_spans.setdefault(isot, []).append((body_start, part_end))

    if len(tile_bytes) != n_tiles:
        raise DecodeError(
            f"{n_tiles - len(tile_bytes)} of {n_tiles} tiles have no "
            "tile-part")

    # --- packet walk per tile ---
    max_res = ps.levels - reduce
    exps = cod["precinct_exps"] or _default_exps(ps.levels)
    ps.precinct_exps = exps
    res_major = ps.progression in (cs.PROG_RPCL, cs.PROG_RLCP)
    if collect_index:
        ps.packet_index = {}
        ps.tile_spans = tile_spans
    for tidx in sorted(tile_bytes):
        tile = _build_tile(ps, tidx)
        records = _build_precincts(ps, tile, exps)
        buf = bytes(tile_bytes[tidx])
        pos, end = 0, len(buf)
        seq = _packet_sequence(ps.progression, records, ps.levels + 1,
                               n_comps, ps.n_layers)
        entries = [] if collect_index else None
        for rec, layer in seq:
            if res_major and rec.res > max_res:
                # Everything after this packet in a resolution-major
                # stream is finer detail: skip the tile's tail outright.
                ps.n_packets_skipped += sum(
                    1 for _ in seq) + 1
                break
            if (ps.progression == cs.PROG_LRCP
                    and layer >= max_layers):
                ps.n_packets_skipped += sum(1 for _ in seq) + 1
                break
            store = rec.res <= max_res and layer < max_layers
            start = pos
            pos = _parse_packet(ps, buf, pos, end, rec, layer, store)
            if entries is not None:
                entries.append((rec.comp, rec.res, rec.p_idx, layer,
                                start, pos - start))
            ps.n_packets += 1
        if entries is not None:
            ps.packet_index[tidx] = entries
        ps.bytes_parsed += pos
        ps.tiles.append(tile)
    return ps
