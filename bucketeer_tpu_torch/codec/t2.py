"""Tier-2 coding: tag trees, packet headers, packet assembly (T.800 Annex B).

Builds the packet stream that wraps Tier-1 code-block segments — the
precinct/progression/layer machinery configured by the reference's Kakadu
recipe (reference: converters/KakaduConverter.java:38-40: ``Corder=RPCL
Cprecincts={256,256},{256,256},{128,128} Cuse_sop=yes Cuse_eph=yes``).
Host-side by design: byte twiddling, not FLOPs (SURVEY.md §7 layer 1,
codec/t2).
"""
from __future__ import annotations

from dataclasses import dataclass, field

SOP = 0xFF91
EPH = 0xFF92


class BitWriter:
    """MSB-first bit packer with JPEG 2000 bit-stuffing: a byte of 0xFF is
    followed by a 7-bit byte (MSB forced 0) — B.10.1."""

    def __init__(self) -> None:
        self.bytes = bytearray()
        self._acc = 0
        self._nbits = 0

    def _cap(self) -> int:
        # 7 bits available if previous byte was 0xFF
        return 7 if (self.bytes and self.bytes[-1] == 0xFF) else 8

    def put_bit(self, b: int) -> None:
        self._acc = (self._acc << 1) | (b & 1)
        self._nbits += 1
        if self._nbits == self._cap():
            self.bytes.append(self._acc)
            self._acc = 0
            self._nbits = 0

    def put_bits(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.put_bit((value >> i) & 1)

    def flush(self) -> bytes:
        if self._nbits:
            self._acc <<= (self._cap() - self._nbits)
            self.bytes.append(self._acc)
            self._acc = 0
            self._nbits = 0
        if self.bytes and self.bytes[-1] == 0xFF:
            self.bytes.append(0x00)
        return bytes(self.bytes)


class BitReader:
    """MSB-first bit unpacker mirroring :class:`BitWriter`: after a 0xFF
    byte the next byte carries only 7 bits (B.10.1 bit-stuffing). Reads
    from a buffer at an absolute position; overruns raise the caller's
    ``overrun`` exception type so the decoder surfaces a typed error
    instead of IndexError."""

    def __init__(self, data: bytes, pos: int = 0,
                 end: int | None = None, overrun=ValueError) -> None:
        self.data = data
        self.pos = pos
        self.end = len(data) if end is None else end
        self._overrun = overrun
        self._acc = 0
        self._nbits = 0
        self._last = 0          # previously consumed byte (stuffing state)

    def bit(self) -> int:
        if self._nbits == 0:
            if self.pos >= self.end:
                raise self._overrun("bit stream truncated")
            byte = self.data[self.pos]
            self.pos += 1
            cap = 7 if self._last == 0xFF else 8
            if cap == 7 and byte & 0x80:
                raise self._overrun("invalid bit-stuffing after 0xFF")
            self._acc = byte
            self._nbits = cap
            self._last = byte
        self._nbits -= 1
        return (self._acc >> self._nbits) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self) -> None:
        """Byte-align after a packet header (inverse of BitWriter.flush:
        discard padding bits; a final 0xFF is followed by a stuffed
        byte that belongs to the header)."""
        self._acc = 0
        self._nbits = 0
        if self._last == 0xFF:
            if self.pos >= self.end:
                raise self._overrun("bit stream truncated at stuffing")
            self.pos += 1
        self._last = 0


class TagTree:
    """2-D tag tree (B.10.2): quad-tree of running minima, coded
    incrementally against rising thresholds across layers."""

    def __init__(self, w: int, h: int) -> None:
        self.w, self.h = w, h
        self.levels = []
        lw, lh = w, h
        while True:
            self.levels.append((lw, lh))
            if lw <= 1 and lh <= 1:  # also terminates for empty (0-size) grids
                break
            lw, lh = (lw + 1) // 2, (lh + 1) // 2
        self.value = [[0] * (lw_ * lh_) for lw_, lh_ in self.levels]
        self.low = [[0] * (lw_ * lh_) for lw_, lh_ in self.levels]
        self.known = [[False] * (lw_ * lh_) for lw_, lh_ in self.levels]

    def set_values(self, vals) -> None:
        """vals: row-major leaf values (len w*h). Internal = min of children."""
        assert len(vals) == self.w * self.h
        self.value[0] = list(vals)
        for lev in range(1, len(self.levels)):
            pw, ph = self.levels[lev - 1]
            lw, lh = self.levels[lev]
            up = self.value[lev - 1]
            cur = [0] * (lw * lh)
            for y in range(lh):
                for x in range(lw):
                    children = []
                    for dy in (0, 1):
                        for dx in (0, 1):
                            cy, cx = 2 * y + dy, 2 * x + dx
                            if cy < ph and cx < pw:
                                children.append(up[cy * pw + cx])
                    cur[y * lw + x] = min(children)
            self.value[lev] = cur

    def encode(self, bw: BitWriter, x: int, y: int, threshold: int) -> None:
        """Emit bits so the decoder learns whether leaf(x,y) < threshold."""
        # Path from root (last level) down to leaf (level 0).
        path = []
        for lev in range(len(self.levels)):
            lw, _ = self.levels[lev]
            path.append((lev, (y >> lev) * lw + (x >> lev)))
        low = 0
        for lev, idx in reversed(path):
            if low > self.low[lev][idx]:
                self.low[lev][idx] = low
            else:
                low = self.low[lev][idx]
            while low < threshold:
                if low >= self.value[lev][idx]:
                    if not self.known[lev][idx]:
                        bw.put_bit(1)
                        self.known[lev][idx] = True
                    break
                bw.put_bit(0)
                low += 1
            self.low[lev][idx] = low


    def decode(self, br: BitReader, x: int, y: int, threshold: int,
               cap: int = 1 << 20):
        """Decoder mirror of :meth:`encode`: consume bits until the
        decoder knows whether leaf(x, y) < threshold. Returns the leaf
        value if it is known and < threshold, else None (leaf >=
        threshold at this point in the stream). ``cap`` bounds the value
        a corrupt stream can grow to (each 0-bit costs one iteration)."""
        path = []
        for lev in range(len(self.levels)):
            lw, _ = self.levels[lev]
            path.append((lev, (y >> lev) * lw + (x >> lev)))
        low = 0
        for lev, idx in reversed(path):
            if low > self.low[lev][idx]:
                self.low[lev][idx] = low
            else:
                low = self.low[lev][idx]
            while low < threshold:
                if self.known[lev][idx]:
                    break
                if low >= cap:
                    raise br._overrun("tag-tree value overflow")
                if br.bit():
                    self.value[lev][idx] = low
                    self.known[lev][idx] = True
                else:
                    low += 1
            self.low[lev][idx] = low
        lev, idx = path[0]
        if self.known[lev][idx] and self.value[lev][idx] < threshold:
            return self.value[lev][idx]
        return None


def put_npasses(bw: BitWriter, n: int) -> None:
    """Number-of-coding-passes code (Table B.4)."""
    if n == 1:
        bw.put_bit(0)
    elif n == 2:
        bw.put_bits(0b10, 2)
    elif n <= 5:
        bw.put_bits(0b11, 2)
        bw.put_bits(n - 3, 2)
    elif n <= 36:
        bw.put_bits(0b1111, 4)
        bw.put_bits(n - 6, 5)
    else:
        bw.put_bits(0b111111111, 9)
        bw.put_bits(n - 37, 7)


def get_npasses(br: BitReader) -> int:
    """Inverse of :func:`put_npasses` (Table B.4)."""
    if not br.bit():
        return 1
    if not br.bit():
        return 2
    v = br.bits(2)
    if v < 3:
        return 3 + v
    w = br.bits(5)
    if w < 31:
        return 6 + w
    return 37 + br.bits(7)


@dataclass
class BlockLayer:
    """One code-block's contribution to one layer."""
    npasses: int
    data: bytes


@dataclass
class PrecinctBlock:
    """Tier-2 state for one code-block within a precinct."""
    missing_bitplanes: int
    layers: dict = field(default_factory=dict)  # layer -> BlockLayer
    included_in: int = -1   # first layer included (filled during encode)
    lblock: int = 3


@dataclass
class Precinct:
    """One precinct of one band: grid of code-blocks."""
    nblocks_w: int
    nblocks_h: int
    blocks: list = field(default_factory=list)  # row-major PrecinctBlock|None

    def __post_init__(self):
        if not self.blocks:
            self.blocks = [None] * (self.nblocks_w * self.nblocks_h)
        self.incl_tree = None
        self.zbp_tree = None

    def _init_trees(self, n_layers: int) -> None:
        self.incl_tree = TagTree(self.nblocks_w, self.nblocks_h)
        self.zbp_tree = TagTree(self.nblocks_w, self.nblocks_h)
        incl_vals, zbp_vals = [], []
        for blk in self.blocks:
            if blk is None or not blk.layers:
                incl_vals.append(n_layers)   # never included
                zbp_vals.append(0)
            else:
                incl_vals.append(min(blk.layers))
                zbp_vals.append(blk.missing_bitplanes)
        self.incl_tree.set_values(incl_vals)
        self.zbp_tree.set_values(zbp_vals)


def encode_packet(precincts, layer: int, n_layers: int,
                  sop_index: int | None = None,
                  use_eph: bool = False) -> bytes:
    """Encode one packet: the given layer for a list of band-precincts
    (the bands of one resolution at one precinct position), header +
    body. ``sop_index`` non-None prepends an SOP marker segment with that
    sequence number (reference recipe ``Cuse_sop=yes``); ``use_eph``
    appends the EPH marker after the packet header (``Cuse_eph=yes``) —
    KakaduConverter.java:40."""
    bw = BitWriter()
    body = bytearray()
    any_data = any(
        blk is not None and layer in blk.layers
        for prec in precincts for blk in prec.blocks
    )
    bw.put_bit(1 if any_data else 0)
    if any_data:
        for prec in precincts:
            if prec.incl_tree is None:
                prec._init_trees(n_layers)
            for i, blk in enumerate(prec.blocks):
                if blk is None:
                    continue
                x, y = i % prec.nblocks_w, i // prec.nblocks_w
                contrib = layer in blk.layers
                if blk.included_in < 0:
                    prec.incl_tree.encode(bw, x, y, layer + 1)
                    if contrib:
                        blk.included_in = layer
                        # Zero-bitplane count, coded to full precision
                        # (threshold = infinity emits zeros up to the value
                        # plus the terminating one).
                        prec.zbp_tree.encode(bw, x, y, 1 << 30)
                else:
                    bw.put_bit(1 if contrib else 0)
                if not contrib:
                    continue
                bl = blk.layers[layer]
                put_npasses(bw, bl.npasses)
                # Length signaling (B.10.7), single codeword segment.
                nbits_len = blk.lblock + _floor_log2(bl.npasses)
                length = len(bl.data)
                while length >= (1 << nbits_len):
                    bw.put_bit(1)
                    blk.lblock += 1
                    nbits_len += 1
                bw.put_bit(0)
                bw.put_bits(length, nbits_len)
                body += bl.data
    header = bw.flush()
    out = bytearray()
    if sop_index is not None:
        out += SOP.to_bytes(2, "big") + (4).to_bytes(2, "big")
        out += (sop_index & 0xFFFF).to_bytes(2, "big")
    out += header
    if use_eph:
        out += EPH.to_bytes(2, "big")
    out += body
    return bytes(out)


def _floor_log2(n: int) -> int:
    return n.bit_length() - 1
