"""A plain JPEG 2000 Part 1 reader for judging the files the service
writes (T.800 Annexes A-D): JP2 boxes, the main header, tile-parts,
packet headers and the Tier-1 decode of single code-blocks.

It reads only what a check needs: the code-blocks drawn for it, with
every packet header of their tiles parsed on the way (RPCL, the
recipe's progression). Each decoded sample comes back as the interval
its decoded bits allow, so a truncated (lossy) block can be judged as
exactly as a whole (lossless) one. It is a trimmed copy of the pure
Python decoder of the JAX package (``bucketeer_tpu/codec/decode``),
which is held to OpenJPEG there; it imports nothing of either package.
"""
from __future__ import annotations

import struct

import numpy as np

SOC, SIZ, COD, QCD, SOT, SOD, EOC = (0xFF4F, 0xFF51, 0xFF52, 0xFF5C,
                                     0xFF90, 0xFF93, 0xFFD9)
PROG_RPCL = 2
LOG2_GAIN = {"LL": 0, "HL": 1, "LH": 1, "HH": 2}


class J2kError(ValueError):
    """The file is not a stream this reader (and the recipe) accepts."""


# --- MQ decoder (T.800 C.3) ---------------------------------------------

QE = (
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0),
)
CTX_RL, CTX_UNIFORM = 17, 18


class MQDecoder:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.bp = 0
        self.idx = [0] * 19
        self.idx[0], self.idx[CTX_RL], self.idx[CTX_UNIFORM] = 4, 3, 46
        self.mps = [0] * 19
        self.c = self._byte(0) << 16
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def _byte(self, i: int) -> int:
        return self.data[i] if i < len(self.data) else 0xFF

    def _bytein(self) -> None:
        if self._byte(self.bp) == 0xFF:
            if self._byte(self.bp + 1) > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp += 1
                self.c += self._byte(self.bp) << 9
                self.ct = 7
        else:
            self.bp += 1
            self.c += self._byte(self.bp) << 8
            self.ct = 8

    def decode(self, ctx: int) -> int:
        qe, nmps, nlps, switch = QE[self.idx[ctx]]
        self.a -= qe
        if ((self.c >> 16) & 0xFFFF) < qe:
            if self.a < qe:
                d = self.mps[ctx]
                self.idx[ctx] = nmps
            else:
                d = 1 - self.mps[ctx]
                if switch:
                    self.mps[ctx] ^= 1
                self.idx[ctx] = nlps
            self.a = qe
            self._renorm()
            return d
        self.c -= qe << 16
        if self.a & 0x8000:
            return self.mps[ctx]
        if self.a < qe:
            d = 1 - self.mps[ctx]
            if switch:
                self.mps[ctx] ^= 1
            self.idx[ctx] = nlps
        else:
            d = self.mps[ctx]
            self.idx[ctx] = nmps
        self._renorm()
        return d

    def _renorm(self) -> None:
        while True:
            if self.ct == 0:
                self._bytein()
            self.a = (self.a << 1) & 0xFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.a & 0x8000:
                return


# --- Tier-1 contexts (T.800 Tables D.1-D.3) ------------------------------

def _zc_table(band: str) -> list:
    """Flat [h * 15 + v * 5 + d] -> zero-coding context."""
    out = [0] * 45
    for h in range(3):
        for v in range(3):
            for d in range(5):
                hh, vv = (v, h) if band == "HL" else (h, v)
                if band == "HH":
                    hv = hh + vv
                    if d >= 3:
                        c = 8
                    elif d == 2:
                        c = 7 if hv >= 1 else 6
                    elif d == 1:
                        c = 5 if hv >= 2 else (4 if hv == 1 else 3)
                    else:
                        c = 2 if hv >= 2 else (1 if hv == 1 else 0)
                elif hh == 2:
                    c = 8
                elif hh == 1:
                    c = 7 if vv >= 1 else (6 if d >= 1 else 5)
                elif vv == 2:
                    c = 4
                elif vv == 1:
                    c = 3
                else:
                    c = 2 if d >= 2 else (1 if d == 1 else 0)
                out[h * 15 + v * 5 + d] = c
    return out


ZC = {b: _zc_table(b) for b in ("LL", "HL", "LH", "HH")}


def _sc(h: int, v: int) -> tuple:
    if h == 1:
        return (13, 0) if v == 1 else ((12, 0) if v == 0 else (11, 0))
    if h == 0:
        return (10, 0) if v == 1 else ((9, 0) if v == 0 else (10, 1))
    return (11, 1) if v == 1 else ((12, 1) if v == 0 else (13, 1))


SC = [_sc(h, v) for h in (-1, 0, 1) for v in (-1, 0, 1)]


def decode_block(data: bytes, nbps: int, npasses: int, band: str,
                 h: int, w: int) -> tuple:
    """Decode one code-block's passes.

    Returns ``(lo, plane, neg)``, each (h, w): the decoded magnitude
    bits ``lo`` (|q| >= lo), the lowest bit-plane ``plane`` the decode
    reached for the sample (|q| < lo + 2**plane), and its sign. A
    sample no pass reached keeps ``plane = nbps``.
    """
    size = h * w
    lo = [0] * size
    low = [max(nbps, 0)] * size
    neg = [0] * size
    if nbps > 0 and npasses > 0:
        if nbps > 31 or npasses > 3 * nbps - 2:
            raise J2kError(f"{npasses} passes for {nbps} bit-planes")
        _passes(MQDecoder(bytes(data)), ZC[band], nbps, npasses, h, w,
                lo, low, neg)
    shape = (h, w)
    return (np.array(lo, np.int64).reshape(shape),
            np.array(low, np.int64).reshape(shape),
            np.array(neg, bool).reshape(shape))


def _passes(mq, zc, nbps, npasses, h, w, lo, low, neg) -> None:
    decode = mq.decode
    size = h * w
    sig = [0] * size
    visited = [0] * size
    refined = [0] * size
    nh = [0] * size
    nv = [0] * size
    nd = [0] * size

    def set_sig(i, y, x):
        sig[i] = 1
        if x > 0:
            nh[i - 1] += 1
            if y > 0:
                nd[i - 1 - w] += 1
            if y < h - 1:
                nd[i - 1 + w] += 1
        if x < w - 1:
            nh[i + 1] += 1
            if y > 0:
                nd[i + 1 - w] += 1
            if y < h - 1:
                nd[i + 1 + w] += 1
        if y > 0:
            nv[i - w] += 1
        if y < h - 1:
            nv[i + w] += 1

    def sign(i, y, x):
        hc = vc = 0
        if x > 0 and sig[i - 1]:
            hc += -1 if neg[i - 1] else 1
        if x < w - 1 and sig[i + 1]:
            hc += -1 if neg[i + 1] else 1
        if y > 0 and sig[i - w]:
            vc += -1 if neg[i - w] else 1
        if y < h - 1 and sig[i + w]:
            vc += -1 if neg[i + w] else 1
        hc = max(-1, min(1, hc))
        vc = max(-1, min(1, vc))
        ctx, xor = SC[(hc + 1) * 3 + vc + 1]
        return decode(ctx) ^ xor

    left = npasses
    for p in range(nbps - 1, -1, -1):
        bit = 1 << p
        if p != nbps - 1:
            for y0 in range(0, h, 4):                 # significance
                for x in range(w):
                    i = y0 * w + x
                    for y in range(y0, min(y0 + 4, h)):
                        if not sig[i] and (nh[i] or nv[i] or nd[i]):
                            visited[i] = 1
                            low[i] = p
                            if decode(zc[nh[i] * 15 + nv[i] * 5 + nd[i]]):
                                neg[i] = sign(i, y, x)
                                set_sig(i, y, x)
                                lo[i] = bit
                        i += w
            left -= 1
            if not left:
                return
            for y0 in range(0, h, 4):                 # refinement
                for x in range(w):
                    i = y0 * w + x
                    for y in range(y0, min(y0 + 4, h)):
                        if sig[i] and not visited[i]:
                            ctx = (16 if refined[i] else
                                   15 if (nh[i] or nv[i] or nd[i]) else 14)
                            if decode(ctx):
                                lo[i] += bit
                            low[i] = p
                            refined[i] = 1
                        i += w
            left -= 1
            if not left:
                return
        for y0 in range(0, h, 4):                     # cleanup
            for x in range(w):
                i0 = y0 * w + x
                y = y0
                if y0 + 3 < h and not any(
                        sig[j] or visited[j] or nh[j] or nv[j] or nd[j]
                        for j in range(i0, i0 + 4 * w, w)):
                    if not decode(CTX_RL):
                        for j in range(i0, i0 + 4 * w, w):
                            low[j] = p
                        continue
                    k = (decode(CTX_UNIFORM) << 1) | decode(CTX_UNIFORM)
                    for j in range(i0, i0 + k * w, w):
                        low[j] = p
                    ik = i0 + k * w
                    neg[ik] = sign(ik, y0 + k, x)
                    set_sig(ik, y0 + k, x)
                    lo[ik] = bit
                    low[ik] = p
                    y = y0 + k + 1
                i = i0 + (y - y0) * w
                for yy in range(y, min(y0 + 4, h)):
                    if not sig[i] and not visited[i]:
                        low[i] = p
                        if decode(zc[nh[i] * 15 + nv[i] * 5 + nd[i]]):
                            neg[i] = sign(i, yy, x)
                            set_sig(i, yy, x)
                            lo[i] = bit
                    i += w
        left -= 1
        if not left:
            return
        for i in range(size):
            visited[i] = 0


# --- Tier-2: boxes, headers, packets (T.800 Annexes A, B) ---------------

class _Bits:
    """Packet-header bit reader with the stuffing rule of B.10.1."""

    def __init__(self, data: bytes, pos: int, end: int) -> None:
        self.data, self.pos, self.end = data, pos, end
        self.acc = self.n = self.last = 0

    def bit(self) -> int:
        if self.n == 0:
            if self.pos >= self.end:
                raise J2kError("packet header overruns its tile-part")
            byte = self.data[self.pos]
            self.pos += 1
            self.n = 7 if self.last == 0xFF else 8
            self.acc = self.last = byte
        self.n -= 1
        return (self.acc >> self.n) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self) -> None:
        if self.last == 0xFF:
            self.pos += 1
        self.acc = self.n = self.last = 0


class _TagTree:
    def __init__(self, w: int, h: int) -> None:
        self.dims = []
        while True:
            self.dims.append((w, h))
            if w <= 1 and h <= 1:
                break
            w, h = (w + 1) // 2, (h + 1) // 2
        self.value = [[0] * (a * b) for a, b in self.dims]
        self.low = [[0] * (a * b) for a, b in self.dims]
        self.known = [[False] * (a * b) for a, b in self.dims]

    def decode(self, br: _Bits, x: int, y: int, threshold: int):
        """The leaf's value if the stream says it is below
        ``threshold``, else None."""
        path = [(lev, (y >> lev) * self.dims[lev][0] + (x >> lev))
                for lev in range(len(self.dims))]
        low = 0
        for lev, i in reversed(path):
            low = max(low, self.low[lev][i])
            while low < threshold and not self.known[lev][i]:
                if low > 64:
                    raise J2kError("tag-tree value out of range")
                if br.bit():
                    self.value[lev][i] = low
                    self.known[lev][i] = True
                else:
                    low += 1
            self.low[lev][i] = low
        lev, i = path[0]
        if self.known[lev][i] and self.value[lev][i] < threshold:
            return self.value[lev][i]
        return None


def _npasses(br: _Bits) -> int:
    if not br.bit():
        return 1
    if not br.bit():
        return 2
    v = br.bits(2)
    if v < 3:
        return 3 + v
    v = br.bits(5)
    return 6 + v if v < 31 else 37 + br.bits(7)


def unbox(data: bytes) -> bytes:
    """The codestream of the JP2/JPX file's first ``jp2c`` box."""
    if not data.startswith(b"\x00\x00\x00\x0cjP  \r\n\x87\n"):
        raise J2kError("no JP2 signature box")
    pos = 12
    while pos + 8 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, pos)
        head = 8
        if length == 1:
            length, head = struct.unpack_from(">Q", data, pos + 8)[0], 16
        end = len(data) if length == 0 else pos + length
        if end > len(data) or end < pos + head:
            raise J2kError("JP2 box overruns the file")
        if kind == b"jp2c":
            return data[pos + head:end]
        pos = end
    raise J2kError("no jp2c box")


class Stream:
    """Main-header facts of one codestream and its tiles' bytes."""

    def __init__(self, data: bytes) -> None:
        code = unbox(data)
        if struct.unpack_from(">H", code, 0)[0] != SOC:
            raise J2kError("no SOC marker")
        pos = 2
        seen = {}
        while True:
            marker, = struct.unpack_from(">H", code, pos)
            if marker == SOT:
                break
            length, = struct.unpack_from(">H", code, pos + 2)
            seen[marker] = code[pos + 4:pos + 2 + length]
            pos += 2 + length
        if not all(m in seen for m in (SIZ, COD, QCD)):
            raise J2kError("main header lacks SIZ, COD or QCD")
        self._siz(seen[SIZ])
        self._cod(seen[COD])
        self._qcd(seen[QCD])
        self.tiles = {}
        while True:
            marker, = struct.unpack_from(">H", code, pos)
            if marker == EOC:
                break
            if marker != SOT:
                raise J2kError(f"marker {marker:#06x} where SOT belongs")
            _, isot, psot = struct.unpack_from(">HHI", code, pos + 2)
            end = pos + psot
            if psot < 14 or end > len(code) or isot >= self.n_tiles:
                raise J2kError("bad tile-part")
            q = pos + 12
            while True:
                m, = struct.unpack_from(">H", code, q)
                if m == SOD:
                    break
                q += 2 + struct.unpack_from(">H", code, q + 2)[0]
            self.tiles.setdefault(isot, []).append(code[q + 2:end])
            pos = end
        if len(self.tiles) != self.n_tiles:
            raise J2kError("a tile has no tile-part")

    def _siz(self, p: bytes) -> None:
        (_, self.width, self.height, xo, yo, self.tile_w, self.tile_h,
         xto, yto, self.n_comps) = struct.unpack_from(">HIIIIIIIIH", p, 0)
        if xo or yo or xto or yto:
            raise J2kError("image or tile offsets")
        self.bitdepth = (p[36] & 0x7F) + 1
        self.n_tx = -(-self.width // self.tile_w)
        self.n_tiles = self.n_tx * -(-self.height // self.tile_h)

    def _cod(self, p: bytes) -> None:
        scod = p[0]
        self.progression, self.n_layers, self.mct = struct.unpack_from(
            ">BHB", p, 1)
        self.levels, cbw, cbh, style, transform = p[5:10]
        self.xcb, self.ycb = cbw + 2, cbh + 2
        self.reversible = transform == 1
        self.sop, self.eph = bool(scod & 2), bool(scod & 4)
        if style or self.progression != PROG_RPCL:
            raise J2kError("code-block style or progression off-recipe")
        self.exps = ([(p[10 + r] & 0xF, p[10 + r] >> 4)
                      for r in range(self.levels + 1)]
                     if scod & 1 else [(15, 15)] * (self.levels + 1))

    def _qcd(self, p: bytes) -> None:
        style, guard = p[0] & 0x1F, p[0] >> 5
        names = [(0, "LL")] + [(r, n) for r in range(1, self.levels + 1)
                               for n in ("HL", "LH", "HH")]
        self.quant = {}
        for i, (res, name) in enumerate(names):
            if style == 0:
                eps, mu = p[1 + i] >> 3, 0
                delta = 1.0
            elif style == 2:
                v, = struct.unpack_from(">H", p, 1 + 2 * i)
                eps, mu = v >> 11, v & 0x7FF
                delta = 2.0 ** (self.bitdepth + LOG2_GAIN[name] - eps) \
                    * (1 + mu / 2048.0)
            else:
                raise J2kError(f"quantization style {style}")
            self.quant[(res, name)] = (eps, mu, delta, guard + eps - 1)

    def band_rect(self, tidx: int, res: int, name: str) -> tuple:
        """(bx0, bx1, by0, by1) of a tile's subband, global band
        coordinates (T.800 B-15)."""
        ty, tx = divmod(tidx, self.n_tx)
        x0, y0 = tx * self.tile_w, ty * self.tile_h
        x1 = min(x0 + self.tile_w, self.width)
        y1 = min(y0 + self.tile_h, self.height)
        k = self.levels if name == "LL" else self.levels - res + 1
        ox = 1 if name in ("HL", "HH") else 0
        oy = 1 if name in ("LH", "HH") else 0
        half = (1 << k) >> 1

        def cdiv(a):
            return -(-a // (1 << k))
        return (cdiv(x0 - half * ox), cdiv(x1 - half * ox),
                cdiv(y0 - half * oy), cdiv(y1 - half * oy))

    def blocks(self, tidx: int, want: set) -> dict:
        """Walk the tile's packets (RPCL) as far as the finest resolution
        in ``want``, a set of (comp, res, band, cy, cx) code-block keys;
        returns {key: (nbps, npasses, bytes)} for each key in it."""
        ty, tx = divmod(tidx, self.n_tx)
        x0, y0 = tx * self.tile_w, ty * self.tile_h
        x1 = min(x0 + self.tile_w, self.width)
        y1 = min(y0 + self.tile_h, self.height)
        top = max(k[1] for k in want)
        records = []
        for c in range(self.n_comps):
            for r in range(top + 1):
                e = self.levels - r
                rx0, rx1 = -(-x0 // (1 << e)), -(-x1 // (1 << e))
                ry0, ry1 = -(-y0 // (1 << e)), -(-y1 // (1 << e))
                ppx, ppy = self.exps[r]
                shift = 0 if r == 0 else 1
                names = ("LL",) if r == 0 else ("HL", "LH", "HH")
                for py in range(ry0 >> ppy, ((ry1 - 1) >> ppy) + 1):
                    for px in range(rx0 >> ppx, ((rx1 - 1) >> ppx) + 1):
                        parts = []
                        for name in names:
                            bx0, bx1, by0, by1 = self.band_rect(tidx, r,
                                                                name)
                            kx0 = max(bx0 >> self.xcb,
                                      ((px << ppx) >> shift) >> self.xcb)
                            kx1 = min(-(-bx1 >> self.xcb),
                                      -(-(((px + 1) << ppx) >> shift)
                                        >> self.xcb))
                            ky0 = max(by0 >> self.ycb,
                                      ((py << ppy) >> shift) >> self.ycb)
                            ky1 = min(-(-by1 >> self.ycb),
                                      -(-(((py + 1) << ppy) >> shift)
                                        >> self.ycb))
                            nbw, nbh = max(0, kx1 - kx0), max(0, ky1 - ky0)
                            keys = [(c, r, name, cy, cx)
                                    for cy in range(ky0, ky0 + nbh)
                                    for cx in range(kx0, kx0 + nbw)]
                            parts.append((self.quant[(r, name)][3], nbw, nbh,
                                          keys, _TagTree(nbw, nbh),
                                          _TagTree(nbw, nbh)))
                        ref = (r, max(ry0, py << ppy) << e,
                               max(rx0, px << ppx) << e, c)
                        records.append((ref, parts))
        records.sort(key=lambda rec: rec[0])
        buf = b"".join(self.tiles[tidx])
        state = {}
        out = {}
        pos = 0
        for _, parts in records:
            for layer in range(self.n_layers):
                pos = self._packet(buf, pos, parts, layer, state, want, out)
        return {k: (state[k][0], v[0], b"".join(v[1]))
                for k, v in out.items()}

    def _packet(self, buf, pos, parts, layer, state, want, out) -> int:
        if self.sop and buf[pos:pos + 2] == b"\xff\x91":
            pos += 6
        br = _Bits(buf, pos, len(buf))
        pending = []
        if br.bit():
            for mb, nbw, _, keys, incl, zbp in parts:
                for i, key in enumerate(keys):
                    x, y = i % nbw, i // nbw
                    st = state.get(key)
                    if st is None:
                        if incl.decode(br, x, y, layer + 1) is None:
                            continue
                        z = zbp.decode(br, x, y, 1 << 30)
                        st = state[key] = [mb - z, 3]
                    elif not br.bit():
                        continue
                    n = _npasses(br)
                    nbits = st[1] + n.bit_length() - 1
                    while br.bit():
                        st[1] += 1
                        nbits += 1
                    pending.append((key, n, br.bits(nbits)))
        br.align()
        pos = br.pos
        if self.eph:
            if buf[pos:pos + 2] != b"\xff\x92":
                raise J2kError("no EPH after a packet header")
            pos += 2
        for key, n, length in pending:
            if pos + length > len(buf):
                raise J2kError("packet body overruns its tile")
            if key in want:
                entry = out.setdefault(key, [0, []])
                entry[0] += n
                entry[1].append(buf[pos:pos + length])
            pos += length
        return pos
