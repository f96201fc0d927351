"""MQ arithmetic coder tables, the host encoder and the host decoder
(JPEG 2000 Part 1 / ITU-T T.800, Annex C).

The state table and context ids feed the fused Tier-1 kernel
(``kernels/fused_t1.py``); ``MQEncoder`` is the register-exact host
reference the tests hold the kernel's byte segments against;
``MQDecoder`` drives the read path's Tier-1 decode
(``codec/decode/t1_dec.py``).
"""
from __future__ import annotations

# State-transition table, T.800 Table C.2: (Qe, NMPS, NLPS, SWITCH).
QE_TABLE = (
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

N_CONTEXTS = 19
# Initial context states (T.800 Table D.7): UNIFORM=46, RL=3, ZC ctx0=4.
CTX_UNIFORM = 18
CTX_RL = 17


def initial_states():
    idx = [0] * N_CONTEXTS
    idx[0] = 4          # the all-zero-neighborhood ZC context
    idx[CTX_RL] = 3
    idx[CTX_UNIFORM] = 46
    return idx


class MQEncoder:
    """Spec Annex C.2 encoder (software conventions: leading dummy byte)."""

    def __init__(self) -> None:
        self.a = 0x8000
        self.c = 0
        self.ct = 12
        self.buf = bytearray([0])  # buf[0] is the dummy pre-byte
        self.ctx_idx = initial_states()
        self.ctx_mps = [0] * N_CONTEXTS

    def encode(self, bit: int, ctx: int) -> None:
        idx = self.ctx_idx[ctx]
        qe, nmps, nlps, switch = QE_TABLE[idx]
        if bit == self.ctx_mps[ctx]:
            self.a -= qe
            if (self.a & 0x8000) == 0:
                if self.a < qe:
                    self.a = qe
                else:
                    self.c += qe
                self.ctx_idx[ctx] = nmps
                self._renorm()
            else:
                self.c += qe
        else:
            self.a -= qe
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            if switch:
                self.ctx_mps[ctx] ^= 1
            self.ctx_idx[ctx] = nlps
            self._renorm()

    def _renorm(self) -> None:
        while True:
            self.a = (self.a << 1) & 0xFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def _byteout(self) -> None:
        if self.buf[-1] == 0xFF:
            self.buf.append((self.c >> 20) & 0xFF)
            self.c &= 0xFFFFF
            self.ct = 7
        elif self.c < 0x8000000:
            self.buf.append((self.c >> 19) & 0xFF)
            self.c &= 0x7FFFF
            self.ct = 8
        else:
            self.buf[-1] += 1
            if self.buf[-1] == 0xFF:
                self.c &= 0x7FFFFFF
                self.buf.append((self.c >> 20) & 0xFF)
                self.c &= 0xFFFFF
                self.ct = 7
            else:
                self.buf.append((self.c >> 19) & 0xFF)
                self.c &= 0x7FFFF
                self.ct = 8

    def n_bytes(self) -> int:
        """Bytes emitted so far (without flush)."""
        return len(self.buf) - 1

    def truncation_length(self) -> int:
        """Conservative prefix length sufficient to decode everything
        encoded so far (used for layer truncation points between
        non-terminated passes)."""
        return len(self.buf) - 1 + 4

    def flush(self) -> bytes:
        tempc = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= tempc:
            self.c -= 0x8000
        self.c = (self.c << self.ct) & 0xFFFFFFFF
        self._byteout()
        self.c = (self.c << self.ct) & 0xFFFFFFFF
        self._byteout()
        out = self.buf[1:]
        if out and out[-1] == 0xFF:
            out = out[:-1]
        return bytes(out)


class MQDecoder:
    """Spec Annex C.3 decoder (the read path's host Tier-1)."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.bp = 0
        self.ctx_idx = initial_states()
        self.ctx_mps = [0] * N_CONTEXTS
        b = self._byte(0)
        self.c = b << 16
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
        idx = self.ctx_idx[ctx]
        qe, nmps, nlps, switch = QE_TABLE[idx]
        self.a -= qe
        if ((self.c >> 16) & 0xFFFF) < qe:
            # LPS exchange path
            if self.a < qe:
                d = self.ctx_mps[ctx]
                self.ctx_idx[ctx] = nmps
            else:
                d = 1 - self.ctx_mps[ctx]
                if switch:
                    self.ctx_mps[ctx] ^= 1
                self.ctx_idx[ctx] = nlps
            self.a = qe
            self._renorm()
        else:
            self.c -= qe << 16
            if (self.a & 0x8000) == 0:
                # MPS exchange path
                if self.a < qe:
                    d = 1 - self.ctx_mps[ctx]
                    if switch:
                        self.ctx_mps[ctx] ^= 1
                    self.ctx_idx[ctx] = nlps
                else:
                    d = self.ctx_mps[ctx]
                    self.ctx_idx[ctx] = nmps
                self._renorm()
            else:
                d = self.ctx_mps[ctx]
        return d

    def _renorm(self) -> None:
        while True:
            if self.ct == 0:
                self._bytein()
            self.a = (self.a << 1) & 0xFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.a & 0x8000:
                break
