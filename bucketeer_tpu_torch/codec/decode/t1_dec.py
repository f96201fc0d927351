"""EBCOT Tier-1 decode (T.800 Annex D, decode direction).

The exact inverse of the Tier-1 coder (``kernels/fused_t1.py``): the
MQ decoder (codec/mq.py, Annex C.3) regenerates the CX/D decision
stream while the same significance-propagation / magnitude-refinement
/ cleanup context modeling that produced it replays in lockstep —
context modeling *is* the decoder's address generator, so the two
halves cannot be separated the way the encode side's device-CX/D split
separates them.

Decoded samples are returned as signed "half-magnitude" integers
``hval``: for a sample whose lowest decoded bit-plane is ``p`` with
decoded magnitude bits ``m`` (in units of ``2^p``),

    |hval| = (2*m + 1) << p        (i.e. 2 * (m + 0.5) * 2^p)

— the standard mid-point reconstruction carried in doubled units so it
stays integer-exact. A fully decoded lossless sample ends at p=0 with
``|hval| = 2*mag + 1``, so the device inverse recovers the exact
coefficient as ``|hval| >> 1``; a truncated (quality-layer) decode keeps
the same half-step midpoint OpenJPEG reconstructs, which is what makes
the lossy differential tests line up.

Hot-loop engineering: flat Python lists (cheaper scalar indexing than
numpy), incremental neighbor-significance counters updated only on the
rare became-significant events, and context tables flattened to 1-D.
Code-blocks are independent; ``decode_blocks`` is the batch entry.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np

from ..mq import CTX_RL, CTX_UNIFORM, MQDecoder
from ..t1 import _SC, _ZC_HH, _ZC_LL_LH
from .errors import DecodeError

_services = threading.local()


@contextlib.contextmanager
def decode_services(check=None):
    """Install a per-thread hook polled between code-blocks in
    :func:`decode_blocks` — the decode-side mirror of the encoder's
    ``pipeline_services`` seam. The scheduler uses it to enforce read
    deadlines mid-decode instead of only while queued."""
    prev = getattr(_services, "check", None)
    _services.check = check
    try:
        yield
    finally:
        _services.check = prev


def poll() -> None:
    """Run this thread's installed check (deadline enforcement) — a
    no-op when none is installed. For code on the admitted read path
    that waits outside :func:`decode_blocks` (e.g. single-flight index
    waiters) and must still honor the request deadline."""
    check = getattr(_services, "check", None)
    if check is not None:
        check()


def _flat_zc(table, swap_hv: bool) -> list:
    """(3,3,5) context table -> flat [sh*15 + sv*5 + sd] list, with the
    H/V role swap applied for HL bands at build time."""
    out = [0] * 45
    for sh in range(3):
        for sv in range(3):
            for sd in range(5):
                shh, svv = (sv, sh) if swap_hv else (sh, sv)
                out[sh * 15 + sv * 5 + sd] = int(table[shh, svv, sd])
    return out


_ZC_FLAT = {
    "LL": _flat_zc(_ZC_LL_LH, False),
    "LH": _flat_zc(_ZC_LL_LH, False),
    "HL": _flat_zc(_ZC_LL_LH, True),
    "HH": _flat_zc(_ZC_HH, False),
}

# Sign-coding (ctx, xor) flattened to [(h+1)*3 + (v+1)].
_SC_FLAT = [_SC[(h, v)] for h in (-1, 0, 1) for v in (-1, 0, 1)]


def max_passes(nbps: int) -> int:
    """Pass-count ceiling for a block with ``nbps`` coded bit-planes:
    one cleanup for the MSB plane, three passes per lower plane."""
    return max(0, 3 * nbps - 2)


def decode_block(data: bytes, nbps: int, npasses: int, band: str,
                 h: int, w: int) -> tuple:
    """Decode one code-block's pass stream.

    Returns (hvals int32 (h, w) signed half-magnitudes, n_decisions).
    Raises DecodeError for pass/plane counts no conforming encoder can
    emit (the packet header is attacker-controlled input).
    """
    if nbps <= 0 or npasses <= 0:
        return np.zeros((h, w), dtype=np.int32), 0
    if nbps > 30:
        raise DecodeError(f"{nbps} bit-planes exceeds the 30-plane cap")
    if npasses > max_passes(nbps):
        raise DecodeError(
            f"{npasses} passes exceeds the {max_passes(nbps)} possible "
            f"for {nbps} bit-planes")

    mq = MQDecoder(bytes(data))
    decode = mq.decode
    zc = _ZC_FLAT[band]
    size = h * w
    sigma = [0] * size
    pi = [0] * size
    refined = [0] * size
    nb_h = [0] * size        # significant horizontal neighbors
    nb_v = [0] * size
    nb_d = [0] * size
    habs = [0] * size        # |hval| in doubled units
    neg = [0] * size
    n_dec = 0

    def set_sig(i: int, y: int, x: int) -> None:
        """Mark (y, x) significant and bump its neighbors' counters."""
        sigma[i] = 1
        if x > 0:
            nb_h[i - 1] += 1
            if y > 0:
                nb_d[i - 1 - w] += 1
            if y < h - 1:
                nb_d[i - 1 + w] += 1
        if x < w - 1:
            nb_h[i + 1] += 1
            if y > 0:
                nb_d[i + 1 - w] += 1
            if y < h - 1:
                nb_d[i + 1 + w] += 1
        if y > 0:
            nb_v[i - w] += 1
        if y < h - 1:
            nb_v[i + w] += 1

    def decode_sign(i: int, y: int, x: int) -> int:
        hc = vc = 0
        if x > 0 and sigma[i - 1]:
            hc += -1 if neg[i - 1] else 1
        if x < w - 1 and sigma[i + 1]:
            hc += -1 if neg[i + 1] else 1
        if y > 0 and sigma[i - w]:
            vc += -1 if neg[i - w] else 1
        if y < h - 1 and sigma[i + w]:
            vc += -1 if neg[i + w] else 1
        hc = -1 if hc < -1 else (1 if hc > 1 else hc)
        vc = -1 if vc < -1 else (1 if vc > 1 else vc)
        ctx, xor = _SC_FLAT[(hc + 1) * 3 + (vc + 1)]
        return decode(ctx) ^ xor

    done = [npasses]

    def tick() -> bool:
        done[0] -= 1
        return done[0] == 0

    p = nbps - 1
    first_plane = True
    while p >= 0:
        bit3 = 3 << p
        bit1 = 1 << p

        if not first_plane:
            # Pass 1: significance propagation
            for y0 in range(0, h, 4):
                ymax = y0 + 4 if y0 + 4 < h else h
                for x in range(w):
                    i = y0 * w + x
                    for y in range(y0, ymax):
                        if not sigma[i] and (nb_h[i] or nb_v[i]
                                             or nb_d[i]):
                            ctx = zc[nb_h[i] * 15 + nb_v[i] * 5
                                     + nb_d[i]]
                            n_dec += 1
                            pi[i] = 1
                            if decode(ctx):
                                n_dec += 1
                                neg[i] = decode_sign(i, y, x)
                                set_sig(i, y, x)
                                habs[i] = bit3
                        i += w
            if tick():
                break

            # Pass 2: magnitude refinement
            for y0 in range(0, h, 4):
                ymax = y0 + 4 if y0 + 4 < h else h
                for x in range(w):
                    i = y0 * w + x
                    for y in range(y0, ymax):
                        if sigma[i] and not pi[i]:
                            if refined[i]:
                                ctx = 16
                            elif nb_h[i] or nb_v[i] or nb_d[i]:
                                ctx = 15
                            else:
                                ctx = 14
                            n_dec += 1
                            if decode(ctx):
                                habs[i] += bit1
                            else:
                                habs[i] -= bit1
                            refined[i] = 1
                        i += w
            if tick():
                break

        # Pass 3: cleanup (with the run-length shortcut)
        for y0 in range(0, h, 4):
            ymax = y0 + 4 if y0 + 4 < h else h
            for x in range(w):
                i0 = y0 * w + x
                y = y0
                if y0 + 3 < h:
                    rl = True
                    i = i0
                    for _ in range(4):
                        if (sigma[i] or pi[i] or nb_h[i] or nb_v[i]
                                or nb_d[i]):
                            rl = False
                            break
                        i += w
                    if rl:
                        n_dec += 1
                        if not decode(CTX_RL):
                            continue
                        n_dec += 2
                        k = (decode(CTX_UNIFORM) << 1) | decode(
                            CTX_UNIFORM)
                        yk = y0 + k
                        ik = i0 + k * w
                        n_dec += 1
                        neg[ik] = decode_sign(ik, yk, x)
                        set_sig(ik, yk, x)
                        habs[ik] = bit3
                        y = yk + 1
                i = i0 + (y - y0) * w
                for yy in range(y, ymax):
                    if not sigma[i] and not pi[i]:
                        ctx = zc[nb_h[i] * 15 + nb_v[i] * 5 + nb_d[i]]
                        n_dec += 1
                        if decode(ctx):
                            n_dec += 1
                            neg[i] = decode_sign(i, yy, x)
                            set_sig(i, yy, x)
                            habs[i] = bit3
                    i += w
        if tick():
            break
        for i in range(size):
            pi[i] = 0
        first_plane = False
        p -= 1

    hv = np.array(habs, dtype=np.int64).reshape(h, w)
    if hv.size and int(hv.max()) >= (1 << 31):
        raise DecodeError("decoded magnitude overflows int32")
    hv = hv.astype(np.int32)
    hv[np.array(neg, dtype=bool).reshape(h, w)] *= -1
    return hv, n_dec


def decode_blocks(specs: list) -> tuple:
    """Batch entry: specs [(data, nbps, npasses, band, h, w)] ->
    ([hvals arrays], total decisions). Blocks are independent (the same
    property the encode side's kernels exploit); kept sequential
    here — the pure-Python MQ loop is GIL-bound either way."""
    out = []
    total = 0
    check = getattr(_services, "check", None)
    for data, nbps, npasses, band, h, w in specs:
        if check is not None:
            check()
        hv, n = decode_block(data, nbps, npasses, band, h, w)
        out.append(hv)
        total += n
    return out, total
