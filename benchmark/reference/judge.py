"""Judging the service's outputs against the plain reference.

- :func:`judge_file` decodes code-blocks of a JP2 file, drawn from a
  seed, and holds each decoded sample to the coefficient the reference
  computes from the source image. A lossless file must hold every
  coefficient exactly (``mismatch``, limit 0); a lossy one must hold
  the reference's coefficient inside the interval its decoded bits
  allow (``gap``: how far outside, in quantizer steps), and its
  midpoints near it (``distortion``: the mean squared distance, in
  steps, which coding less than the recipe's rate raises).
- :func:`read_truth` gives the samples a read must return.

Each also reads its control on the same blocks or samples: the
reference computed one step below the precision the configuration
states (samples one bit short for the reversible path, bfloat16
arithmetic for the irreversible one), put in the program's place and
held to the reference by the same comparison.
"""
from __future__ import annotations

import numpy as np

from . import j2k, wavelet


class Truth:
    """The reference's subbands of the tiles of one source image,
    computed on first use and kept."""

    def __init__(self, img: np.ndarray, bitdepth: int = 8) -> None:
        self.img = img
        self.bitdepth = bitdepth
        self._bands: dict = {}

    def tile(self, stream, tidx: int) -> np.ndarray:
        ty, tx = divmod(tidx, stream.n_tx)
        y0, x0 = ty * stream.tile_h, tx * stream.tile_w
        return self.img[y0:y0 + stream.tile_h, x0:x0 + stream.tile_w]

    def bands(self, stream, tidx: int, dtype: str = "float64") -> dict:
        key = (tidx, stream.reversible, stream.levels, stream.mct, dtype)
        if key not in self._bands:
            tile = self.tile(stream, tidx)
            if stream.reversible and dtype != "float64":
                tile = tile & ~tile.dtype.type(1)   # one bit fewer
            planes = wavelet.colour(tile, self.bitdepth, stream.reversible,
                                    "float64" if stream.reversible
                                    else dtype, bool(stream.mct))
            self._bands[key] = wavelet.bands(planes, stream.levels,
                                             stream.reversible, dtype)
        return self._bands[key]


def tile_blocks(stream, tidx: int) -> set:
    """Every code-block key (comp, res, band, cy, cx) of one tile."""
    keys = set()
    for res in range(stream.levels + 1):
        for name in (("LL",) if res == 0 else ("HL", "LH", "HH")):
            bx0, bx1, by0, by1 = stream.band_rect(tidx, res, name)
            if bx1 <= bx0 or by1 <= by0:
                continue
            for cy in range(by0 >> stream.ycb, -(-by1 >> stream.ycb)):
                for cx in range(bx0 >> stream.xcb, -(-bx1 >> stream.xcb)):
                    keys.update((comp, res, name, cy, cx)
                                for comp in range(stream.n_comps))
    return keys


def sample_blocks(stream, rng: np.random.Generator, n: int,
                  whole_tile: bool = True) -> dict:
    """{tile: set of block keys} drawn from ``rng``: every block of one
    tile (all levels, bands and components, so every launch group of
    that tile), then ``n`` single blocks. Their tile rows are dealt out
    in turn from a shuffled order, so each row of tiles (and each shard
    of a row-split mesh) is drawn; every other block draws its
    resolution level first (so the coarse bands are not swamped) and the
    rest draw it by its share of the tile's blocks (so the fine levels,
    which hold most of the blocks and of the work, get theirs)."""
    picks: dict = {}
    if whole_tile:
        tidx = int(rng.integers(stream.n_tiles))
        picks[tidx] = tile_blocks(stream, tidx)
    n_ty = stream.n_tiles // stream.n_tx
    rows = rng.permutation(n_ty)
    for i in range(n):
        tidx = int(rows[i % n_ty]) * stream.n_tx + int(
            rng.integers(stream.n_tx))
        if i % 2 == 0:
            res = int(rng.integers(stream.levels + 1))
        else:
            share = np.zeros(stream.levels + 1)
            for comp, r, *_ in tile_blocks(stream, tidx):
                share[r] += comp == 0
            res = int(rng.choice(stream.levels + 1, p=share / share.sum()))
        comp = int(rng.integers(stream.n_comps))
        name = "LL" if res == 0 else ("HL", "LH", "HH")[int(rng.integers(3))]
        bx0, bx1, by0, by1 = stream.band_rect(tidx, res, name)
        if bx1 <= bx0 or by1 <= by0:
            continue
        cx = int(rng.integers(bx0 >> stream.xcb, -(-bx1 >> stream.xcb)))
        cy = int(rng.integers(by0 >> stream.ycb, -(-by1 >> stream.ycb)))
        picks.setdefault(tidx, set()).add((comp, res, name, cy, cx))
    return picks


def _cell(stream, tidx, key, arr) -> np.ndarray:
    """The code-block's samples out of a tile's band array."""
    comp, res, name, cy, cx = key
    bx0, bx1, by0, by1 = stream.band_rect(tidx, res, name)
    ys = max(cy << stream.ycb, by0) - by0
    ye = min((cy + 1) << stream.ycb, by1) - by0
    xs = max(cx << stream.xcb, bx0) - bx0
    xe = min((cx + 1) << stream.xcb, bx1) - bx0
    return arr[comp, ys:ye, xs:xe]


def _gap(value, lo, width, neg, known_sign) -> np.ndarray:
    """How far ``value`` (signed, in steps) lies outside the interval
    |value| in [lo, lo + width) with the decoded sign."""
    mag = np.abs(value)
    wrong_sign = known_sign & (mag > 0) & ((value < 0) != neg)
    out = np.maximum(0.0, np.maximum(lo - mag, mag - (lo + width)))
    return np.where(wrong_sign, mag + lo, out)


def _as_decoded(stream, key, coeff, plane) -> tuple:
    """The control's coefficients of a block in the form a decode gives
    (magnitude in the file's quantizer steps, undecoded planes, sign),
    so that they take the program's place: every plane (reversible), or
    cut at the planes the file itself leaves undecoded (irreversible,
    the same rate)."""
    if stream.reversible:
        c = coeff.astype(np.int64)
        return np.abs(c), np.zeros(c.shape, np.int64), c < 0
    delta = stream.quant[key[1:3]][2]
    q = np.floor(np.abs(coeff.astype(np.float64)) / delta).astype(np.int64)
    return (q >> plane) << plane, plane, coeff < 0


def _compare(acc: dict, stream, key, decoded, want, step) -> None:
    """Hold one block's decoded samples to the reference's coefficients
    ``want``; add to the readings in ``acc``."""
    lo, plane, neg = decoded
    acc["blocks"] += 1
    acc["samples"] += want.size
    if stream.reversible:
        got = np.where(neg, -lo, lo)
        acc["mismatch"] += int(np.count_nonzero((plane != 0) | (got != want)))
        return
    scale = stream.quant[key[1:3]][2] / step
    width = (np.int64(1) << plane).astype(np.float64)
    value = want.astype(np.float64) / step
    acc["gap"] = max(acc["gap"], float(np.max(_gap(
        value, lo * scale, width * scale, neg, lo > 0), initial=0.0)))
    mag = np.where(lo > 0, (lo + width / 2) * scale, 0.0)
    acc["sq_err"] += float(np.sum((np.where(neg, -mag, mag) - value) ** 2))


def judge_file(data: bytes, truth: Truth, rng, n_blocks: int,
               base_delta: float | None, control: bool = False,
               whole_tile: bool = True) -> dict:
    """Decode the code-blocks :func:`sample_blocks` draws and compare.

    Returns ``blocks`` and ``samples`` judged and the readings: for a
    reversible file ``mismatch``, the samples that differ from the
    reference; for an irreversible one ``gap``, the widest distance in
    quantizer steps by which the reference lies outside the interval the
    decoded bits allow, and ``sq_err``, the sum of squared distances
    (in steps) from the interval's midpoint, or 0 where nothing was
    decoded, to the reference (``distortion`` is it over ``samples``).
    With ``control``, the same readings under ``control.``: the
    reference one precision step down put in the program's place."""
    stream = j2k.Stream(data)
    if (stream.width, stream.height, stream.n_comps) != (
            truth.img.shape[1], truth.img.shape[0], truth.img.shape[2]):
        raise j2k.J2kError("file dimensions differ from the source")
    ref_steps = (None if stream.reversible else
                 wavelet.steps(stream.levels, truth.bitdepth, base_delta))
    blank = ({"mismatch": 0} if stream.reversible
             else {"gap": 0.0, "sq_err": 0.0})
    sides = {"": {"blocks": 0, "samples": 0, **blank}}
    if control:
        sides["control."] = {"blocks": 0, "samples": 0, **blank}
    for tidx, keys in sorted(sample_blocks(stream, rng, n_blocks,
                                           whole_tile).items()):
        coded = stream.blocks(tidx, keys)
        ref = truth.bands(stream, tidx)
        ctrl = truth.bands(stream, tidx, "bit_short" if stream.reversible
                           else "bfloat16") if control else None
        for key in sorted(keys):
            comp, res, name, cy, cx = key
            want = _cell(stream, tidx, key, ref[(res, name)])
            h, w = want.shape
            mb = stream.quant[(res, name)][3]
            nbps, npasses, body = coded.get(key, (mb, 0, b""))
            step = None if stream.reversible else ref_steps[(res, name)]
            decoded = j2k.decode_block(body, nbps, npasses, name, h, w)
            _compare(sides[""], stream, key, decoded, want, step)
            if control:
                other = _cell(stream, tidx, key, ctrl[(res, name)])
                _compare(sides["control."], stream, key,
                         _as_decoded(stream, key, other, decoded[1]),
                         want, step)
    return {pre + k: v for pre, acc in sides.items() for k, v in acc.items()}


def combine(parts: list) -> dict:
    """The readings of several files as one: counts add up, ``gap`` and
    ``rate_off`` are the widest, and ``distortion`` is the squared error
    over all the samples judged."""
    out: dict = {}
    for part in parts:
        for key, val in part.items():
            if key.endswith(("gap", "rate_off")):
                out[key] = max(out.get(key, 0.0), val)
            else:
                out[key] = out.get(key, 0) + val
    for pre in ("", "control."):
        if pre + "sq_err" in out:
            out[pre + "distortion"] = (out.pop(pre + "sq_err")
                                       / max(1, out[pre + "samples"]))
    return out


def read_truth(img: np.ndarray, tile: int, reduce: int,
               region: tuple | None, mct: bool, bitdepth: int = 8,
               bit_short: bool = False, cache: dict | None = None
               ) -> np.ndarray:
    """The samples a reversible read of ``img`` (tiles of ``tile``
    square, colour-transformed where ``mct``) gives at ``reduce`` over
    ``region`` = (x, y, w, h) in full-resolution coordinates, or the
    whole image. ``cache`` keeps reduced tiles between calls."""
    cache = {} if cache is None else cache
    h, w = img.shape[:2]
    x, y, rw, rh = region if region else (0, 0, w, h)
    x1, y1 = min(x + rw, w), min(y + rh, h)
    s = 1 << reduce
    rows = []
    for ty in range(y // tile, -(-y1 // tile)):
        row = []
        for tx in range(x // tile, -(-x1 // tile)):
            key = (ty, tx, reduce, bit_short)
            if key not in cache:
                part = img[ty * tile:(ty + 1) * tile,
                           tx * tile:(tx + 1) * tile]
                if bit_short:
                    part = part & ~part.dtype.type(1)
                cache[key] = wavelet.reduced(part, bitdepth, reduce, mct)
            row.append(cache[key])
        rows.append(np.concatenate(row, axis=1))
    full = np.concatenate(rows, axis=0)
    oy, ox = (y // tile) * tile, (x // tile) * tile
    return full[-(-(y - oy) // s):-(-(y1 - oy) // s),
                -(-(x - ox) // s):-(-(x1 - ox) // s)]
