"""Deep TIFF sources: 16-bit samples that PIL would not hand back at full
depth, read with NumPy.

``codec/tiff.py`` reads every source through PIL. PIL opens a 48-bit RGB
TIFF as 8-bit RGB, and a big-endian 16-bit grayscale TIFF as ``I;16B``,
which ``tiff.read_image`` clips to 255: either way samples are lost
without an error. :func:`deep` tells such a file from its tags (more
than 8 bits per sample, in three or more samples or in big-endian byte
order), and :func:`read_image` reads it strip by strip straight into the
output array. Little-endian 16-bit grayscale, which PIL reads exactly,
and 8-bit sources of every format stay with ``tiff.read_image``.

What it reads: uncompressed TIFFs (``Compression`` 1), classic or
BigTIFF, either byte order, unsigned 16-bit samples, 1 sample
(BlackIsZero gray), 3 (RGB) or 4 (RGB and one extra sample marked by
``ExtraSamples``, dropped as ``tiff.read_image`` drops alpha), one strip
or many, chunky or planar (``PlanarConfiguration`` 1 or 2). The tags are
PIL's parse of the first IFD, under the same pixel ceiling as
``tiff.read_image``; the pixels never go through PIL. Anything else it
refuses with :class:`ConverterError` naming the reason (compression,
tiles, ...): it never falls back to PIL, whose fallback is the
truncation.
"""
from __future__ import annotations

import numpy as np

from ..codec import tiff
from .base import ConverterError

# Tags read (TIFF 6.0).
WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC = 256, 257, 258, 259, 262
STRIP_OFFSETS, SAMPLES, ROWS_PER_STRIP, STRIP_BYTES = 273, 277, 278, 279
PLANAR, TILE_WIDTH, EXTRA_SAMPLES, SAMPLE_FORMAT = 284, 322, 338, 339

_COMPRESSIONS = {5: "LZW", 7: "JPEG", 8: "Deflate", 32773: "PackBits",
                 32946: "Deflate"}


def tags(path: str) -> tuple[str, dict] | None:
    """The byte order (``"<"`` or ``">"``) and the first IFD's tags, each
    value a tuple, as PIL parses them; None where the file is an image
    but no TIFF. Raises what ``tiff.read_image`` raises for a file PIL
    cannot open or one above ``tiff.max_pixels()``."""
    with tiff._open_checked(path) as im:
        if im.format != "TIFF":
            return None
        ifd = im.tag_v2
        return ("<" if ifd.prefix == b"II" else ">",
                {k: v if isinstance(v, tuple) else (v,)
                 for k, v in ifd.items()})


def deep(path: str) -> bool:
    """True where ``path`` is a TIFF whose samples PIL would not return at
    full depth: more than 8 bits per sample, in three or more samples
    per pixel or in big-endian order."""
    try:
        found = tags(path)
    except (OSError, ValueError):
        return False        # tiff.read_image raises the same in its turn
    if found is None:
        return False
    order, t = found
    return max(t.get(BITS, (1,))) > 8 and (t.get(SAMPLES, (1,))[0] >= 3
                                           or order == ">")


def _refuse(path: str, why: str):
    raise ConverterError(f"{path}: cannot read this deep TIFF: {why}")


def read_image(path: str) -> tuple[np.ndarray, int]:
    """Read an uncompressed 16-bit TIFF into ``(array, 16)`` as
    ``tiff.read_image`` returns it: (H, W) or (H, W, 3) uint16, any
    extra sample dropped. Raises :class:`ConverterError` for a file
    outside what the module docstring lists, ``ValueError`` above
    ``tiff.max_pixels()``."""
    found = tags(path)
    if found is None:
        _refuse(path, "not a TIFF")
    order, t = found

    def one(tag, default=None):
        return t.get(tag, (default,))[0]

    if TILE_WIDTH in t:
        _refuse(path, "tiled")
    comp = one(COMPRESSION, 1)
    if comp != 1:
        _refuse(path, f"compressed ({_COMPRESSIONS.get(comp, comp)})")
    if set(t.get(BITS, (1,))) != {16}:
        _refuse(path, f"{t.get(BITS, (1,))} bits per sample")
    if set(t.get(SAMPLE_FORMAT, (1,))) != {1}:
        _refuse(path, "samples are not unsigned integers")
    spp, photometric = one(SAMPLES, 1), one(PHOTOMETRIC)
    extra = t.get(EXTRA_SAMPLES, ())
    if not ((spp == 1 and photometric == 1)
            or (spp == 3 and photometric == 2)
            or (spp == 4 and photometric == 2 and len(extra) == 1)):
        _refuse(path, f"{spp} samples, photometric {photometric}, "
                f"extra samples {extra}")
    w, h = one(WIDTH), one(LENGTH)
    planar = one(PLANAR, 1)
    if planar not in (1, 2):
        _refuse(path, f"planar configuration {planar}")
    offsets, counts = t.get(STRIP_OFFSETS, ()), t.get(STRIP_BYTES, ())
    rps = min(one(ROWS_PER_STRIP, h), h)
    if rps < 1:
        _refuse(path, "no rows per strip")
    per_plane = -(-h // rps)
    n_planes = spp if planar == 2 else 1
    if len(offsets) != per_plane * n_planes or len(counts) != len(offsets):
        _refuse(path, f"{len(offsets)} strips for {per_plane * n_planes}")

    # Each strip lands at its place in the output: planar files strip by
    # strip into (spp, H, W), chunky ones into (H, W, spp).
    shape = (spp, h, w) if planar == 2 else (h, w, spp)
    out = np.empty(shape, np.uint16)
    flat = memoryview(out.reshape(-1).view(np.uint8))
    row_bytes = w * 2 * (1 if planar == 2 else spp)
    at = 0
    with open(path, "rb") as fh:
        for s, (off, count) in enumerate(zip(offsets, counts)):
            rows = min(rps, h - (s % per_plane) * rps)
            need = rows * row_bytes
            if count < need:
                _refuse(path, f"strip {s} holds {count} bytes of {need}")
            fh.seek(off)
            if fh.readinto(flat[at:at + need]) != need:
                _refuse(path, f"strip {s} is cut short")
            at += need
    if order != ("<" if np.little_endian else ">"):
        out.byteswap(inplace=True)
    if planar == 2:
        out = np.ascontiguousarray(out[:min(spp, 3)].transpose(1, 2, 0))
    elif spp == 4:
        out = out[:, :, :3]
    if spp == 1:
        out = out.reshape(h, w)
    return out, 16
