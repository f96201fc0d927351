"""JP2 / JPX file format boxing (T.800 Annex I; T.801 for JPX brand).

Wraps a raw codestream into the box structure decoders and IIIF viewers
expect. The reference emits ``.jpx`` files named after the URL-encoded
image id (reference: converters/KakaduConverter.java:34,57); we produce
the same, with .jp2 boxing available for maximum decoder compatibility.
"""
from __future__ import annotations

import struct


def _box(box_type: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + box_type + payload


SIGNATURE = struct.pack(">I", 12) + b"jP  " + b"\x0d\x0a\x87\x0a"


def ftyp(jpx: bool = False) -> bytes:
    if jpx:
        return _box(b"ftyp", b"jpx " + struct.pack(">I", 0) + b"jpx jp2 jpxb")
    return _box(b"ftyp", b"jp2 " + struct.pack(">I", 0) + b"jp2 ")


def jp2_header(width: int, height: int, n_comps: int, bitdepth: int,
               signed: bool = False) -> bytes:
    ihdr = _box(b"ihdr", struct.pack(
        ">IIHBBBB", height, width, n_comps,
        (bitdepth - 1) | (0x80 if signed else 0),
        7,   # compression type: JPEG 2000
        0,   # colorspace known
        0))  # no intellectual property
    enum_cs = 16 if n_comps >= 3 else 17  # sRGB / greyscale
    colr = _box(b"colr", bytes([1, 0, 0]) + struct.pack(">I", enum_cs))
    return _box(b"jp2h", ihdr + colr)


def wrap(codestream: bytes, width: int, height: int, n_comps: int,
         bitdepth: int, jpx: bool = False, signed: bool = False) -> bytes:
    return (SIGNATURE
            + ftyp(jpx)
            + jp2_header(width, height, n_comps, bitdepth, signed)
            + _box(b"jp2c", codestream))
