"""Host-side TIFF reading: source images -> numpy arrays for the device
pipeline.

Replaces the reference's reliance on libtiff inside ``kdu_compress``
(reference: src/main/docker/Dockerfile:17-19,54-55 installs libtiff for the
Kakadu binary to consume). Supports 8/16-bit grayscale and RGB — the
archival-scan formats named in BASELINE.md configs 1 and 3.

Decompression-bomb policy: PIL's default ``MAX_IMAGE_PIXELS`` guard
(~178 MPix) is tuned for web thumbnails and rejects the very scans this
service exists to encode — BASELINE config 4's 20000x20000 map scans are
400 MPix. The guard is therefore replaced, deliberately, with our own
limit sized for archival masters: ``MAX_PIXELS`` (default 2 GPix,
``BUCKETEER_MAX_IMAGE_PIXELS`` env override). Oversized files still fail
loudly — with an actionable error naming the knob — instead of either
tripping PIL's warning-then-error ladder or opening unbounded
allocations.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np

# Default ceiling: 2 GPix ~= a 45000x45000 RGB scan (~6 GB decoded) —
# above BASELINE config 4's 400 MPix with headroom, below anything a
# single host could plausibly stage.
DEFAULT_MAX_PIXELS = 2_000_000_000


def max_pixels() -> int:
    """The effective pixel ceiling (env override read per call so long-
    running services can be retuned without restart)."""
    import os

    return int(os.environ.get("BUCKETEER_MAX_IMAGE_PIXELS",
                              str(DEFAULT_MAX_PIXELS)))


# Image.MAX_IMAGE_PIXELS is process-global and the batch converter runs
# concurrent converts (engine/batch.py registers instances=2, each via
# asyncio.to_thread): without a lock one thread could restore the guard
# while another's open() is mid-flight — intermittently re-tripping the
# bomb error on a legitimate scan, or leaving the guard disabled.
_PIL_GUARD_LOCK = threading.Lock()


@contextlib.contextmanager
def _open_checked(path: str):
    """Open an image with PIL's bomb guard suspended and our own archival
    ceiling enforced instead (PIL checks at open(), so the swap must
    bracket it; the module global is restored immediately, under a lock
    so concurrent opens can't observe each other's swap)."""
    from PIL import Image

    with _PIL_GUARD_LOCK:
        old = Image.MAX_IMAGE_PIXELS
        Image.MAX_IMAGE_PIXELS = None
        try:
            img = Image.open(path)
        finally:
            Image.MAX_IMAGE_PIXELS = old
    try:
        w, h = img.size
        limit = max_pixels()
        if w * h > limit:
            raise ValueError(
                f"{path}: {w}x{h} = {w * h} pixels exceeds the "
                f"{limit}-pixel ceiling; raise BUCKETEER_MAX_IMAGE_PIXELS "
                "if this is a legitimate archival scan")
        yield img
    finally:
        img.close()


def read_image(path: str) -> tuple[np.ndarray, int]:
    """Read an image file into ``(array, bitdepth)``.

    Returns (H, W) for grayscale or (H, W, 3) for color, dtype uint8 or
    uint16. Alpha channels are dropped; palette images are expanded.
    """
    with _open_checked(path) as img:
        if img.mode == "P":
            img = img.convert("RGB")
        elif img.mode == "1":   # bilevel -> 0/255 grayscale
            img = img.convert("L")
        elif img.mode in ("LA", "RGBA"):
            img = img.convert(img.mode[:-1])
        elif img.mode == "CMYK":
            img = img.convert("RGB")
        arr = np.asarray(img)

    if arr.ndim == 3 and arr.shape[2] == 4:
        arr = arr[:, :, :3]
    if arr.dtype == np.int32:  # PIL 'I' mode: 32-bit container for 16-bit data
        arr = np.clip(arr, 0, 65535).astype(np.uint16)
    if arr.dtype == np.uint16:
        return arr, 16
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    return arr, 8


def image_size(path: str) -> tuple[int, int]:
    """(width, height) without decoding pixel data."""
    with _open_checked(path) as img:
        return img.size
