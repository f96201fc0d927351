"""The in-process read path: JP2/JPX derivatives back to pixels, with
the inverse transform on the card.

The counterpart of :class:`CudaConverter` for the serving direction the
reference stack exists to feed (TIFF -> JP2 -> S3 for IIIF viewers):
IIIF tile/thumbnail requests are region + resolution-level reads, so
the reader exposes the decoder's native partial decode — ``reduce=r``
touches only the low-frequency subbands, ``layers=l`` truncates at a
quality layer, and ``region=(x, y, w, h)`` decodes only the code-blocks
a window intersects.

Caching is tiered, because the two artifacts a tile storm re-uses have
wildly different sizes and lifetimes:

- **stream-index tier**: the Tier-2 random-access index
  (``codec/decode/index.py``), tiny (~100 B/packet) and valid for the
  life of the file — keyed by file identity ``(path, mtime, size)``,
  bounded by entry count (``BUCKETEER_INDEX_CACHE_ENTRIES``, default
  64, 0 disables). One miss costs one PLT scan or header walk;
  every later region read of that file seeks directly.
- **decoded-tile tier**: decoded arrays keyed by
  ``(path, mtime, size, reduce, layers, region)``, bounded in bytes
  (``BUCKETEER_DECODE_CACHE_MB``, default 64 MB, 0 disables). The
  region component is clamp-normalized to the image (once its
  dimensions are known from the main header), so an edge tile
  requested at a fixed nominal tile size shares the entry of its
  clamped twin instead of decoding twice.

The file-identity part of both keys means a re-converted derivative is
never served stale. Hit/miss/eviction counters per tier:
``decode.cache_{hits,misses,evictions}`` (tile tier, the pre-region
names kept) and ``decode.index_cache_{hits,misses,evictions}``; index
builds are timed under the ``decode.index_build`` stage.

Tier-2 parsing, the index build and the Tier-1 decode run on the host;
the inverse transform (pixel reads) or the dequantizer (coefficient
reads, :meth:`CudaReader.read_coefficients`) runs on the reader's
``device``.
"""
from __future__ import annotations

import os
import time
from collections import OrderedDict

import numpy as np

from .. import obs
from ..analysis.graftrace import seam
from ..codec.decode import DecodeError, build_index, decode
from ..codec.decode import probe as _probe
from ..codec.decode import t1_dec
from ..codec.decode.device import require_device
from ..tensor import decode_to_coefficients
from .base import ConverterError, output_path

DEFAULT_CACHE_MB = 64
DEFAULT_INDEX_ENTRIES = 64
DIMS_CACHE_ENTRIES = 256


def derivative_path(image_id: str) -> str | None:
    """Locate the stored derivative for an image id (the file
    :class:`CudaConverter.convert` wrote): .jpx first (the default
    output), then .jp2. None if neither exists."""
    for ext in (".jpx", ".jp2"):
        path = output_path(image_id, ext)
        if os.path.exists(path):
            return path
    return None


class _DecodeCache:
    """Bounded LRU of decoded arrays, sized in bytes. Entries are
    returned write-locked (``setflags(write=False)``) so a caller
    mutating a cached array fails loudly instead of corrupting every
    later hit. Coefficient reads cache their CoefficientSet through
    the same tier (``nbytes``-sized like an array); torch tensors have
    no write lock, so the reader caches a private copy of the set and
    hands every caller its own (:meth:`CudaReader.read_coefficients`)."""

    def __init__(self, max_bytes: int) -> None:
        self.max_bytes = max_bytes
        self._lock = seam.make_lock("_DecodeCache._lock")
        self._entries: OrderedDict = OrderedDict()
        self._bytes = 0
        self.evictions = 0

    def get(self, key):
        with self._lock:
            seam.read(self, "_entries")
            arr = self._entries.get(key)
            if arr is not None:
                seam.write(self, "_entries")
                self._entries.move_to_end(key)
            return arr

    def put(self, key, arr: np.ndarray) -> int:
        """Insert and evict LRU entries past the budget. Returns how
        many entries *this* call evicted (computed under the lock, so
        concurrent misses don't count each other's evictions)."""
        if arr.nbytes > self.max_bytes:
            return 0                    # bigger than the whole budget
        if hasattr(arr, "setflags"):
            arr.setflags(write=False)
        evicted_here = 0
        with self._lock:
            seam.write(self, "_entries")
            old = self._entries.pop(key, None)
            if old is not None:
                seam.write(self, "_bytes")
                self._bytes -= old.nbytes
            self._entries[key] = arr
            seam.write(self, "_bytes")
            self._bytes += arr.nbytes
            while self._bytes > self.max_bytes and self._entries:
                seam.write(self, "_entries")
                _, evicted = self._entries.popitem(last=False)
                seam.write(self, "_bytes")
                self._bytes -= evicted.nbytes
                seam.write(self, "evictions")
                self.evictions += 1
                evicted_here += 1
        return evicted_here

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def nbytes(self) -> int:
        return self._bytes


class _IndexCache:
    """Count-bounded LRU of stream indexes (the index tier). Entries
    are ~100 bytes per packet, so a count bound is the right budget
    shape — 64 open derivatives of even a 100-MPix scan stay in the
    low tens of MB."""

    def __init__(self, max_entries: int) -> None:
        self.max_entries = max_entries
        self._lock = seam.make_lock("_IndexCache._lock")
        self._entries: OrderedDict = OrderedDict()
        self.evictions = 0

    def get(self, key):
        with self._lock:
            seam.read(self, "_entries")
            idx = self._entries.get(key)
            if idx is not None:
                seam.write(self, "_entries")
                self._entries.move_to_end(key)
            return idx

    def put(self, key, idx) -> int:
        evicted_here = 0
        with self._lock:
            seam.write(self, "_entries")
            self._entries.pop(key, None)
            self._entries[key] = idx
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                seam.write(self, "evictions")
                self.evictions += 1
                evicted_here += 1
        return evicted_here

    def __len__(self) -> int:
        return len(self._entries)


def _norm_region(region) -> tuple | None:
    """Normalize a region spec into a hashable cache-key component.
    Validation proper happens in the decoder (typed InvalidParam); this
    only has to be stable for equal requests."""
    if region is None:
        return None
    return tuple(region)


def _clamp_region(region: tuple, width: int, height: int) -> tuple:
    """Clamp extents to the image exactly as the decoder does
    (``min(x + w, width)`` — IIIF semantics), so clamp-equivalent
    requests (edge tiles of a fixed nominal tile size) share one
    tile-cache entry instead of decoding and storing duplicates.
    Anything the decoder would reject is returned untouched —
    validation stays the decoder's job."""
    try:
        x, y, w, h = (int(v) for v in region)
        if any(int(v) != v for v in region):
            return region
    except (TypeError, ValueError, OverflowError):
        return region
    if not (0 <= x < width and 0 <= y < height and w > 0 and h > 0):
        return region
    return (x, y, min(w, width - x), min(h, height - y))


class CudaReader:
    """JPEG 2000 decoding with the inverse transform on one CUDA device
    (or, for tests, the CPU) — the inverse of :class:`CudaConverter`.

    ``cache_mb``: decoded-tile LRU budget; negative resolves the
    BUCKETEER_DECODE_CACHE_MB env (default 64), 0 disables.
    ``index_entries``: stream-index tier entry bound; negative resolves
    BUCKETEER_INDEX_CACHE_ENTRIES (default 64), 0 disables. ``metrics``:
    optional sink with ``record(stage, seconds, pixels=0, items=0)`` and
    ``count(name, n=1)`` for the per-tier cache counters and the index
    build time. ``device``: where the inverse transform (or the
    coefficient dequantizer) runs; "cuda" without a usable CUDA device
    raises here. ``scheduler``: an engine.scheduler.EncodeScheduler;
    with one, every miss (and, for a region read, the stream-index
    build before it) runs as one admitted read job
    (``scheduler.read``, at read priority, on the device the scheduler
    assigns when ``device`` names no index); without one, misses run on
    the calling thread.
    """

    def __init__(self, cache_mb: int = -1, metrics=None,
                 scheduler=None, index_entries: int = -1,
                 device="cuda") -> None:
        self.device = require_device(device)
        self.scheduler = scheduler
        if cache_mb < 0:
            try:
                cache_mb = int(os.environ.get("BUCKETEER_DECODE_CACHE_MB",
                                              str(DEFAULT_CACHE_MB)))
            except ValueError:
                cache_mb = DEFAULT_CACHE_MB
        if index_entries < 0:
            try:
                index_entries = int(os.environ.get(
                    "BUCKETEER_INDEX_CACHE_ENTRIES",
                    str(DEFAULT_INDEX_ENTRIES)))
            except ValueError:
                index_entries = DEFAULT_INDEX_ENTRIES
        self.cache = (_DecodeCache(cache_mb << 20) if cache_mb > 0
                      else None)
        self.index_cache = (_IndexCache(index_entries)
                            if index_entries > 0 else None)
        self.metrics = metrics
        self._index_builds: dict = {}        # key -> in-flight Event
        self._index_builds_lock = seam.make_lock(
            "CudaReader._index_builds_lock")
        # file identity -> (width, height): lets region keys be
        # clamp-normalized before the tile-cache lookup
        self._dims = _IndexCache(DIMS_CACHE_ENTRIES)

    def _count(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.count(name)

    def _stream_index(self, source_path: str, st, data: bytes):
        """The index tier: a cached (or freshly built) random-access
        stream index for region reads; None when the tier is off.
        Builds are single-flight per file identity: a cold tile storm
        on one derivative pays for one header walk, with the other
        clients waiting on the builder instead of duplicating it."""
        if self.index_cache is None:
            return None
        ikey = (source_path, st.st_mtime_ns, st.st_size)
        idx = self.index_cache.get(ikey)
        if idx is not None:
            self._count("decode.index_cache_hits")
            return idx
        with self._index_builds_lock:
            seam.read(self, "_index_builds")
            pending = self._index_builds.get(ikey)
            if pending is None:
                seam.write(self, "_index_builds")
                pending = self._index_builds[ikey] = seam.make_event(
                    "CudaReader.index_build")
                builder = True
            else:
                builder = False
        if not builder:
            # Slice the wait so a waiter parked behind a wedged builder
            # honors its thread's decode-services check (a request
            # deadline) instead of waiting out the whole window.
            waited = 0.0
            while not pending.wait(timeout=0.25) and waited < 300:
                t1_dec.poll()
                waited += 0.25
            idx = self.index_cache.get(ikey)
            if idx is not None:
                self._count("decode.index_cache_hits")
                return idx
            # The builder failed (or timed out): fall through and build
            # for ourselves rather than surfacing its error here.
        self._count("decode.index_cache_misses")
        try:
            if self.metrics is not None:
                t0 = time.perf_counter()
                idx = build_index(data)
                self.metrics.record("decode.index_build",
                                    time.perf_counter() - t0,
                                    items=idx.n_packets)
            else:
                idx = build_index(data)
            evicted = self.index_cache.put(ikey, idx)
            if evicted and self.metrics is not None:
                self.metrics.count("decode.index_cache_evictions",
                                   evicted)
            return idx
        finally:
            if builder:
                with self._index_builds_lock:
                    seam.write(self, "_index_builds")
                    self._index_builds.pop(ikey, None)
                pending.set()

    def _cached_read(self, source_path: str, reduce: int, layers,
                     region, *, coefficients: bool):
        """The shared tiered-cache machinery behind :meth:`read` and
        :meth:`read_coefficients`: one protocol (file identity, region
        clamp normalization with the probe-and-recheck on first touch,
        per-tier counters), two products keyed apart by a trailing
        ``True`` on the coefficient reads' keys.

        The tiers: file identity keys both; a region is clamp-normalized
        to the image, learning its dimensions from the main header on
        the file identity's first touch and looking the tile tier up
        again under the clamped key."""
        try:
            st = os.stat(source_path)
        except OSError:
            raise ConverterError(
                f"derivative not found: {source_path}") from None
        region = _norm_region(region)
        fid = (source_path, st.st_mtime_ns, st.st_size)
        suffix = (True,) if coefficients else ()

        def cache_key(region):
            return fid + (reduce, layers, region) + suffix

        def hit(out):
            self._count("decode.cache_hits")
            return out.clone() if coefficients else out

        dims = self._dims.get(fid) if region is not None else None
        if dims is not None:
            region = _clamp_region(region, *dims)
        key = cache_key(region)
        if self.cache is not None:
            out = self.cache.get(key)
            if out is not None:
                return hit(out)
        with open(source_path, "rb") as fh:
            data = fh.read()
        if region is not None and dims is None:
            # First touch of this file identity: learn (width, height)
            # from the main header so the key clamps like the decoder
            # will; malformed data defers to the decode's typed error.
            try:
                meta = _probe(data)
            except DecodeError:
                meta = None
            if meta is not None:
                dims = (meta["width"], meta["height"])
                self._dims.put(fid, dims)
                clamped = _clamp_region(region, *dims)
                if clamped != region:
                    region = clamped
                    key = cache_key(region)
                    if self.cache is not None:
                        out = self.cache.get(key)
                        if out is not None:
                            return hit(out)
        if self.cache is not None:
            self._count("decode.cache_misses")

        # The decode — and, for region reads, the stream-index build that
        # precedes it — runs inside the scheduler's admitted read slot
        # when one is installed: a cold read's header walk is costly
        # host work, so it pays the same admission (bounded queue, 503)
        # as the decode itself. Single-flight index waiters are safe
        # here because the builder is already running in a granted slot.
        def job():
            idx = (self._stream_index(source_path, st, data)
                   if region is not None else None)
            if coefficients:
                return decode_to_coefficients(
                    data, region=region, reduce=reduce, layers=layers,
                    index=idx, device=self.device)
            return decode(data, reduce=reduce, layers=layers,
                          region=region, index=idx, device=self.device)
        if self.scheduler is not None:
            with obs.span("decode.read",
                          region=list(region) if region else None,
                          reduce=reduce):
                out = self.scheduler.read(job)
        else:
            out = job()
        if self.cache is not None:
            evicted = self.cache.put(key,
                                     out.clone() if coefficients else out)
            if evicted and self.metrics is not None:
                self.metrics.count("decode.cache_evictions", evicted)
        return out

    def read(self, source_path: str, reduce: int = 0,
             layers: int | None = None,
             region: tuple | None = None) -> np.ndarray:
        """Decode a JP2/JPX file (or raw codestream) from disk;
        ``region=(x, y, w, h)`` decodes only that window (bit-exact
        crop of the full decode, served via the stream index).
        Missing files raise ConverterError; malformed content raises
        the decoder's typed DecodeError. Cache hits return a read-only
        array — copy before mutating."""
        return self._cached_read(source_path, reduce, layers, region,
                                 coefficients=False)

    def read_coefficients(self, source_path: str, reduce: int = 0,
                          layers: int | None = None,
                          region: tuple | None = None):
        """Compressed-domain read: decode the derivative to per-subband
        coefficient tensors on the reader's device
        (``tensor.decode_to_coefficients``, a CoefficientSet) instead
        of pixels, stopping after Tier-1 + dequantization. Served
        through the same tiered cache as pixel reads — the key gains a
        trailing ``True``, so a repeated read of the same region hits
        the decoded-tile tier (same per-tier counters). The cache keeps
        a private copy of the set, and every read, a miss as well as a
        hit, returns a set of its own whose bands share no storage with
        the cache's or another read's: a caller may change them in
        place. Region reads reuse the stream-index tier (single-flight
        builds) exactly like :meth:`read`."""
        return self._cached_read(source_path, reduce, layers, region,
                                 coefficients=True)

    def reset_caches(self, tiles: bool = True,
                     index: bool = False) -> None:
        """Drop cached entries (benchmark cold phases, tests)."""
        if tiles and self.cache is not None:
            self.cache = _DecodeCache(self.cache.max_bytes)
        if index and self.index_cache is not None:
            self.index_cache = _IndexCache(self.index_cache.max_entries)

    def dims(self, source_path: str) -> tuple:
        """(width, height) via the file-identity dims cache, probing
        the main header only on first touch per identity. The
        ``region=square`` alias needs dimensions on every request and
        must not re-read the whole file when the tile is cached."""
        try:
            st = os.stat(source_path)
        except OSError:
            raise ConverterError(
                f"derivative not found: {source_path}") from None
        fid = (source_path, st.st_mtime_ns, st.st_size)
        dims = self._dims.get(fid)
        if dims is None:
            with open(source_path, "rb") as fh:
                meta = _probe(fh.read())
            dims = (meta["width"], meta["height"])
            self._dims.put(fid, dims)
        return dims

    def probe(self, source_path: str) -> dict:
        """Main-header metadata (dims, bit depth, levels, layers)
        without decoding any tile data — what the server needs to pick
        response encodings and validate partial-decode parameters."""
        if not os.path.exists(source_path):
            raise ConverterError(f"derivative not found: {source_path}")
        with open(source_path, "rb") as fh:
            return _probe(fh.read())

    def read_id(self, image_id: str, reduce: int = 0,
                layers: int | None = None,
                region: tuple | None = None) -> np.ndarray:
        """Decode the stored derivative for ``image_id``."""
        path = derivative_path(image_id)
        if path is None:
            raise ConverterError(
                f"no derivative for image id: {image_id}")
        return self.read(path, reduce=reduce, layers=layers,
                         region=region)


__all__ = ["CudaReader", "derivative_path", "DecodeError"]
