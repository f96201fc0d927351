"""Batch recipe: the validated request half of the batch data plane.

``parse_recipe`` is the single gate between an untrusted ``POST
/batches`` JSON body and the assembler: every malformed field raises
the typed :class:`InvalidParam` (HTTP 400), never an unhandled
``TypeError``/``KeyError`` (HTTP 500) — the same fuzz contract the
image decode parameters carry (tests/test_batches.py drives it with
generated garbage)."""
from __future__ import annotations

import os
import re
from dataclasses import dataclass

from ..codec.decode.errors import InvalidParam

# Hard per-recipe item bound: the assembler stages every item's band
# planes concurrently, so N is an HBM/host-memory knob, not taste.
MAX_ITEMS = int(os.environ.get("BUCKETEER_BATCH_MAX_ITEMS", "64"))

_LAYOUTS = ("auto", "sharded", "replicated")
_DTYPES = (None, "int32", "float32")
_KNOWN_KEYS = frozenset((
    "ids", "region", "reduce", "layers", "dtype", "layout", "store",
    "planes", "deadline_s"))
_ID_RE = re.compile(r"^[A-Za-z0-9._~%-]{1,256}$")


@dataclass(frozen=True)
class BatchRecipe:
    """One validated batch read request.

    ``ids`` are the images, in batch order; ``region``/``reduce``/
    ``layers`` apply uniformly to every item (exactly the
    :func:`decode_to_coefficients` parameters); ``dtype`` pins the
    expected coefficient dtype (``int32`` reversible / ``float32``
    irreversible) or None for whatever the codestreams carry;
    ``layout`` is the placement contract (``sharded`` demands
    ``P("batch")`` and fails closed, ``auto`` falls back to replicated
    when the surviving batch doesn't divide the mesh); ``planes``
    floors the stored container when ``store`` is set."""
    ids: tuple
    region: tuple | None = None
    reduce: int = 0
    layers: int | None = None
    dtype: str | None = None
    layout: str = "auto"
    store: bool = False
    planes: int | None = None
    deadline_s: float | None = None


def _want_int(doc: dict, key: str, lo: int, hi: int = 1 << 30):
    v = doc[key]
    if isinstance(v, bool) or not isinstance(v, int):
        raise InvalidParam(f"{key} must be an integer")
    if not lo <= v <= hi:
        raise InvalidParam(f"{key}={v} out of range [{lo}, {hi}]")
    return v


def parse_recipe(doc) -> BatchRecipe:
    """Validate an untrusted JSON document into a :class:`BatchRecipe`.
    Raises :class:`InvalidParam` for every malformed shape — unknown
    keys, non-list ids, zero-size regions, negative reduce — so the
    HTTP layer's 400 branch is the only failure path."""
    if not isinstance(doc, dict):
        raise InvalidParam("batch recipe must be a JSON object")
    unknown = sorted(set(doc) - _KNOWN_KEYS)
    if unknown:
        raise InvalidParam(f"unknown recipe keys: {', '.join(unknown)}")

    ids = doc.get("ids")
    if not isinstance(ids, list) or not ids:
        raise InvalidParam("ids must be a non-empty list of image ids")
    if len(ids) > MAX_ITEMS:
        raise InvalidParam(
            f"batch of {len(ids)} items exceeds the {MAX_ITEMS}-item "
            f"cap (BUCKETEER_BATCH_MAX_ITEMS)")
    for i in ids:
        if not isinstance(i, str) or not _ID_RE.match(i):
            raise InvalidParam(f"bad image id: {i!r}")

    region = None
    if doc.get("region") is not None:
        r = doc["region"]
        if (not isinstance(r, (list, tuple)) or len(r) != 4
                or any(isinstance(v, bool) or not isinstance(v, int)
                       for v in r)):
            raise InvalidParam("region must be [x, y, w, h] integers")
        x, y, w, h = r
        if x < 0 or y < 0:
            raise InvalidParam("region origin must be non-negative")
        if w <= 0 or h <= 0:
            raise InvalidParam(f"zero-size region {w}x{h}")
        region = (x, y, w, h)

    reduce = _want_int(doc, "reduce", 0, 32) if "reduce" in doc else 0
    layers = None
    if doc.get("layers") is not None:
        layers = _want_int(doc, "layers", 1)

    dtype = doc.get("dtype")
    if dtype not in _DTYPES:
        raise InvalidParam(f"dtype must be int32 or float32, "
                           f"not {dtype!r}")
    layout = doc.get("layout", "auto")
    if layout not in _LAYOUTS:
        raise InvalidParam(f"layout must be one of {_LAYOUTS}, "
                           f"not {layout!r}")

    store = doc.get("store", False)
    if not isinstance(store, bool):
        raise InvalidParam("store must be a boolean")
    planes = None
    if doc.get("planes") is not None:
        planes = _want_int(doc, "planes", 1, 64)
        if not store:
            raise InvalidParam("planes only applies to stored batches "
                               "(set store=true, or truncate on GET)")

    deadline_s = None
    if doc.get("deadline_s") is not None:
        v = doc["deadline_s"]
        if isinstance(v, bool) or not isinstance(v, (int, float)) \
                or not 0 < float(v) <= 3600:
            raise InvalidParam("deadline_s must be in (0, 3600]")
        deadline_s = float(v)

    return BatchRecipe(ids=tuple(ids), region=region, reduce=reduce,
                       layers=layers, dtype=dtype, layout=layout,
                       store=store, planes=planes,
                       deadline_s=deadline_s)
