"""The host Tier-1: batches of code-blocks coded in C++ on the host's
cores, as in the JAX package's codec/t1_batch.py.

Three entries, one library (``csrc/host_t1.cpp``, the block coder with
EBCOT context modeling and the MQ coder, and its thread pool):

- :func:`encode_packed` codes the device front-end's packed bit-plane
  rows (codec/frontend.py, mode ``"rows"``);
- :func:`encode_blocks` codes magnitude and sign arrays sliced on the
  host (the straddling tile grids, encoder._legacy_tier1);
- :func:`encode_cxd` replays the device CX/D streams of the split
  (codec/cxd.py ``run_cxd``) through the MQ coder alone.

The library is built by g++ at first use into ``bucketeer_tpu_torch/
build/`` and called through ctypes, which releases the interpreter lock
for the call. If it cannot be built, the call raises: ``t1.encode_block``
and ``cxd.replay_block`` are the test references, not fallbacks.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from ..analysis.contracts import contract
from ..kernels.build import Library
from . import t1

_P = ctypes.c_void_p
_CODER = ([ctypes.c_int] + [_P] * 7 + [ctypes.c_int], _P)
HOST_T1 = Library("host_t1", ("host_t1.cpp",), {
    "t1_encode_blocks": _CODER,
    "t1_encode_packed": _CODER,
    "t1_encode_cxd": ([ctypes.c_int] + [_P] * 8 + [ctypes.c_int], _P),
    "t1_block_sizes": ([_P] * 4, None),
    "t1_block_get": ([_P, ctypes.c_int] + [_P] * 5, None),
    "t1_result_free": ([_P], None),
}, cuda=False)


def default_threads() -> int:
    """Coder threads per call: ``BUCKETEER_T1_THREADS`` if set, else one
    fewer than the host's cores (at least one)."""
    env = os.environ.get("BUCKETEER_T1_THREADS")
    if env:
        return max(1, int(env))
    return max(1, (os.cpu_count() or 2) - 1)


def _collect(lib, handle, n: int) -> list:
    """Pull a native result handle into [t1.CodedBlock] and free it."""
    try:
        nbps = np.zeros(n, dtype=np.int32)
        npasses = np.zeros(n, dtype=np.int32)
        nbytes = np.zeros(n, dtype=np.int64)
        lib.t1_block_sizes(handle, nbps.ctypes.data, npasses.ctypes.data,
                           nbytes.ctypes.data)
        out = []
        for i in range(n):
            np_i, nb_i = int(npasses[i]), int(nbytes[i])
            data = np.empty(max(nb_i, 1), dtype=np.uint8)
            ptype = np.zeros(max(np_i, 1), dtype=np.int32)
            pplane = np.zeros(max(np_i, 1), dtype=np.int32)
            plen = np.zeros(max(np_i, 1), dtype=np.int64)
            pdist = np.zeros(max(np_i, 1), dtype=np.float64)
            lib.t1_block_get(handle, i, data.ctypes.data, ptype.ctypes.data,
                             pplane.ctypes.data, plen.ctypes.data,
                             pdist.ctypes.data)
            passes = [t1.PassInfo(int(ptype[k]), int(pplane[k]),
                                  int(plen[k]), float(pdist[k]))
                      for k in range(np_i)]
            out.append(t1.CodedBlock(data[:nb_i].tobytes(), int(nbps[i]),
                                     passes))
        return out
    finally:
        lib.t1_result_free(handle)


@contract(shapes={"payload": ("R", 512), "offsets": ("n1",),
                  "nbps": ("n",), "floors": ("n",), "hs": ("n",),
                  "ws": ("n",)},
          dtypes={"payload": "uint8", "offsets": "integer",
                  "nbps": "integer", "floors": "integer",
                  "hs": "integer", "ws": "integer"})
def encode_packed(payload: np.ndarray, offsets: np.ndarray,
                  nbps: np.ndarray, floors: np.ndarray, hs: np.ndarray,
                  ws: np.ndarray, bands: list) -> list:
    """Tier-1 over the front-end's packed bitmap payload
    (frontend.fetch_payload): payload (R, 512) uint8 rows, offsets
    (n+1,) row offsets per block (frontend.payload_plan), per-block
    nbps, floors, coded extents and band names. Returns [t1.CodedBlock]
    in block order; a block with nbps <= floor codes as empty."""
    n = len(nbps)
    if not n:
        return []
    lib = HOST_T1.library()
    # Bind every converted array to a local: .ctypes.data of an unnamed
    # temporary is a dangling pointer by call time.
    payload = np.ascontiguousarray(payload, dtype=np.uint8)
    offs = np.ascontiguousarray(offsets[:n], dtype=np.int64)
    nbps_c = np.ascontiguousarray(nbps, dtype=np.int32)
    floors_c = np.ascontiguousarray(floors, dtype=np.int32)
    hs_c = np.ascontiguousarray(hs, dtype=np.int32)
    ws_c = np.ascontiguousarray(ws, dtype=np.int32)
    cls = np.array([t1.BAND_CLS[b] for b in bands], dtype=np.int32)
    if not (len(offs) == len(floors_c) == len(hs_c) == len(ws_c)
            == len(cls) == n):
        raise ValueError(f"encode_packed: {n} blocks but per-block arrays "
                         f"of lengths {len(offs)}, {len(floors_c)}, "
                         f"{len(hs_c)}, {len(ws_c)}, {len(cls)}")
    # The coder reads each live block's sign row and nbps - floor plane
    # rows from its offset: refuse a payload or extent it would overrun.
    live = nbps_c > floors_c
    end = offs[live] + (nbps_c - floors_c + 1)[live]
    if (payload.ndim != 2 or payload.shape[1] != 512
            or (live.any() and int(end.max()) > len(payload))
            or hs_c.max() > 64 or ws_c.max() > 64 or nbps_c.max() > 32):
        raise ValueError("encode_packed: the payload rows, extents or "
                         "plane counts do not match the packed layout")
    handle = lib.t1_encode_packed(
        n, payload.ctypes.data, offs.ctypes.data, nbps_c.ctypes.data,
        floors_c.ctypes.data, hs_c.ctypes.data, ws_c.ctypes.data,
        cls.ctypes.data, default_threads())
    return _collect(lib, handle, n)


def encode_blocks(specs: list) -> list:
    """specs: [(mags uint32 (h, w), signs bool (h, w), band name, fracs
    uint8 (h, w) | None)] -> [t1.CodedBlock] in order."""
    n = len(specs)
    if not n:
        return []
    lib = HOST_T1.library()
    offsets = np.zeros(n + 1, dtype=np.int64)
    hs = np.zeros(n, dtype=np.int32)
    ws = np.zeros(n, dtype=np.int32)
    cls = np.zeros(n, dtype=np.int32)
    any_fracs = any(f is not None for _, _, _, f in specs)
    for i, (m, _, band, _) in enumerate(specs):
        hs[i], ws[i] = m.shape
        cls[i] = t1.BAND_CLS[band]
        offsets[i + 1] = offsets[i] + m.size
    total = int(offsets[-1])
    mags = np.empty(total, dtype=np.uint32)
    negs = np.empty(total, dtype=np.uint8)
    fracs = np.zeros(total, dtype=np.uint8) if any_fracs else None
    for i, (m, s, _, f) in enumerate(specs):
        sl = slice(offsets[i], offsets[i + 1])
        mags[sl] = np.ascontiguousarray(m, dtype=np.uint32).ravel()
        negs[sl] = np.ascontiguousarray(s, dtype=np.uint8).ravel()
        if f is not None:
            fracs[sl] = np.ascontiguousarray(f, dtype=np.uint8).ravel()
    handle = lib.t1_encode_blocks(
        n, mags.ctypes.data, negs.ctypes.data,
        fracs.ctypes.data if fracs is not None else None,
        offsets.ctypes.data, hs.ctypes.data, ws.ctypes.data,
        cls.ctypes.data, default_threads())
    return _collect(lib, handle, n)


def encode_cxd(streams) -> list:
    """MQ replay of one chunk's CX/D streams (``cxd.CxdStreams``) on the
    host's cores. Returns [t1.CodedBlock] in block order, byte-identical
    to the fused device Tier-1 over the same coefficients."""
    n = len(streams.nbps)
    if not n:
        return []
    lib = HOST_T1.library()
    payload = np.ascontiguousarray(streams.payload, dtype=np.uint8)
    row_offs = np.ascontiguousarray(streams.row_offsets, dtype=np.int64)
    nbps = np.ascontiguousarray(streams.nbps, dtype=np.int32)
    p_offs = np.ascontiguousarray(streams.pass_offsets, dtype=np.int64)
    p_types = np.ascontiguousarray(streams.pass_types, dtype=np.int32)
    p_planes = np.ascontiguousarray(streams.pass_planes, dtype=np.int32)
    p_nsyms = np.ascontiguousarray(streams.pass_nsyms, dtype=np.int32)
    p_dists = np.ascontiguousarray(streams.pass_dists, dtype=np.float64)
    if len(row_offs) != n or len(p_offs) != n + 1:
        raise ValueError(f"encode_cxd: {n} blocks but {len(row_offs)} row "
                         f"offsets and {len(p_offs)} pass offsets")
    handle = lib.t1_encode_cxd(
        n, payload.ctypes.data, row_offs.ctypes.data, nbps.ctypes.data,
        p_offs.ctypes.data, p_types.ctypes.data, p_planes.ctypes.data,
        p_nsyms.ctypes.data, p_dists.ctypes.data, default_threads())
    return _collect(lib, handle, n)
