"""The host half of the CX/D-split Tier-1: MQ replay of a chunk's device
CX/D streams (codec/cxd.py ``run_cxd``) into ``t1.CodedBlock``s.

The replay is ``csrc/host_mq.cpp``, built by g++ at first use into
``bucketeer_tpu_torch/build/`` and called through ctypes, which releases
the interpreter lock for the call; its thread pool codes the chunk's
blocks in parallel. If the library cannot be built, the replay raises:
``cxd.replay_block`` is the test reference, not a fallback.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from ..kernels.build import Library
from . import t1

_P = ctypes.c_void_p
HOST_MQ = Library("host_mq", ("host_mq.cpp",), {
    "t1_encode_cxd": ([ctypes.c_int] + [_P] * 8 + [ctypes.c_int], _P),
    "t1_block_sizes": ([_P] * 4, None),
    "t1_block_get": ([_P, ctypes.c_int] + [_P] * 5, None),
    "t1_result_free": ([_P], None),
}, cuda=False)


def default_threads() -> int:
    """Replay threads: ``BUCKETEER_T1_THREADS`` if set, else one fewer
    than the host's cores (at least one)."""
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


def encode_cxd(streams) -> list:
    """MQ replay of one chunk's CX/D streams (``cxd.CxdStreams``) on the
    host's cores. Returns [t1.CodedBlock] in block order, byte-identical
    to the fused device Tier-1 over the same coefficients."""
    n = len(streams.nbps)
    if not n:
        return []
    lib = HOST_MQ.library()
    # Bind every converted array to a local: .ctypes.data of an unnamed
    # temporary is a dangling pointer by call time.
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
