"""The native host back half: PCRD-opt layer allocation and Tier-2
packet writing in C++ (``csrc/host_t2.cpp``), behind encoder._finish.

:class:`Tier2` is made once per encode, from the coded blocks as arrays
(pass offsets, truncation lengths, distortions, weights and the
concatenated data: the fused Tier-1's columns, codec/cxd.py
``T1Columns``, as they are, or ``t1.CodedBlock``s flattened) and a
:class:`PacketPlan` (every packet in
codestream order, from the geometry and progression that
encoder._build_precincts and encoder._packet_sequence compute). Each
:meth:`Tier2.build` then runs the allocation and the packets for one
byte budget, in two calls that release the interpreter lock. The bytes
equal those of codec/rate.py, codec/t2.py and encoder._tile_parts, which
stay as the plain version (encoder._plain_finish, for the tests).

The library is built by g++ at first use into ``bucketeer_tpu_torch/
build/``; if it cannot be built, the call raises.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from ..kernels.build import Library
from . import codestream as cs

_P = ctypes.c_void_p
_I = ctypes.c_int
HOST_T2 = Library("host_t2", ("host_t2.cpp",), {
    "t2_allocate": ([_I] + [_P] * 5 + [_I, ctypes.c_double, _I] + [_P] * 2,
                    _I),
    "t2_write": ([_P] * 4 + [_I] + [_P] * 5 + [_I, _P, _I, _P, _I], _P),
    "t2_result_sizes": ([_P] * 3, ctypes.c_int64),
    "t2_result_take": ([_P] * 2, None),
}, cuda=False)


@dataclass
class PacketPlan:
    """Every packet of an encode in codestream order, as arrays.

    Band-precinct k is a ``bp_dims[k]`` (w, h) grid of the blocks
    ``bp_blocks[bp_off[k]:bp_off[k + 1]]`` (indices into the encode's
    block list, row-major) with ``bp_zbp`` missing bit-planes each;
    precinct record r holds the band-precincts ``rec_off[r]:rec_off[r +
    1]``; packet i is record ``pkts[i, 0]`` at layer ``pkts[i, 1]`` with
    SOP sequence number ``pkts[i, 2]`` (-1: no SOP); tile-part j holds
    the packets ``part_off[j]:part_off[j + 1]`` and is ``parts[j]`` =
    (tile index, tpsot, tnsot)."""
    bp_dims: np.ndarray
    bp_off: np.ndarray
    bp_blocks: np.ndarray
    bp_zbp: np.ndarray
    rec_off: np.ndarray
    pkts: np.ndarray
    part_off: np.ndarray
    parts: list


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


class Tier2:
    """One encode's blocks and packet plan, built per byte budget."""

    def __init__(self, blocks: list, weights, plan: PacketPlan,
                 n_layers: int, use_eph: bool, gen_plt: bool) -> None:
        """From ``t1.CodedBlock``s, flattened."""
        n = len(blocks)
        npasses = np.fromiter((len(b.passes) for b in blocks), np.int32, n)
        pass_off = np.zeros(n + 1, np.int32)
        np.cumsum(npasses, out=pass_off[1:])
        total = int(pass_off[-1])
        data_off = np.zeros(n + 1, np.int64)
        np.cumsum(np.fromiter((len(b.data) for b in blocks), np.int64, n),
                  out=data_off[1:])
        self._setup(
            pass_off,
            np.fromiter((p.cum_length for b in blocks for p in b.passes),
                        np.int64, total),
            np.fromiter((p.dist_reduction for b in blocks
                         for p in b.passes), np.float64, total),
            data_off, np.frombuffer(b"".join(b.data for b in blocks),
                                    np.uint8),
            weights, plan, n_layers, use_eph, gen_plt)

    @classmethod
    def from_columns(cls, cols, weights, plan: PacketPlan, n_layers: int,
                     use_eph: bool, gen_plt: bool) -> "Tier2":
        """From the fused Tier-1's columns (codec/cxd.py ``T1Columns``)
        of the encode's blocks, as they are."""
        self = cls.__new__(cls)
        self._setup(cols.pass_off, cols.cum_len, cols.dist, cols.data_off,
                    cols.data, weights, plan, n_layers, use_eph, gen_plt)
        return self

    def _setup(self, pass_off, cum_len, dist, data_off, data, weights,
               plan: PacketPlan, n_layers: int, use_eph: bool,
               gen_plt: bool) -> None:
        n = len(pass_off) - 1
        self.pass_off = np.ascontiguousarray(pass_off, np.int32)
        total = int(self.pass_off[-1])
        self.cum_len = np.ascontiguousarray(cum_len, np.int64)
        self.dist = np.ascontiguousarray(dist, np.float64)
        self.data_off = np.ascontiguousarray(data_off, np.int64)
        # A pointer into a buffer of at least one byte.
        self.data = np.ascontiguousarray(data, np.uint8) if len(data) \
            else np.zeros(1, np.uint8)
        self.weights = np.ascontiguousarray(weights, np.float64)
        if self.weights.shape != (n,):
            raise ValueError(f"{n} blocks but {self.weights.shape} weights")
        if self.cum_len.shape != (total,) or self.dist.shape != (total,) \
                or self.data_off.shape != (n + 1,) \
                or int(self.data_off[-1]) > len(data):
            raise ValueError(
                f"{n} blocks of {total} passes and {int(self.data_off[-1])}"
                f" bytes, but {self.cum_len.shape} lengths, "
                f"{self.dist.shape} distortions, {self.data_off.shape} "
                f"data offsets and {len(data)} bytes")
        self.plan = plan
        self.n_blocks = n
        self.n_layers = n_layers
        self.use_eph = use_eph
        self.gen_plt = gen_plt
        self.n_packets = len(plan.pkts)

    def allocate(self, budget: float | None) -> tuple:
        """rate.allocate: each block's cumulative (passes, bytes) after
        each layer, as two (n_blocks, n_layers) arrays."""
        lib = HOST_T2.library()
        passes = np.zeros((self.n_blocks, self.n_layers), np.int32)
        nbytes = np.zeros((self.n_blocks, self.n_layers), np.int64)
        lib.t2_allocate(self.n_blocks, _ptr(self.pass_off),
                        _ptr(self.cum_len), _ptr(self.dist),
                        _ptr(self.data_off), _ptr(self.weights),
                        self.n_layers, 0.0 if budget is None else budget,
                        budget is not None, _ptr(passes), _ptr(nbytes))
        return passes, nbytes

    def write(self, passes: np.ndarray, nbytes: np.ndarray) -> list:
        """The tile-parts for these layer boundaries: [(tile index,
        tpsot, tnsot, aux segments, body)], as encoder._tile_parts
        returns them."""
        shape = (self.n_blocks, self.n_layers)
        for name, a, dtype in (("passes", passes, np.int32),
                               ("nbytes", nbytes, np.int64)):
            if a.shape != shape or a.dtype != dtype or \
                    not a.flags.c_contiguous:
                raise ValueError(f"{name} must be a contiguous {shape} "
                                 f"{np.dtype(dtype)} array; got {a.shape} "
                                 f"{a.dtype}")
        lib = HOST_T2.library()
        p = self.plan
        handle = lib.t2_write(
            _ptr(self.data), _ptr(self.data_off), _ptr(passes),
            _ptr(nbytes), self.n_layers, _ptr(p.bp_dims), _ptr(p.bp_off),
            _ptr(p.bp_blocks), _ptr(p.bp_zbp), _ptr(p.rec_off),
            len(p.rec_off) - 1, _ptr(p.pkts), len(p.parts),
            _ptr(p.part_off), self.use_eph)
        part_bytes = np.zeros(len(p.parts), np.int64)
        pkt_lens = np.zeros(self.n_packets, np.int32)
        total = lib.t2_result_sizes(handle, _ptr(part_bytes),
                                    _ptr(pkt_lens))
        out = np.empty(max(total, 1), np.uint8)
        lib.t2_result_take(handle, _ptr(out))
        body = memoryview(out)      # the parts are views, not copies
        lens = pkt_lens.tolist()
        parts = []
        at = 0
        for j, (tidx, tpsot, tnsot) in enumerate(p.parts):
            end = at + int(part_bytes[j])
            aux = ([cs.plt(lens[p.part_off[j]:p.part_off[j + 1]],
                           zplt=tpsot)] if self.gen_plt else [])
            parts.append((tidx, tpsot, tnsot, aux, body[at:end]))
            at = end
        return parts

    def build(self, budget: float | None) -> list:
        """One Tier-2 build: the allocation for ``budget`` (None: every
        pass ships), then its tile-parts."""
        return self.write(*self.allocate(budget))
