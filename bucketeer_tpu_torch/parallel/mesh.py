"""Device-mesh plumbing for multi-GPU encodes.

The reference scales by fanning items out to up to 1000 AWS Lambda
functions and routing oversized images whole to a second service instance
(reference: README.md:176, handlers/LoadCsvHandler.java:256-281,
verticles/LargeImageVerticle.java:72-97). The port replaces both with a
single device mesh, driven from one process:

- axis ``data``  — batch/data parallelism over tiles or images (the
  Lambda fan-out analog);
- axis ``tile``  — spatial parallelism *inside* one huge tile (the
  large-image analog: decompose instead of route), with DWT halo copies
  between row-neighbour shards (see
  :mod:`bucketeer_tpu_torch.parallel.sharded_dwt`).

A :class:`DeviceMesh` is a ``(data, tile)`` grid of ``torch.device``
entries. A sharded tensor is a list of per-device tensors, one per mesh
entry it spans: :func:`batch_sharding` and :func:`row_sharding` split a
tensor that way, :func:`replicated` copies it to every entry and
:func:`unshard` puts the pieces back together. A copy between two cards
goes peer to peer; a mesh may name one device more than once, and a
piece whose entry is the device it lies on is not copied at all.

Every copy between mesh entries passes one seam, :func:`record_copies`,
which the mesh audit (analysis/graftmesh.py) reads: the kind
(``split``, ``replicate``, ``gather``, or ``halo`` from the sharded
DWT), the bytes, the source entry and the destination entry. It counts
by mesh *entry*, not by device, so a mesh that repeats one device counts
what that many cards would move, copies ``.to()`` skips included. A
whole tensor lies on the first entry of its device, or on the host
(:data:`HOST`) when no entry is its device; a list of shards lies on
the entries of the axis it was split over, in order. Without a
recorder the seam does nothing.
"""
from __future__ import annotations

import numpy as np
import torch

DATA_AXIS = "data"
TILE_AXIS = "tile"
HOST = -1          # a copy's source or destination off the mesh

_COPY_RECORDER = None   # set by the mesh audit while it runs a program


def set_copy_recorder(recorder):
    """Install ``recorder(kind, moves, axis)`` on the copy seam (None
    removes it); returns the one it replaces."""
    global _COPY_RECORDER
    old, _COPY_RECORDER = _COPY_RECORDER, recorder
    return old


def record_copies(kind: str, moves, axis: str | None = None) -> None:
    """The copy seam: one collective of ``kind`` as ``moves``, (bytes,
    source entry, destination entry) each, entries being flat indices
    into the mesh's ``device_list`` or :data:`HOST`; ``axis`` is the
    mesh axis a split partitions."""
    recorder = _COPY_RECORDER
    if recorder is not None:
        recorder(kind, list(moves), axis)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _entry_of(device, devices: list) -> int:
    """The first of ``devices`` (a mesh's ``device_list``, or the
    devices of a list of shards) that is ``device``; HOST if none."""
    for i, d in enumerate(devices):
        if d == device:
            return i
    return HOST


class DeviceMesh:
    """A ``(data, tile)`` grid of torch devices of one type.
    ``devices`` is the grid (an object array), ``shape`` maps each axis
    name to its size, ``device_list`` is the grid in row-major order."""

    def __init__(self, devices: list, n_data: int, n_tile: int) -> None:
        if not devices or len(devices) != n_data * n_tile:
            raise ValueError(f"a {n_data}x{n_tile} mesh needs "
                             f"{n_data * n_tile} devices, got "
                             f"{len(devices)}")
        types = {d.type for d in devices}
        if len(types) != 1:
            raise ValueError(f"a mesh holds one device type, got "
                             f"{sorted(types)}")
        grid = np.empty(len(devices), dtype=object)
        grid[:] = devices
        self.devices = grid.reshape(n_data, n_tile)

    @property
    def shape(self) -> dict:
        n_data, n_tile = self.devices.shape
        return {DATA_AXIS: n_data, TILE_AXIS: n_tile}

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def device_list(self) -> list:
        return list(self.devices.flat)

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type


def visible_devices(device="cuda") -> list:
    """Every device of ``device``'s type this process may put a mesh
    on: each CUDA card for ``"cuda"`` (RuntimeError without one — the
    mesh never falls back to the CPU), one entry for ``"cpu"``."""
    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")]
    if kind != "cuda":
        raise ValueError(f"no mesh over {kind} devices")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError(
            "a mesh on cuda asked for, but CUDA is unavailable: this "
            "torch build or machine has no usable CUDA device (pass the "
            "devices, e.g. [\"cpu\"] * 8, to build a mesh on the host)")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(devices=None, tile_parallel: int = 1) -> DeviceMesh:
    """Build a ('data', 'tile') mesh from ``devices`` (default: every
    visible card, :func:`visible_devices`). A device may repeat.

    ``tile_parallel`` devices cooperate on one spatial shard group; the
    rest of the devices form the data axis.
    """
    devices = [torch.device(d) for d in (
        devices if devices is not None else visible_devices())]
    n = len(devices)
    if n % tile_parallel:
        raise ValueError(f"{n} devices not divisible by tile_parallel="
                         f"{tile_parallel}")
    return DeviceMesh(devices, n // tile_parallel, tile_parallel)


def _split(x: torch.Tensor, dim: int, mesh: DeviceMesh, entries: list,
           axis: str) -> list:
    n = len(entries)
    if x.shape[dim] % n:
        raise ValueError(f"axis {dim} of {x.shape[dim]} does not split "
                         f"evenly over {n} devices")
    devices = mesh.device_list
    parts = torch.chunk(x, n, dim=dim)
    src = _entry_of(x.device, devices)
    record_copies("split", [(_nbytes(p), src, e)
                            for p, e in zip(parts, entries)], axis)
    return [part.to(devices[e]) for part, e in zip(parts, entries)]


def batch_sharding(x: torch.Tensor, mesh: DeviceMesh) -> list:
    """Split a (B, ...) batch along B over the data axis: piece i on the
    first device of data row i (tiles are independent — no
    communication follows)."""
    n_data, n_tile = mesh.devices.shape
    return _split(x, 0, mesh, [i * n_tile for i in range(n_data)],
                  DATA_AXIS)


def row_sharding(x: torch.Tensor, mesh: DeviceMesh, dim: int = 0) -> list:
    """Split one giant tile's rows (axis ``dim``) over the tile axis:
    piece j on the tile axis's device j of the first data row."""
    return _split(x, dim, mesh, list(range(mesh.devices.shape[1])),
                  TILE_AXIS)


def replicated(x: torch.Tensor, mesh: DeviceMesh) -> list:
    """One full copy of ``x`` on every device of the mesh."""
    devices = mesh.device_list
    src = _entry_of(x.device, devices)
    record_copies("replicate", [(_nbytes(x), src, e)
                                for e in range(len(devices))])
    return [x.to(dev) for dev in devices]


def unshard(shards: list, dim: int = 0, device=None) -> torch.Tensor:
    """Concatenate the pieces of a split along ``dim`` on ``device``
    (default: the first piece's)."""
    device = shards[0].device if device is None else torch.device(device)
    dst = _entry_of(device, [s.device for s in shards])
    record_copies("gather", [(_nbytes(s), i, dst)
                             for i, s in enumerate(shards)])
    return torch.cat([s.to(device) for s in shards], dim=dim)
