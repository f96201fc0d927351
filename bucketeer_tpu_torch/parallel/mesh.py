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
"""
from __future__ import annotations

import numpy as np
import torch

DATA_AXIS = "data"
TILE_AXIS = "tile"


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


def _split(x: torch.Tensor, dim: int, devices: list) -> list:
    n = len(devices)
    if x.shape[dim] % n:
        raise ValueError(f"axis {dim} of {x.shape[dim]} does not split "
                         f"evenly over {n} devices")
    return [part.to(dev) for part, dev in
            zip(torch.chunk(x, n, dim=dim), devices)]


def batch_sharding(x: torch.Tensor, mesh: DeviceMesh) -> list:
    """Split a (B, ...) batch along B over the data axis: piece i on the
    first device of data row i (tiles are independent — no
    communication follows)."""
    return _split(x, 0, list(mesh.devices[:, 0]))


def row_sharding(x: torch.Tensor, mesh: DeviceMesh, dim: int = 0) -> list:
    """Split one giant tile's rows (axis ``dim``) over the tile axis:
    piece j on the tile axis's device j of the first data row."""
    return _split(x, dim, list(mesh.devices[0, :]))


def replicated(x: torch.Tensor, mesh: DeviceMesh) -> list:
    """One full copy of ``x`` on every device of the mesh."""
    return [x.to(dev) for dev in mesh.device_list]


def unshard(shards: list, dim: int = 0, device=None) -> torch.Tensor:
    """Concatenate the pieces of a split along ``dim`` on ``device``
    (default: the first piece's)."""
    device = shards[0].device if device is None else device
    return torch.cat([s.to(device) for s in shards], dim=dim)
