"""graftmesh: the mesh audit — what the port's sharded programs move
between mesh entries.

The JAX package's graftmesh lowers and partitions each sharded program
under a forced 8-device host mesh and parses the collectives XLA
emitted. The port's mesh (``parallel/mesh.py``) has no partitioner and
no collectives: pieces are copied with ``.to(device)``. So this audit
runs each registered mesh program, under the dispatch recorder
(:mod:`deviceaudit`, for its op fingerprint and modeled cost), on a mesh
of eight entries of one device (``--audit-device``: the card unless the
caller asks for the CPU), and reads the one seam every copy between
entries passes (``parallel/mesh.py`` :func:`record_copies`): kind,
bytes, source entry and destination entry. The seam counts by mesh
*entry*, not by device, so eight entries of one card (or of the CPU)
count what eight cards would move — the copies ``.to()`` skips on a
repeated device included — and the CPU and the card count alike.

Per program and per kind it reports, as the JAX audit reports per
collective:

- ``count`` — the most collectives of that kind any one entry takes
  part in as a receiver;
- ``bytes_in`` — the most bytes any one entry receives;
- ``ici_bytes`` — the most link bytes any one entry moves (in or out,
  entry to entry), priced as the JAX model prices ring bytes:

| kind | source seam | per-device link bytes |
|---|---|---|
| ``halo`` | ``sharded_dwt._halo_pad`` (the JAX ``collective-permute``) | bytes in |
| ``gather`` | ``unshard`` (``all-gather``) | at its root, (g−1) × in |
| ``replicate`` | ``replicated`` | from its source, (g−1) × in |
| ``split`` | ``_split`` via ``batch_sharding`` / ``row_sharding`` | from the host 0, from an entry (g−1) × piece |

  with the host's copies kept apart (``h2d_bytes``, ``d2h_bytes``);
- ``peak_live_bytes`` per entry — the recorder's peak of live storages
  over the mesh's entries;
- the roofline with a link term — the recorder's cost with
  ``ici_bytes`` set, priced by ``MachineModel.ici_bandwidth``.

The per-program collective histogram and link bytes join
``.graftaudit-torch-manifest.json`` under ``"mesh_programs"`` and are
diffed like single-device drift (tolerance:
deviceaudit.COST_DRIFT_TOLERANCE). Findings over these facts live in
:mod:`rules_shard`. The JAX subprocess path (a forced XLA device count
fixed at backend init) has no counterpart: an eager mesh needs none.
"""
from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from pathlib import Path

from ..parallel.mesh import HOST
from . import deviceaudit, graftcost
from .deviceaudit import COST_DRIFT_TOLERANCE

MESH_DEVICES = 8
MESH_MANIFEST_KEY = "mesh_programs"
MESH_DRIFT = "shard-manifest-drift"

COPY_KINDS = ("halo", "gather", "replicate", "split")


@dataclass(frozen=True)
class MeshProgram:
    """One registered mesh program at one canonical mesh.

    ``build(device) -> (thunk, mesh, axes)``: makes the mesh of
    MESH_DEVICES entries of ``device`` and the program's inputs, placed
    as the program takes them (outside the audit, as the JAX entries'
    ``in_shardings`` place theirs), and returns the program's call, the
    mesh and the axes its placed inputs are split over.
    ``expected_collectives`` names the kinds the program declares (the
    DWT's halos); an undeclared ``gather`` is fair game for
    ``shard-implicit-allgather``."""
    name: str
    build: object
    expected_collectives: tuple = ()


@dataclass
class MeshFacts:
    """What one audited mesh program moved between entries."""
    name: str
    mesh_shape: dict = field(default_factory=dict)
    axes_used: tuple = ()
    expected_collectives: tuple = ()
    fingerprint: str = ""          # sha256 of the dispatched op sequence
    collectives: dict = field(default_factory=dict)
    ici_bytes: int = 0             # per-device link bytes, all kinds
    peak_live_bytes: int = 0       # per entry
    replicated_args: tuple = ()    # ((replicate call, bytes), ...)
    cost: object = None            # graftcost.CostFacts (+ ici_bytes)
    text: str = ""                 # the op histogram (for dumps)
    skipped: str = ""


class _Copies:
    """The copy seam's recorder for one program run."""

    def __init__(self) -> None:
        self.calls: list = []          # (kind, moves)
        self.axes: set = set()

    def __call__(self, kind: str, moves: list, axis) -> None:
        self.calls.append((kind, moves))
        if axis is not None and kind == "split":
            self.axes.add(axis)

    def collectives(self) -> dict:
        """{kind: {count, bytes_in, ici_bytes, h2d_bytes, d2h_bytes}}
        for every kind that moved anything."""
        out: dict = {}
        for kind in COPY_KINDS:
            recv_calls: dict = {}
            recv_bytes: dict = {}
            link_in: dict = {}
            link_out: dict = {}
            h2d = d2h = 0
            moved = False
            for k, moves in self.calls:
                if k != kind:
                    continue
                receivers = set()
                for nbytes, src, dst in moves:
                    if src == dst:
                        continue
                    moved = True
                    if src == HOST:
                        h2d += nbytes
                    elif dst == HOST:
                        d2h += nbytes
                    else:
                        link_in[dst] = link_in.get(dst, 0) + nbytes
                        link_out[src] = link_out.get(src, 0) + nbytes
                    if dst != HOST:
                        receivers.add(dst)
                        recv_bytes[dst] = recv_bytes.get(dst, 0) + nbytes
                for e in receivers:
                    recv_calls[e] = recv_calls.get(e, 0) + 1
            if not moved:
                continue
            entries = set(link_in) | set(link_out)
            out[kind] = {
                "count": max(recv_calls.values(), default=0),
                "bytes_in": max(recv_bytes.values(), default=0),
                "ici_bytes": max((max(link_in.get(e, 0),
                                      link_out.get(e, 0))
                                  for e in entries), default=0),
                "h2d_bytes": h2d, "d2h_bytes": d2h}
        return out

    def replicated(self) -> tuple:
        """((call, bytes), ...) of the replicate calls, numbered by their
        place among the program's copy-seam calls."""
        return tuple((i, moves[0][0]) for i, (k, moves)
                     in enumerate(self.calls) if k == "replicate" and moves)


def _mesh(device, tile_parallel: int = 1):
    import torch

    from ..parallel.mesh import make_mesh

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return make_mesh([dev] * MESH_DEVICES, tile_parallel=tile_parallel)


def mesh_registry() -> list:
    """The audited mesh programs: the JAX package's six entries by name
    and shape — every sharded path the port ships, on a mesh of
    MESH_DEVICES entries, at the smallest shapes that exercise the real
    program structure, with inputs made from a fixed seed."""
    import numpy as np
    import torch

    from ..codec.pipeline import _transform_batch, make_plan
    from ..kernels import fused_t1 as ft
    from ..parallel.mesh import DATA_AXIS, TILE_AXIS, batch_sharding, \
        row_sharding
    from ..parallel.sharded_dwt import _local_dwt
    from ..tensor.coeffs import run_dequant_inline

    rng = np.random.default_rng(0)

    def on(device, arr):
        return torch.as_tensor(np.ascontiguousarray(arr), device=device)

    # The device core of sharded_transform_tile: rows over the tile
    # axis, two halo copies per level; the outputs stay sharded.
    def dwt_entry(shape):
        x = rng.integers(0, 256, shape).astype(np.int32)

        def build(device):
            mesh = _mesh(device, tile_parallel=MESH_DEVICES)
            shards = row_sharding(on(mesh.device_list[0], x), mesh,
                                  dim=-2)
            return (lambda: _local_dwt(2, True, shards), mesh,
                    (TILE_AXIS,))
        return build

    entries = [
        MeshProgram("shard.dwt.tile/gray-rev-256x64-L2/T8",
                    dwt_entry((256, 64)), expected_collectives=("halo",)),
        MeshProgram("shard.dwt.tile/rgb-rev-256x64-L2/T8",
                    dwt_entry((3, 256, 64)),
                    expected_collectives=("halo",)),
    ]

    # The run_tiles_sharded path: the transform per data shard — tiles
    # are independent, so nothing crosses between entries.
    plan = make_plan(64, 64, 1, 2, True, 8)
    tiles = rng.integers(0, 256, (8, 64, 64, 1)).astype(np.int32)

    def transform_entry(device):
        mesh = _mesh(device)
        parts = batch_sharding(on(mesh.device_list[0], tiles), mesh)
        return (lambda: [_transform_batch(plan, None, p) for p in parts],
                mesh, (DATA_AXIS,))

    entries.append(MeshProgram(
        "shard.transform.data/gray8-lossless-64x64-L2/B8",
        transform_entry))

    # The fused Tier-1 per data shard, one block each (4x4 extents of
    # magnitudes < 4 at L=2, so the plain version stays short on the
    # CPU): the plain version on the CPU and the kernel on the card,
    # its cost declared by the wrapper's work() on both.
    blocks = np.zeros((8, 64, 64), np.int32)
    blocks[:, :4, :4] = rng.integers(-3, 4, (8, 4, 4))
    meta = [np.full(8, v, np.int32) for v in (2, 0, 0, 4, 4)]

    def fused_entry(device):
        mesh = _mesh(device)
        cols = [batch_sharding(on(mesh.device_list[0], a), mesh)
                for a in [blocks] + meta]
        shards = list(zip(*cols))

        def run():
            return [deviceaudit.declared_call(ft.fused_t1, ft.work, 2, 0,
                                              s) for s in shards]
        return run, mesh, (DATA_AXIS,)

    entries.append(MeshProgram("shard.cxdmq.fused.data/L2/N8",
                               fused_entry))

    # What the port runs for a sharded batch read: the merged
    # dequantizer on the pool device (tensor/coeffs.py
    # run_dequant_inline), then batches/assemble.py's placement of each
    # band's batch axis over the batch mesh.
    shapes = ((8, 1, 16, 16),) * 4 + ((8, 1, 32, 32),) * 3

    def batch_entry(reversible, deltas):
        planes = [rng.integers(-512, 512, s).astype(np.int32)
                  for s in shapes]

        def build(device):
            mesh = _mesh(device)
            dev = mesh.device_list[0]

            def run():
                bands = run_dequant_inline(reversible, deltas, planes, dev)
                return [batch_sharding(b, mesh) for b in bands]
            return run, mesh, ()
        return build

    entries += [
        MeshProgram("batch.assemble.dequant/gray-rev-L2/B8",
                    batch_entry(True, (1.0,) * 7)),
        MeshProgram("batch.assemble.dequant/gray-irrev-L2/B8",
                    batch_entry(False, (0.5,) * 7)),
    ]
    return entries


def run_mesh_program(entry: MeshProgram, device="cuda") -> MeshFacts:
    """Run one registered mesh program on a mesh of ``device`` (the
    card unless the caller asks for the CPU) under the recorder and the
    copy seam."""
    from ..parallel import mesh as mesh_mod

    facts = MeshFacts(entry.name,
                      expected_collectives=tuple(
                          entry.expected_collectives))
    thunk, mesh, axes = entry.build(device)
    copies = _Copies()
    old = mesh_mod.set_copy_recorder(copies)
    try:
        _, audit = deviceaudit.audit_call(thunk, audit_name=entry.name,
                                          audit_device=device,
                                          audit_cost=True)
    finally:
        mesh_mod.set_copy_recorder(old)
    facts.mesh_shape = dict(mesh.shape)
    facts.axes_used = tuple(sorted(set(axes) | copies.axes))
    facts.fingerprint = audit.fingerprint
    facts.collectives = copies.collectives()
    facts.ici_bytes = sum(c["ici_bytes"]
                          for c in facts.collectives.values())
    facts.replicated_args = copies.replicated()
    facts.cost = audit.cost
    facts.cost.ici_bytes = facts.ici_bytes
    facts.peak_live_bytes = -(-facts.cost.peak_live_bytes // mesh.size)
    facts.text = json.dumps(dict(sorted(audit.op_counts.items())),
                            indent=2)
    return facts


def run_mesh_programs(device="cuda", entries=None) -> list:
    """Run every registered mesh program; returns [MeshFacts]."""
    deviceaudit.device_type(device)
    return [run_mesh_program(e, device)
            for e in (mesh_registry() if entries is None else entries)]


# --- manifest -------------------------------------------------------------

def mesh_manifest_from_facts(all_facts: list) -> dict:
    """The ``"mesh_programs"`` manifest section: per program, the op
    fingerprint, mesh shape, collective histogram, link bytes and
    per-entry peak live — what the gate diffs."""
    programs = {}
    for f in all_facts:
        if f.skipped:
            continue
        entry = {
            "fingerprint": f.fingerprint,
            "mesh": dict(sorted(f.mesh_shape.items())),
            "collectives": {k: dict(v) for k, v in
                            sorted(f.collectives.items())},
            "ici_bytes": f.ici_bytes,
            "peak_live_bytes": f.peak_live_bytes,
        }
        if f.cost is not None:
            entry["cost"] = f.cost.manifest_entry()
        programs[f.name] = entry
    return programs


def diff_mesh_manifest(old: dict | None, new_programs: dict,
                       skipped=(), device: str = "cpu") -> list:
    """Drift lines between the checked-in manifest's mesh section (as
    ``device``'s type sees it, deviceaudit.section) and a fresh run
    (empty = no drift). Programs named in ``skipped`` are tolerated
    missing; link bytes or per-entry peak live moving beyond
    COST_DRIFT_TOLERANCE, a changed collective histogram and a changed
    fingerprint all fail — a change that doubles a program's link
    traffic dies here with no card run, while jitter under the
    tolerance passes."""
    olds, _ = deviceaudit.section(old, device, MESH_MANIFEST_KEY)
    if olds is None:
        return [f"no checked-in mesh section: {len(new_programs)} "
                "mesh program(s) unaccounted — regenerate with "
                "--mesh-audit --write-manifest and commit it"]
    lines = []
    for name in sorted(set(olds) - set(new_programs) - set(skipped)):
        lines.append(f"{name}: in the mesh manifest but no longer run "
                     "(registry entry removed?)")
    for name in sorted(set(new_programs) - set(olds)):
        lines.append(f"{name}: run but absent from the mesh manifest "
                     "(new mesh program — regenerate the manifest)")
    for name in sorted(set(new_programs) & set(olds)):
        o, n = olds[name], new_programs[name]
        frags = []
        for key in ("ici_bytes", "peak_live_bytes"):
            a, b = o.get(key, 0), n.get(key, 0)
            if a == b:
                continue
            rel = (b - a) / max(abs(a), 1)
            if abs(rel) > COST_DRIFT_TOLERANCE:
                frags.append(f"{key} {a:g} -> {b:g} ({rel:+.0%})")
        for kind in sorted(set(o.get("collectives", {}))
                           | set(n.get("collectives", {}))):
            a = o.get("collectives", {}).get(kind, {}).get("bytes_in", 0)
            b = n.get("collectives", {}).get(kind, {}).get("bytes_in", 0)
            rel = (b - a) / max(abs(a), 1)
            if a != b and abs(rel) > COST_DRIFT_TOLERANCE:
                frags.append(f"{kind} bytes_in {a:g} -> {b:g} "
                             f"({rel:+.0%})")
        if frags:
            lines.append(
                f"{name}: modeled mesh cost drifted beyond "
                f"{COST_DRIFT_TOLERANCE:.0%} ({'; '.join(frags)}) — "
                "a change in what crosses between mesh entries; if "
                "intentional, regenerate with --mesh-audit "
                "--write-manifest and justify the new traffic in "
                "review")
            continue
        oc = {k: v.get("count", 0)
              for k, v in o.get("collectives", {}).items()}
        nc = {k: v.get("count", 0)
              for k, v in n.get("collectives", {}).items()}
        if oc != nc:
            deltas = [f"{k} {oc.get(k, 0)}->{nc.get(k, 0)}"
                      for k in sorted(set(oc) | set(nc))
                      if oc.get(k, 0) != nc.get(k, 0)]
            lines.append(f"{name}: collective histogram drifted "
                         f"({'; '.join(deltas)}) — the program now "
                         "copies differently between mesh entries")
            continue
        if o.get("fingerprint") != n["fingerprint"]:
            lines.append(f"{name}: mesh program drifted (fingerprint "
                         "changed; collective histogram and modeled "
                         "mesh cost within tolerance)")
    return lines


def render_mesh_line(facts: MeshFacts,
                     machine: graftcost.MachineModel) -> str:
    """One human line per audited mesh program for the CLI output."""
    n_coll = sum(c["count"] for c in facts.collectives.values())
    mesh = "x".join(str(v) for _, v in sorted(facts.mesh_shape.items()))
    kinds = ", ".join(f"{k} {c['bytes_in']} B in / {c['ici_bytes']} B "
                      "link" for k, c in sorted(facts.collectives.items()))
    head = (f"{facts.name} [mesh {mesh}]: {n_coll} collective(s)"
            f"{' (' + kinds + ')' if kinds else ''}, "
            f"{facts.ici_bytes / 1e6:.3g} MB link/device, peak-live "
            f"{facts.peak_live_bytes / 1e6:.3g} MB/device")
    if facts.cost is None:
        return head
    roof = facts.cost.roofline(machine)
    return (head + f", {roof['bound']}-bound ({machine.name}: "
            f"{roof['time_s'] * 1e6:.3g} us)")


def dump_mesh(dump_dir, all_facts: list) -> None:
    """Write each mesh program's op histogram and copies to
    ``dump_dir``."""
    dump = Path(dump_dir)
    dump.mkdir(parents=True, exist_ok=True)
    for f in all_facts:
        safe = re.sub(r"[^\w.\-]", "_", f.name)
        (dump / f"{safe}.mesh.json").write_text(json.dumps({
            "name": f.name, "collectives": f.collectives,
            "op_counts": json.loads(f.text or "{}")}, indent=2) + "\n",
            encoding="utf-8")
