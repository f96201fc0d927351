"""graftlint, the dispatch audit and graftrace over the PyTorch port.

- **Lint engine** (``python -m bucketeer_tpu_torch.analysis``): AST rules
  for swallowed exceptions and empty packages (:mod:`rules_hygiene`),
  blocking calls in async handlers (:mod:`rules_async`), lock discipline
  and lock order (:mod:`rules_locks`, :mod:`rules_lockorder`), tracing
  hygiene (:mod:`rules_obs`), host syncs, float64 and stray
  device-to-host copies in the device region (:mod:`rules_torch`), and a
  ``ctypes`` <-> C/C++/CUDA ABI cross-check of the port's hand-written
  bindings (:mod:`abi`). Suppression syntax:
  ``# graftlint: disable=<rule>``.
- **Dispatch audit** (``--audit``, :mod:`deviceaudit`): the registered
  device programs run on the card (``--audit-device cpu`` asks for the
  host) under a recorder of their aten ops — float64, host syncs and
  device-to-host copies, each by package function.
- **Runtime contracts** (:mod:`contracts`): shape/dtype checks on the
  codec entry points, on under tests or ``BUCKETEER_CONTRACTS=1``.
- **Kernel-build sentinel** (:mod:`retrace`): native library compiles
  per library, on ``/metrics`` as ``retrace.<library>``.
- **Cost model** (``--cost``, :mod:`graftcost`, rules in
  :mod:`rules_perf`): each registered program's flops, device-memory
  bytes and launches counted op by op on the dispatch recorder (a
  hand-written kernel's declared by its wrapper's ``work()``), rooflined
  on an ``h100`` or ``cpu`` model, with a checked-in manifest
  (``.graftaudit-torch-manifest.json``) that ``--audit`` diffs.
- **Mesh audit** (``--mesh-audit``, :mod:`graftmesh`, rules in
  :mod:`rules_shard`): what the mesh programs copy between entries, read
  at the copy seam of ``parallel/mesh.py``.
- **Race explorer** (``--race``, :mod:`graftrace`): the serving core's
  scenario suite under a controlled scheduler — data races, lock
  inversions, deadlocks and broken invariants, each with a replayable
  schedule.

The JAX package's donation rule has no eager counterpart (nothing is
donated); its StableHLO and partitioned-HLO parsers have none either:
the recorder and the copy seam take their place.
"""
from .findings import ERROR, WARNING, Finding
from .lint import load_baseline, run_lint

__all__ = ["ERROR", "WARNING", "Finding", "load_baseline", "run_lint"]
