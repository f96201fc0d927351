"""Sharding lint rules over graftmesh's mesh-program facts — the JAX
package's three rules, thresholds and messages over what the port's
mesh programs copy between entries (the copy seam of
``parallel/mesh.py``). Offenders would be carried in
``.graftlint-torch-baseline.json`` with full staleness hygiene (the
``shard-`` prefix gets the same only-judged-when-run exemption
``perf-`` has): a new offender fails ``--mesh-audit --strict``, a fixed
one fails via its stale baseline entry until pruned.

| rule | fires when |
|---|---|
| ``shard-implicit-allgather`` | a ``gather`` (``unshard``) the
  program never declares (not in the registry entry's
  ``expected_collectives``) moving at least ``ALLGATHER_MIN_BYTES`` of
  link bytes per device — a large array pulled onto one entry that
  nobody planned. |
| ``shard-replicated-large`` | a ``replicate`` (``replicated``) of at
  least ``REPLICATED_MIN_BYTES`` — every entry holds the full array, so
  per-device memory pays the global size. |
| ``shard-axis-dead`` | a mesh axis with more than one entry that no
  split of the program (its placed inputs' or its own
  ``batch_sharding`` / ``row_sharding``) partitions — entries assigned
  to an axis that partitions nothing sit idle for the launch. |

All three are warnings, but ``--mesh-audit --strict`` fails on
unbaselined offenders. The messages are the JAX package's, word for
word.
"""
from __future__ import annotations

from .findings import WARNING, Finding

SHARD_IMPLICIT_ALLGATHER = "shard-implicit-allgather"
SHARD_REPLICATED_LARGE = "shard-replicated-large"
SHARD_AXIS_DEAD = "shard-axis-dead"

# An undeclared gather below 1 MiB/device never dominates a launch;
# above it the resharding is real ICI traffic somebody didn't plan.
ALLGATHER_MIN_BYTES = 1 << 20

# A replicated operand at/above 64 MiB costs every device the global
# array — the "replicated 100 MB tile batch" failure mode.
REPLICATED_MIN_BYTES = 64 << 20

# The port's copy seam names the JAX all-gather "gather" (an unshard of
# a split onto one entry).
GATHER = "gather"


def _loc(name: str) -> str:
    return f"<graftmesh:{name}>"


def run(all_facts: list) -> list:
    """Findings over a list of :class:`graftmesh.MeshFacts` (one per
    audited mesh program). Pure — no run, no device."""
    findings = []
    for f in all_facts:
        if getattr(f, "skipped", ""):
            continue

        for kind, cell in sorted(f.collectives.items()):
            if kind != GATHER or kind in f.expected_collectives:
                continue
            if cell["ici_bytes"] < ALLGATHER_MIN_BYTES:
                continue
            findings.append(Finding(
                SHARD_IMPLICIT_ALLGATHER, _loc(f.name), 0,
                f"partitioner-inserted all-gather ({cell['count']} "
                f"instruction(s), {cell['ici_bytes']} modeled ICI "
                "bytes/device) that the program never declares — a "
                "sharding-constraint mismatch is resharding a large "
                "array over the interconnect; align the constraint "
                "with the operand's sharding or declare the gather "
                "in the registry entry", WARNING))

        for argnum, nbytes in f.replicated_args:
            if nbytes < REPLICATED_MIN_BYTES:
                continue
            findings.append(Finding(
                SHARD_REPLICATED_LARGE, _loc(f.name), 0,
                f"operand {argnum} is replicated at {nbytes} bytes "
                "per device — every device holds the full array, so "
                "per-device HBM pays the global size; shard it over "
                "a mesh axis or shrink it below the threshold",
                WARNING))

        for axis, size in sorted(f.mesh_shape.items()):
            if size > 1 and axis not in f.axes_used:
                findings.append(Finding(
                    SHARD_AXIS_DEAD, _loc(f.name), 0,
                    f"mesh axis '{axis}' ({size} devices) partitions "
                    "nothing in this program's declared shardings — "
                    f"{size - 1}/{size} of the axis sits idle for "
                    "the launch; fold the axis into one that is used "
                    "or shard an operand over it", WARNING))
    return findings
