"""Performance lint rules over graftcost's modeled program facts — the
JAX package's three rules, thresholds and messages, copied verbatim and
run over the port's facts (:mod:`graftcost`).

The rules fire on anti-patterns in what the programs do, not in their
source: the model sees what the Python cannot — serial chains, launch
counts, modeled intensity. Today's known offenders are carried in
``.graftlint-torch-baseline.json`` (the same baseline the AST rules use,
with the same staleness hygiene), so the build stays green while the
debt stays visible: a *new* program joining the offender list fails
``--strict``, and a *fixed* offender leaves a stale baseline entry that
itself fails ``--strict`` until pruned.

| rule | fires when |
|---|---|
| ``perf-scan-per-element`` | a program's longest serial chain
  (``max_trip``) reaches one step per stripe column of a single pass
  (1024 for 64x64 blocks). For a hand-written Tier-1 kernel the chain is
  the decisions of its longest block, declared by its ``work()``. |
| ``perf-hbm-roundtrip`` | a declared program chain ships a large
  intermediate through device memory — produced by one program,
  reconsumed by the next. ``CHAINS`` is empty, as in the JAX package:
  the fused Tier-1 kernel keeps the symbol buffer on chip. |
| ``perf-low-intensity-kernel`` | a hand-written kernel's program (the
  registry keeps the JAX names, so ``.pallas`` in a name marks it)
  models below the intensity threshold (flop/byte) — memory-bound by
  construction. |

All three are warnings: they are debt, not bugs — but ``--cost
--strict`` fails on unbaselined debt.
"""
from __future__ import annotations

from .findings import WARNING, Finding
from .graftcost import CostFacts, MachineModel

SCAN_PER_ELEMENT = "perf-scan-per-element"
HBM_ROUNDTRIP = "perf-hbm-roundtrip"
LOW_INTENSITY = "perf-low-intensity-kernel"

# One step per stripe column of one pass over a 64x64 block
# (16 stripes x 64 columns) is the coarsest acceptable sequential
# granularity; trips at or beyond it scale with coefficients/symbols.
SCAN_TRIP_THRESHOLD = 1024

# An inter-program intermediate below this never matters.
ROUNDTRIP_MIN_BYTES = 8192

# Below this modeled flop/byte a hand-written kernel is memory-bound on
# every machine model shipped (both ridges sit above it).
LOW_INTENSITY_THRESHOLD = 1.0

# Declared program chains (source family -> dest family, what travels):
# the audit models each program alone; these name the HBM hand-offs
# between them. Keyed by registry-name family (text before the first
# "/"), so bucket suffixes don't matter. Empty, as in the JAX package:
# the (N, max_syms) uint8 symbol buffer between the CX/D scan and the
# MQ coder stays in shared memory inside the fused kernel
# (csrc/fused_t1.cu; registry entries cxdmq.fused*).
CHAINS = ()


def _loc(name: str) -> str:
    return f"<graftcost:{name}>"


def run(costs: list, machine: MachineModel) -> list:
    """Findings over a list of :class:`CostFacts` (one per lowered
    registry program). Pure — no lowering, no device."""
    findings = []
    by_family: dict = {}
    for c in costs:
        if not isinstance(c, CostFacts):
            continue
        by_family.setdefault(c.name.split("/")[0], c)

        if c.max_trip >= SCAN_TRIP_THRESHOLD:
            findings.append(Finding(
                SCAN_PER_ELEMENT, _loc(c.name), 0,
                f"sequential scan with {c.max_trip} trips (total scan "
                f"depth {c.scan_depth}) — at or beyond one step per "
                f"stripe column per pass ({SCAN_TRIP_THRESHOLD}), the "
                "trip count scales with coefficients/symbols rather "
                "than stripe columns; vectorize the step (process a "
                "stripe column per trip) to cut the modeled "
                "sequential floor", WARNING))

        if ".pallas" in c.name \
                and c.intensity < LOW_INTENSITY_THRESHOLD:
            findings.append(Finding(
                LOW_INTENSITY, _loc(c.name), 0,
                f"Pallas program models {c.intensity:.3f} flop/byte "
                f"(< {LOW_INTENSITY_THRESHOLD}, {machine.name} ridge "
                f"{machine.ridge():.1f}) — memory-bound by "
                "construction; shrink its traffic (fuse the chain, "
                "keep state VMEM-resident) before tuning compute",
                WARNING))

    for src, dst, what in CHAINS:
        s, d = by_family.get(src), by_family.get(dst)
        if s is None or d is None:
            continue
        # The hand-off buffer is the chain's dominant output — use its
        # own size, not the sum over every auxiliary result.
        hand_off = max(s.output_sizes, default=s.output_bytes)
        if hand_off >= ROUNDTRIP_MIN_BYTES:
            findings.append(Finding(
                HBM_ROUNDTRIP, _loc(f"{s.name} -> {d.name}"), 0,
                f"{what} ({hand_off} bytes at the audit bucket) "
                f"round-trips HBM between '{src}' and '{dst}' — "
                "produced by one program and reconsumed by the next; "
                "fusing the chain keeps it on-chip and removes "
                f"{hand_off} bytes of traffic per launch each way",
                WARNING))
    return findings
