"""graftrace: deterministic interleaving explorer + happens-before race
detector for the serving core.

Two cooperating halves:

- **Controlled scheduler** (:mod:`runtime`): instrumented drop-ins for
  ``threading.Lock``/``RLock``/``Condition``/``Event`` plus explicit
  field-access yield points, installed through the production seams in
  :mod:`seam` (zero-overhead no-ops until a runtime is installed). When
  active, every instrumented thread is serialized and the scheduler
  decides, at each yield point, which thread runs next — CHESS-style
  systematic exploration with bounded preemptions, or a seeded-random
  walk. Any schedule replays bit-for-bit from its decision trace, and a
  run where every thread blocks is reported as a deadlock with all
  stacks instead of hanging.
- **Race detector** (:mod:`detector`): a vector-clock happens-before
  checker over the instrumented shared-field accesses, reporting data
  races (both stack traces, locks held on each side) and
  lock-inversion cycles from the dynamic lock-acquisition-order graph.
  :mod:`crosscheck` validates the dynamic verdicts against the static
  ``rules_locks`` field inference — each analysis audits the other.

Entry points: ``python -m bucketeer_tpu.analysis --race`` (see
:mod:`explore` for budgets and trace replay) and the scenario suite in
:mod:`scenarios` covering merged-batch encode, read-vs-batch priority,
QueueFull/deadline expiry, cache eviction and scheduler shutdown/drain.
"""
from .seam import active, install

__all__ = ["active", "install"]
