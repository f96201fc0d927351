"""graftlint and graftrace over the PyTorch port's host code: the JAX
package's static rules and race explorer that read no JAX program.

- **Lint engine** (``python -m bucketeer_tpu_torch.analysis``): AST rules
  for swallowed exceptions and empty packages (:mod:`rules_hygiene`),
  blocking calls in async handlers (:mod:`rules_async`), lock discipline
  and lock order (:mod:`rules_locks`, :mod:`rules_lockorder`), tracing
  hygiene (:mod:`rules_obs`), and a ``ctypes`` <-> C/C++/CUDA ABI
  cross-check of the port's hand-written bindings (:mod:`abi`).
  Suppression syntax: ``# graftlint: disable=<rule>``.
- **Race explorer** (``--race``, :mod:`graftrace`): the serving core's
  scenario suite under a controlled scheduler — data races, lock
  inversions, deadlocks and broken invariants, each with a replayable
  schedule.

The JAX package's device-region rules, donation rule, compiled-artifact
audit, cost model and mesh audit read ``jax.jit`` roots and lowered
programs, which this package has none of; they are not here.
"""
from .findings import ERROR, WARNING, Finding
from .lint import load_baseline, run_lint

__all__ = ["ERROR", "WARNING", "Finding", "load_baseline", "run_lint"]
