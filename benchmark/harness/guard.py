"""The import guard: nothing a run loads may be JAX or the JAX package.

Names are compared by their top-level module, whole: the port's own
``bucketeer_tpu_torch`` starts with the JAX package's name and is not
it."""
from __future__ import annotations

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "bucketeer_tpu"})


def jax_modules(modules) -> list:
    """The loaded module names whose top-level name is forbidden."""
    return sorted(name for name in modules
                  if name.split(".", 1)[0] in FORBIDDEN)
