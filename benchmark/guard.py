"""What a run must not load: JAX and the JAX package."""

from __future__ import annotations

import sys

# compared with each loaded module's top-level name, whole: the program's
# own package, overiva_tpu_torch, begins with the JAX package's name
FORBIDDEN = ("jax", "jaxlib", "flax", "overiva_tpu")


def forbidden_loaded(modules=None) -> list[str]:
    """The loaded modules whose top-level name is in :data:`FORBIDDEN`."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
