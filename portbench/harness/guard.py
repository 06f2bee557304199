"""The check that nothing of JAX or of the JAX package is loaded.

Module names are compared by their whole top-level name, the part before
the first dot: ``hierarchicalgnn_torch`` is the port and passes, though its
name begins with the JAX package's.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "hierarchicalgnn_tpu"})


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default: every
    module this process has loaded), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in names} & FORBIDDEN)
