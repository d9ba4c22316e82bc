"""What no run may load: the JAX package this program was ported from,
and JAX itself.  Module names are compared by their top-level part (the
part before the first dot) whole, so ``jurassic_torch`` is not
``jurassic_tpu``."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "jurassic_tpu")


def loaded(modules=None) -> list[str]:
    """The loaded modules (of ``modules``, default ``sys.modules``) whose
    top-level name is one of ``FORBIDDEN``."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules) if m.split(".")[0] in FORBIDDEN)
