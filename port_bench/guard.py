"""The check that no run loads JAX or the JAX package.

Modules are compared by their whole top-level name, the part before
the first dot: the port's package name begins with the JAX package's,
and must not count as it."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "mri_nanoparticle_simulation_tpu")


def loaded(modules=None) -> list:
    """The loaded modules (``sys.modules`` by default) whose top-level
    name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
