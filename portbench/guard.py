"""The benchmark's process may not hold JAX or the JAX package: the check
compares each loaded module's top-level name (the part before the first
dot) whole, so the port, whose name begins with the JAX package's, passes."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "grail")


class ForbiddenImport(RuntimeError):
    def __init__(self, names):
        super().__init__("forbidden modules loaded: " + ", ".join(names))
        self.names = names


def forbidden_modules(modules=None):
    """The sorted top-level names in `modules` (sys.modules) that are forbidden."""
    mods = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in mods} & set(FORBIDDEN))
