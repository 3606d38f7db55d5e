"""Which modules a run must not load: JAX, and the JAX package the port
was made from. Names are compared by their top-level part as a whole, since
the port's name (``hairci_torch``) begins with the JAX package's."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "hairci", "chip_smoke")


def forbidden(modules: Iterable[str] | None = None) -> List[str]:
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})
