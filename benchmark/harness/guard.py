"""The modules a run must not load: JAX, and the JAX package the port was
made from. Names are compared whole at their top level, so the port
(``ndr_tpu_torch``) is not the JAX package (``ndr_tpu``)."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "ndr_tpu")


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
