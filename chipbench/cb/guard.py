"""The run's own check that nothing it ran loaded JAX or the JAX package:
the top-level name of every module in ``sys.modules`` (the part before
the first dot), compared whole, so that ``repro_torch`` passes and
``repro`` does not."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names}
                  & FORBIDDEN)
