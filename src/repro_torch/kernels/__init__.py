"""Hand-written Hopper kernels of the port, each beside its plain version.

``WRAPPERS`` maps each kernel to its public wrapper; every wrapper carries a
``launches`` count that it raises by one where it launches its kernel.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels.flash_attention import ops as _fa

WRAPPERS = {"flash_attention": _fa.flash_attention}
SOURCES = {"flash_attention": _fa.SOURCE}


def reset_launch_counts() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: w.launches for name, w in WRAPPERS.items()}
