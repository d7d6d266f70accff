"""Caps torch's intra-op threads in a port test process that shares the
host's cores with other pytest-xdist workers.

Every ``tests/test_torch_*.py`` imports this module first.  Under ``-n N``
each of the N workers would otherwise start torch's default pool of one
OpenMP thread a core, so N pools spin-wait over the same cores (the
smoke qwen2's 40-step learning test on an 8-CPU host: 4.75 s alone, over
150 s in each of six copies at once, 7.2 s each at one thread).  The cap gives each worker
its share of the cores, ``max(1, cpu_count // N)``.  A run without xdist
(or with one worker) is left as it is, and so is the card's machine,
where the cuda tests run in one process.  The library itself sets no
threads: that is its users' choice.
"""
from __future__ import annotations

import os

import torch


def cap_threads() -> int | None:
    """Set torch's intra-op (and, where still allowed, inter-op) threads to
    this worker's share of the cores; returns the cap, or None when the
    process runs alone and is left untouched."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 1)
    if workers <= 1:
        return None
    cap = max(1, (os.cpu_count() or 1) // workers)
    torch.set_num_threads(cap)
    try:
        torch.set_num_interop_threads(cap)
    except RuntimeError:  # the inter-op pool has started or was set before
        pass
    return cap


CAP = cap_threads()
