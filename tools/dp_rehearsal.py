#!/usr/bin/env python3
"""``chip_smoke.py``'s data-parallel and real-gradient phases at smoke size
on the CPU: a rehearsal of their control flow before a card run.

    python3 tools/dp_rehearsal.py

Runs ``run_dp`` (``dp_parity``, ``dp_training`` through the launcher,
``dp_q8``) and ``phase_codecs_real`` with qwen2-0.5b's smoke config on 4
gloo CPU ranks, the sequence cut to 32, the gradient cut into 100,000-value
buckets (so that it crosses several), and the CUDA calls the phases make
replaced by host stand-ins.  The kernels do not run here: the checks of
their launches fail and are printed, every other check must pass.  The
JSON lines are the phases' own; their errors are CPU numbers at smoke size,
and their times say nothing of the card.
"""
from __future__ import annotations

import os
import sys
import time
import types

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.parallel import planner  # noqa: E402

FAILED = []


class _HostEvent:
    """``torch.cuda.Event`` on the host clock."""

    def __init__(self, **_):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return 1e3 * (other.t - self.t)


def _check(cond, msg):
    if not cond:
        print("CHECK FAILED:", msg, flush=True)
        FAILED.append(msg)


def patch() -> None:
    """Points ``chip_smoke`` at the CPU and smoke sizes (in this process;
    the ranks call it again)."""
    cs.DEVICE = "cpu"
    cs.get_config = smoke_config
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats",
                 "set_device"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.Event = _HostEvent
    cs.TRAIN_SEQ = cs.DP_PARITY_SEQ = 32
    cs.train_launches = lambda *a, **k: {}
    planner.BUCKET_VALUES = 100_000
    if isinstance(cs.launch_train, types.ModuleType):
        run = cs.launch_train.run
        cs.launch_train = types.SimpleNamespace(
            run=lambda argv: run(argv + ["--smoke", "--device", "cpu"]),
            checksum=cs.launch_train.checksum)
    cs.check = _check


def dp_parity_rank(rank, world, seed):
    patch()
    return cs.dp_parity_rank(rank, world, seed)


def dp_q8_rank(rank, world, seed):
    patch()
    return cs.dp_q8_rank(rank, world, seed)


def main() -> int:
    import dp_rehearsal as me  # the ranks import the functions by name
    patch()
    cs.dp_parity_rank, cs.dp_q8_rank = me.dp_parity_rank, me.dp_q8_rank
    cs.run_dp(cs.SEED + 10)
    cs.phase_codecs_real(cs.SEED + 9)
    launch_checks = [m for m in FAILED if "launch" in m]
    print("checks failed:", FAILED, flush=True)
    return 0 if FAILED == launch_checks else 1


if __name__ == "__main__":
    sys.exit(main())
