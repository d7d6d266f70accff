#!/usr/bin/env python3
"""``chip_smoke.py``'s phases of the dry-run and FSDP (``dryrun``,
``dryrun_card``, ``fsdp``) at smoke size on the CPU: a rehearsal of their
control flow before a card run.

    python3 tools/dryrun_rehearsal.py [--sweep ARCH ...]

Runs ``tp_serving``, ``tp_training`` (which ``dryrun_card`` and ``fsdp``
read) and ``dp_parity`` (its FSDP mode), the dry-run's pool beside
``causal_skip`` (the
card's predictions on smoke configs; the production sweep only for the
archs named, by default none: it takes minutes of host a config), then
``dryrun_card`` and ``fsdp``, with each smoke config on gloo CPU ranks and
the CUDA calls replaced by host stand-ins.  The kernels do not run and the
allocator is not there: the checks of launches and of allocated bytes
fail and are printed, every other check (wire bytes against the dry-run
and the formulas, FSDP against ZeRO-1, causal_skip) must pass.  The times
say nothing of the card.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
import tp_family_rehearsal as tpr  # noqa: E402

RANK_FUNCTIONS = ("tp_serving_rank", "tp_training_rank", "dp_parity_rank",
                  "fsdp_rank")


def _wrap(name):
    def rank_fn(*args, **kw):
        patch()  # a fresh process: its chip_smoke holds the real function
        return getattr(cs, name)(*args, **kw)
    rank_fn.__name__ = rank_fn.__qualname__ = name  # pickled by name
    return rank_fn


def patch() -> None:
    tpr.patch()
    cs.FSDP_SEQ = cs.TP_TRAIN_SEQ = 32
    cs.DP_PARITY_SEQ = 32
    cs.SKIP_SHAPE = (1, 2304)  # above 2048^2: the chunked path
    cs.CARD_SHAPES = {k: cs.ShapeConfig(v.name, 32, v.global_batch, v.kind)
                      for k, v in cs.CARD_SHAPES.items()}


for _name in RANK_FUNCTIONS:
    globals()[_name] = _wrap(_name)


def main() -> int:
    import dryrun_rehearsal as me  # the ranks import the functions
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", nargs="*", default=[])
    args = ap.parse_args()
    patch()
    for name in RANK_FUNCTIONS:
        setattr(cs, name, getattr(me, name))
    jobs = cs._dryrun_jobs
    cs._dryrun_jobs = lambda: {k: v for k, v in jobs().items()
                               if k[0] != "sweep" and k[0] != "extrapolate"
                               or k[1] in args.sweep}
    cs.DRYRUN_FAMILIES = tuple(a for a in cs.DRYRUN_FAMILIES
                               if a in args.sweep)
    rng = np.random.default_rng(cs.SEED)
    cs.phase_tp_serving(rng, cs.SEED + 20)
    cs.phase_tp_training(cs.SEED + 20)
    cs.phase_dp_parity(cs.SEED + 10)
    pool = cs.start_dryrun()
    cs.phase_causal_skip(cs.SEED + 52)
    got = cs.phase_dryrun(*pool)
    cs.phase_dryrun_card(got, cs.SEED + 50)
    cs.phase_fsdp(got, cs.SEED + 51)
    expected = [m for m in tpr.FAILED if "launch" in m or "allocated" in m
                or "faster than" in m]
    print("checks failed:", tpr.FAILED, flush=True)
    return 0 if tpr.FAILED == expected else 1


if __name__ == "__main__":
    sys.exit(main())
