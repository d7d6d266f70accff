#!/usr/bin/env python3
"""``chip_smoke.py``'s model-axis phases at smoke size on the CPU: a
rehearsal of their control flow before a card run.

    python3 tools/tp_family_rehearsal.py [ep] [tp] [families] [whole_heads]

Runs, with each architecture's smoke config on 4 gloo CPU ranks and the
CUDA calls the phases make replaced by host stand-ins: ``run_ep``
(``ep_parity``, ``ep_serving`` with the G2 bound and its planted fault,
``ep_ws_decode``, ``ep_training``; dbrx-132b, its attention and vocabulary
split beside the experts), ``run_tp`` (granite-3-8b and mamba2-130m: TP
parity, serving, training, collective matmul and the pipelines; the
training sequence and the pipeline's microbatch cut) and
``run_tp_families`` (``tp_mla``, ``tp_cross``, ``tp_encdec``), and
``phase_tp_mamba_whole_heads`` (mamba2-130m's smoke config with SSM heads
of 256 on (1, 4): 2 heads kept whole, 128 ``conv_x`` channels a rank, as
tp 16 does at full size); by default all four.  The kernels do not run
here: the checks of their launches fail and are printed, every other
check (parity, wire bytes against their formulas, tokens) must pass.
The JSON lines are the phases' own; their errors are CPU numbers at smoke
size, and their times say nothing of the card.
"""
from __future__ import annotations

import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import dataclasses  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402

FAILED = []
RANK_FUNCTIONS = ("ep_parity_rank", "ep_serving_rank", "ep_ws_rank",
                  "ep_training_rank", "tp_parity_rank", "tp_serving_rank",
                  "tp_mamba_rank", "tp_training_rank",
                  "tp_cmm_pipeline_rank", "tpf_rank", "wh_rank")


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
    for name in ("max_memory_allocated", "max_memory_reserved",
                 "memory_allocated", "memory_reserved"):
        setattr(torch.cuda, name, lambda *a, **k: 0)
    torch.cuda.Event = _HostEvent
    cs.TP_TRAIN_SEQ = 32
    cs.PIPE_MB_SHAPE = (1, 32)
    cs.check = _check
    cs.nvidia_smi_card = lambda: "host CPU, no card"
    cs.WH_RANKS = 4
    cs._wh_config = lambda: dataclasses.replace(
        smoke_config(cs.SSM_ARCH), ssm_head_dim=256, num_layers=cs.WH_LAYERS)


def _wrap(name):
    def rank_fn(*args, **kw):
        patch()  # a fresh process: its chip_smoke holds the real function
        return getattr(cs, name)(*args, **kw)
    rank_fn.__name__ = rank_fn.__qualname__ = name  # pickled by name
    return rank_fn


for _name in RANK_FUNCTIONS:
    globals()[_name] = _wrap(_name)


def main() -> int:
    import tp_family_rehearsal as me  # the ranks import the functions
    patch()
    for name in RANK_FUNCTIONS:
        setattr(cs, name, getattr(me, name))
    parts = sys.argv[1:] or ["ep", "tp", "families", "whole_heads"]
    rng = np.random.default_rng(cs.SEED)
    if "ep" in parts:
        cs.run_ep(rng, cs.SEED + 12)
    if "tp" in parts:
        cs.run_tp(rng, cs.SEED + 20)
    if "families" in parts:
        cs.run_tp_families(rng, cs.SEED + 40)
    if "whole_heads" in parts:
        cs.phase_tp_mamba_whole_heads(cs.SEED + 56)
    launch_checks = [m for m in FAILED if "launch" in m]
    print("checks failed:", FAILED, flush=True)
    return 0 if FAILED == launch_checks else 1


if __name__ == "__main__":
    sys.exit(main())
