#!/usr/bin/env python3
"""``chip_smoke.py``'s ``seq_decode`` phase at smoke size on the CPU: a
rehearsal of its control flow before a card run.

    python3 tools/seq_decode_rehearsal.py

The three cases on smoke configs and a context of 64 slots (the ring of
16), each with its dry-run job run in this process, then the phase on 4
gloo CPU ranks, the CUDA calls replaced by host stand-ins
(``tp_family_rehearsal.patch``).  The kernels do not run and the allocator
is not there: the checks of launches and of allocated bytes fail and are
printed, every other check (parity, bit-equal ranks, the bf16 bound, wire
bytes against the formula and the dry-run) must pass.  The times say
nothing of the card.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402
import tp_family_rehearsal as tpr  # noqa: E402

SLOTS, RING = 64, 16


def patch() -> None:
    tpr.patch()
    cs.nvidia_smi_card = lambda: "host CPU (rehearsal)"
    cs.SEQ_SLOTS = SLOTS
    cs.SEQ_CASES = {
        "full": (cs.ARCH, 0, (4, 1), None, SLOTS - cs.SEQ_STEPS, "seq_full"),
        "ring": (cs.ARCH, 0, (4, 1), RING, 3 * RING - 4, "seq_ring"),
        "mla": (cs.MLA_ARCH, 2, (2, 2), None, SLOTS - cs.SEQ_STEPS,
                "long_500k")}


def seq_decode_rank(*args, **kw):
    patch()  # a fresh process: its chip_smoke holds the real function
    return cs.seq_decode_rank(*args, **kw)


def main() -> int:
    import seq_decode_rehearsal as me  # the ranks import the function
    patch()
    cs.seq_decode_rank = me.seq_decode_rank
    got = {key: cs.dryrun_job(*job) for key, job in cs._dryrun_jobs().items()
           if key[0] == "seq_decode"}
    cs.phase_seq_decode(got, cs.SEED + 54)
    expected = [m for m in tpr.FAILED if "launch" in m or "cache " in m]
    print("checks failed:", tpr.FAILED, flush=True)
    return 0 if tpr.FAILED == expected else 1


if __name__ == "__main__":
    sys.exit(main())
