#!/usr/bin/env python3
"""``chip_smoke.py``'s planning phases alone on the card.

    python3 tools/codesign_phases.py [mla]

Builds the kernels (``phase_build``), then runs ``phase_planner`` (qwen2-0.5b's
DP-4 plan through ``codesign.plan_iteration`` and one 64 MiB bucket through
every executable on 4 gloo ranks) and ``phase_codesign`` (the co-design
engine on the host, ``obs.probe`` over every executable all-reduce on 4
ranks); with ``mla``, also ``tp_mla`` (deepseek-v2-236b on a (1, 4) model
axis, its parity checked at router near-ties against the single-card run
re-made with the ranks' experts).  Prints the card's name and power limit
first, each phase's JSON lines and seconds; about 80 s of command with
``mla``, 22 s of it the build.
"""
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("codesign_phases: needs the card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phases = [("build", cs.phase_build),
              ("planner", lambda: cs.phase_planner(cs.SEED + 11)),
              ("codesign", lambda: cs.phase_codesign(cs.SEED + 13))]
    if "mla" in sys.argv[1:]:
        phases.append(("tp_mla", lambda: (cs._release(), cs.phase_tp_family(
            "tp_mla", np.random.default_rng(cs.SEED), cs.SEED + 40))))
    for name, run in phases:
        t0 = time.perf_counter()
        run()
        print(f"{name}_s {time.perf_counter() - t0}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
