#!/usr/bin/env python3
"""Whether a CUDA graph's first capture replays slower than a second one,
inside ``chip_smoke.py``'s compression-kernel phase (K2a, K2b, K3, K4 and
their library yardsticks at qwen2-0.5b's gradient).

    python3 tools/graph_capture_check.py

Runs ``chip_smoke.phase_compress_kernels`` with its ``graph_ms`` replaced
by two captures of the same calls, each replayed and timed on its own
(``chip_smoke.graph_capture_ms``), and prints one JSON line per timing in
the phase's order: the call timed (the names its lambda uses, and its
line in ``chip_smoke.py``), the first and the second capture's ms a
call, and the memory the allocator held and reserved; then the card's
name and power limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("graph_capture_check: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs._build.build(list(cs.SOURCES.values()))
    pairs = []

    def twice(fn, iters):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        first = cs.graph_capture_ms(fn, iters)
        second = cs.graph_capture_ms(fn, iters)
        pairs.append({"call": ".".join(fn.__code__.co_names),
                      "chip_smoke_line": fn.__code__.co_firstlineno,
                      "first_ms": first, "second_ms": second,
                      "allocated_mib": torch.cuda.memory_allocated() >> 20,
                      "reserved_mib": torch.cuda.memory_reserved() >> 20})
        return second

    cs.graph_ms = twice
    cs.phase_compress_kernels(cs.gradient_values())
    for i, pair in enumerate(pairs):
        print(json.dumps({"graph": i, **pair}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi.splitlines()[0]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
