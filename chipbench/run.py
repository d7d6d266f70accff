"""The benchmark of ``repro_torch``: training throughput on one card and
across four.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` from the root of a checkout: set-up
(weights from the seed, the step built, its first three steps), a window
of ``--seconds`` on the host clock, and the comparison with the plain
reference that decides ``correct``.  The last line of standard output is
one JSON object: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics read from a profiled stretch of the
window.  The numbers compared with the reference, each beside its limit,
are the last lines of standard error and the result's last key.

It needs as many CUDA cards as the cell asks for, and exits with another
code than 0, printing no result, where there are fewer, or where anything
it ran imported JAX or the JAX package.  Kernel and compiler caches stay
in ``build/`` inside the checkout.
"""
from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT / "src")]
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = str(ROOT / "build" / "chipbench" / _sub)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def step_summary(ranks) -> str:
    """The window's step times (ms, the slowest rank's): least, median and
    most, and each step slower than 1.5 times the median with its index,
    time and slowest rank."""
    import statistics
    steps = [max(range(len(ranks)), key=lambda r: ranks[r]["step_ms"][i])
             for i in range(len(ranks[0]["step_ms"]))]
    ms = [ranks[r]["step_ms"][i] for i, r in enumerate(steps)]
    med = statistics.median(ms)
    slow = [f"{i}:{ms[i]:.1f}@{r}" for i, r in enumerate(steps)
            if ms[i] > 1.5 * med]
    return (f"step_ms min {min(ms):.2f} p50 {med:.2f} max {max(ms):.2f}; "
            f"{len(slow)} over 1.5x p50 (step:ms@rank, the first 20) "
            f"{' '.join(slow[:20])}")


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from cb.guard import forbidden_modules
    from cb.spec import find_cell
    cell = find_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from cb.train_cell import run_cell
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), T0)
    bad = sorted(set(res["modules"]) | set(forbidden_modules()))
    if bad:
        print(f"the run imported {bad}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    line = res["line"]
    print(step_summary(res["ranks"]), file=sys.stderr)
    print(f"reference_s {res['reference_s']!r}", file=sys.stderr)
    for name, v in res["not_compared"].items():
        print(f"{name} {v!r} (not compared)", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
