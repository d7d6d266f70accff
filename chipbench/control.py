"""The readings that the limits of ``correct`` are set from (not run by the
benchmark's runs).

    python3 chipbench/control.py --workload <cell> --seeds <n> ... \
        [--program] [--variants fp8 half_batch local_grad]

For each seed, in one process (or one spawn of the cell's ranks):

- ``--program``: the program's set-up steps (as a run makes them, with no
  window) and the f32 reference: the sound runs' numbers, the lower
  readings; with ``--fault`` one of ``cb.train_cell.plant``'s faults
  planted in the program first;
- ``--variants``: the reference put in the program's place, against the
  f32 reference on the same seed: ``fp8`` the control (the reference one
  step of precision down, ``reference.decoder.Precision("fp8")``),
  ``half_batch``, ``local_grad`` and ``altered`` the faults a training
  cell can have (half of the batch left out; the exchange between the
  data ranks left out, rank 0's rows alone; the loss altered by 5% where
  it is produced).  These need one card whatever the cell
  asks for: the reference is one device's.

Each reading is a JSON line on standard output and in
``build/chipbench/control-<cell>.jsonl``.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT / "src")]


def reference_run(cell, seed: int, dev, prec: str = "f32",
                  fault=None) -> dict:
    import torch
    from repro_torch.core.types import ModelConfig
    from repro_torch.models.transformer import init_params

    from cb import data, weights as wt
    from cb.spec import load_reference, model_fields
    from cb.train_cell import DTYPE_NAMES, REF_STEPS
    ref = load_reference(cell.config)
    cfg = ModelConfig(**model_fields(cell.config))
    meta = init_params(cfg, torch.Generator(),
                       dtype=wt.DTYPES[cell.config["param_dtype"]],
                       device="meta")
    leaves = wt.table([(p, t.shape, DTYPE_NAMES[t.dtype])
                       for p, t in wt.tree_paths(meta)], cell.config["init"])
    feed = data.BigramFeed(cfg.vocab_size, cell.seq_len, cell.batch, seed,
                           dev)
    out = ref.train_steps(wt.make(seed, leaves, dev), cell.config,
                          cell.traffic["train"],
                          [feed.batch(i) for i in range(REF_STEPS)],
                          lambda cur: wt.diff_sq(seed, leaves, cur),
                          prec=ref.Precision(prec), fault=fault, dp=cell.dp)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def variant_lines(cell, seed: int, dev, ref: dict, variants) -> list:
    from cb.train_cell import readings
    lines = []
    for v in variants:
        t = time.perf_counter()
        got = reference_run(cell, seed, dev,
                            prec="fp8" if v == "fp8" else "f32",
                            fault=None if v == "fp8" else v)
        lines.append({"cell": cell.name, "seed": seed, "kind": v,
                      "readings": readings(got, ref),
                      "seconds": time.perf_counter() - t,
                      "loss": got["loss"], "ref_loss": ref["loss"]})
        print(json.dumps(lines[-1]), flush=True)
    return lines


def rank_readings(rank: int, world: int, cell, seeds, variants,
                  program: bool, fault=None) -> list:
    import torch
    from cb.train_cell import loss_steps_gap, rank_run, readings
    lines = []
    for seed in seeds:
        if program:
            t = time.perf_counter()
            r = rank_run(rank, world, cell, seed, None, False,
                         fault=fault)
            if rank == 0:
                ref = r["reference"]
                lines.append({"cell": cell.name, "seed": seed,
                              "kind": fault or "program",
                              "readings": readings(r["program"], ref,
                                                   r.get("rank_mismatch")),
                              "seconds": time.perf_counter() - t,
                              "reference_s": r["reference_s"],
                              "loss_steps_gap": loss_steps_gap(
                                  r["program"], ref),
                              "setup_peak": r["setup_peak"],
                              "loss": r["program"]["loss"],
                              "ref_loss": ref["loss"]})
                print(json.dumps(lines[-1]), flush=True)
        if rank == 0 and variants:
            dev = torch.device("cuda", 0) if world == 1 else \
                torch.device("cuda", torch.cuda.current_device())
            if not program:
                ref = reference_run(cell, seed, dev)
            lines += variant_lines(cell, seed, dev, ref, variants)
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--variants", nargs="*", default=[])
    p.add_argument("--fault", default=None,
                   help="a fault planted in the program (--program): "
                        "unchanged, half_batch, no_exchange, altered")
    args = p.parse_args(argv)
    import torch
    from cb.spec import find_cell
    cell = find_cell(args.workload)
    world = cell.dp if args.program else 1
    if torch.cuda.device_count() < world:
        print(f"needs {world} cards", file=sys.stderr)
        return 2
    if world == 1:
        torch.cuda.set_device(0)
        lines = rank_readings(0, 1, cell, args.seeds, args.variants,
                              args.program, args.fault)
    else:
        from repro_torch.launch.ranks import build_kernels, spawn_ranks
        build_kernels()
        lines = spawn_ranks(rank_readings, world, cell, args.seeds,
                            args.variants, args.program, args.fault,
                            backend="nccl", timeout_s=3000.0)[0]
    out = ROOT / "build" / "chipbench" / f"control-{cell.name}.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
