"""The benchmark's files, found by name.

``BENCHMARK.json`` at the root of the checkout names each cell (a
configuration under a traffic mix) and each metric.  Everything that
belongs to one of them sits in a file of its own, found by that name:

- ``chipbench/configs/<config>.json``: the model's sizes as they are run
  (the fields of ``repro_torch.core.types.ModelConfig``), the parameters'
  dtype, the rules of the benchmark's initializer and the plain reference
  that checks it (``chipbench/reference/<reference>.py``);
- ``chipbench/workloads/<traffic>.json``: the job: batch, sequence length,
  mesh and the ``TrainConfig`` of the step (the data: bigram rows);
- ``chipbench/limits/<cell>.json``: the limit of each number that decides
  ``correct``;
- ``chipbench/metrics/<metric>.py``: the reader of a per-layer metric.

So a cell, a configuration or a metric is added by adding files.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"the benchmark has no file {path}")
    return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
    """One cell with everything its run reads."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def batch(self) -> int:
        return int(self.traffic["batch"])

    @property
    def seq_len(self) -> int:
        return int(self.traffic["seq_len"])

    @property
    def dp(self) -> int:
        return int(self.traffic.get("mesh", {}).get("data", 1))


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: Optional[dict] = None,
              root: Path = ROOT) -> Cell:
    bench = load_benchmark(root) if bench is None else bench
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[w["config"]]["file"])
    traffic = _json(root / "chipbench" / "workloads" / f"{w['traffic']}.json")
    limits = _json(root / "chipbench" / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _reports(m, name) and m["moves"] in moved]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=layer)


def load_metric(name: str, root: Path = ROOT):
    """The reader module of a per-layer metric: ``read(run) -> float or
    None``."""
    path = root / "chipbench" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader {path} for metric {name!r}")
    spec = importlib.util.spec_from_file_location(f"chipbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reference(config: dict, root: Path = ROOT):
    """The plain reference module that a configuration names."""
    path = root / "chipbench" / "reference" / f"{config['reference']}.py"
    spec = importlib.util.spec_from_file_location(
        f"chipbench_reference_{config['reference']}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def model_fields(config: dict) -> Dict[str, Any]:
    """The keys of a configuration file that are ``ModelConfig`` fields
    (the file names them by the port's field names)."""
    from repro_torch.core.types import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return {k: v for k, v in config.items() if k in names}
