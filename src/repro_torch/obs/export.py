"""Persisted report JSON -> Perfetto trace, as a module CLI.

    python -m repro_torch.obs.export experiments/plan.json
    python -m repro_torch.obs.export run.json -o run.trace.json --kind search

Accepts any report the engine persists (``CodesignReport`` /
``SearchResult`` / ``ClusterReport`` / ``DynamicsReport`` ``to_dict()``
JSON); the kind is sniffed from the document's keys unless ``--kind``
pins it.  The output loads in https://ui.perfetto.dev or
``chrome://tracing``.  Pure dict work — no topology is available from
JSON alone, so per-link counter tracks (which need the live
``Topology``) come from the in-process ``to_trace(topo=...)`` path
instead.

The port's copy of ``repro.obs.export``, kept line for line: importing any
``repro`` module runs the JAX package's ``__init__``, which imports jax, so
the port keeps its own.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

from repro_torch.obs.trace import (Trace, trace_from_cluster,
                                   trace_from_dynamics, trace_from_report,
                                   trace_from_search, trace_from_serving)

KINDS = ("report", "search", "cluster", "dynamics", "serving")


def detect_kind(d: Dict) -> str:
    """Which report a ``to_dict()`` document is, from its key shape."""
    if "records" in d and "final" in d:
        return "dynamics"
    if "best" in d and "frontier" in d:
        return "search"
    if "ttft" in d and "requests" in d:
        return "serving"
    if "jobs" in d and "staggered_jct" in d:
        return "cluster"
    if "choices" in d and "jct" in d:
        return "report"
    raise ValueError(
        f"unrecognized report document (top-level keys {sorted(d)[:8]}); "
        f"expected a CodesignReport / SearchResult / ClusterReport / "
        f"DynamicsReport / ServingReport to_dict() JSON")


def build_trace(d: Dict, kind: Optional[str] = None) -> Trace:
    kind = kind or detect_kind(d)
    if kind == "dynamics":
        return trace_from_dynamics(d)
    if kind == "search":
        return trace_from_search(d)
    if kind == "serving":
        return trace_from_serving(d)
    if kind == "cluster":
        return trace_from_cluster(d)
    if kind == "report":
        return trace_from_report(d)
    raise ValueError(f"unknown kind {kind!r} (one of {KINDS})")


def export_file(path: str, out: Optional[str] = None,
                kind: Optional[str] = None) -> str:
    with open(path) as f:
        d = json.load(f)
    if out is None:
        stem = path[:-5] if path.endswith(".json") else path
        out = stem + ".trace.json"
    return build_trace(d, kind).write(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.export",
        description="Convert persisted report JSON to a Perfetto-loadable "
                    "Chrome Trace Event file.")
    ap.add_argument("report", help="report to_dict() JSON file")
    ap.add_argument("-o", "--out", default=None,
                    help="output path (default: <report>.trace.json)")
    ap.add_argument("--kind", choices=KINDS, default=None,
                    help="report kind (default: sniff from keys)")
    args = ap.parse_args(argv)
    out = export_file(args.report, args.out, args.kind)
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
