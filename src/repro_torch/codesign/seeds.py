"""Persisted warm-start seeds for ``codesign.search``.

A search's winning knob assignment is a function of the topology, the
model, and the mesh — and those recur: the same cluster re-plans after
events (``ClusterDynamics``), CI re-runs the same locked benchmarks, and
operators re-search after small config edits.  This module persists the
winner per ``(topology fingerprint, model, shape, mesh)`` as a small JSON
file; ``search(problem, seeds_dir=...)`` loads it as the first candidate
priced (phase ``"warm_start"``) and saves the new winner back.  A stale
seed costs one evaluation; a fresh one makes the incumbent optimal from
candidate #1, so the sweep's remaining budget is pure verification.

Seed files are keyed by content fingerprints, so a rewired topology (or a
degradation view from ``Topology.without_link``) never picks up another
fabric's plan.

The port's copy of ``repro.codesign.seeds``, kept line for line: importing
any ``repro`` module runs the JAX package's ``__init__``, which imports
jax, so the port keeps its own.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional

from repro_torch.ccl.synth import topology_fingerprint


def seed_key(problem) -> str:
    """Filename-safe identity of what a seed is valid for."""
    mesh = problem.mesh
    cfg_fp = hashlib.sha1(repr(
        (problem.cfg.name, problem.shape.name, mesh.shape, mesh.axis_names,
         mesh.data_axes, mesh.model_axes, mesh.pipeline_axis)
    ).encode()).hexdigest()[:10]
    return f"{topology_fingerprint(problem.topo)}__{cfg_fp}"


def seed_path(seeds_dir: str, problem) -> str:
    return os.path.join(seeds_dir, f"seed_{seed_key(problem)}.json")


def save_seed(seeds_dir: str, problem, assignment: Dict[str, object]) -> str:
    """Persist a search winner's knob assignment for this problem's
    (topology, model, shape, mesh).  Returns the file path written."""
    from repro_torch.codesign.api import _assignment_value_json
    os.makedirs(seeds_dir, exist_ok=True)
    path = seed_path(seeds_dir, problem)
    payload = {
        "key": seed_key(problem),
        "topology": problem.topo.name,
        "model": problem.cfg.name,
        "assignment": {n: _assignment_value_json(v)
                       for n, v in assignment.items()},
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    return path


def load_seed(seeds_dir: str, problem) -> Optional[Dict[str, object]]:
    """The persisted winning assignment for this problem, or None when no
    (valid) seed exists.  Unreadable/mismatched files are treated as
    absent — a corrupt seed must never break a search."""
    from repro_torch.codesign.api import _assignment_from_json
    path = seed_path(seeds_dir, problem)
    try:
        with open(path) as f:
            payload = json.load(f)
        if payload.get("key") != seed_key(problem):
            return None
        return _assignment_from_json(payload["assignment"])
    except (OSError, ValueError, KeyError):
        return None
