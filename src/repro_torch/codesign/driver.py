"""Legacy keyword entry point to the co-design engine.

``plan_iteration`` was the original vertical slice through all five
layers of the paper's paradigm (Fig. 5a); the engine itself now lives in
``codesign.api`` behind the declarative :class:`CodesignProblem` /
``plan`` / ``search`` surface, and this module is the exact
kwarg-for-kwarg adapter over it:

  plan_iteration(**kw) == plan(CodesignProblem.from_kwargs(**kw))

Existing callers (tests, benchmarks, ``plan_cluster``) keep working
unchanged; new code should build a :class:`CodesignProblem` and call
``plan``/``search`` directly — that is the surface that exposes the
plan space (placement search, knob whitelists, objectives) this flat
signature cannot.

The port's copy of ``repro.codesign.driver``, kept line for line:
importing any ``repro`` module runs the JAX package's ``__init__``, which
imports jax, so the port keeps its own.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

from repro_torch.ccl.select import CostModel
from repro_torch.core.demand_builder import DemandParams
from repro_torch.core.types import MeshConfig, ModelConfig, ShapeConfig
from repro_torch.net.topology import Topology
from repro_torch.sched.tasks import Policy

from repro_torch.codesign.api import CodesignProblem, plan
from repro_torch.codesign.placement import Placement
from repro_torch.codesign.report import CodesignReport, TaskChoice  # noqa: F401


def plan_iteration(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshConfig,
                   topo: Topology, policy: Policy = "priority",
                   placement: Union[str, Placement] = "packed",
                   cost_model: Union[str, CostModel] = "flowsim",
                   dp_params: Optional[DemandParams] = None,
                   allow: Optional[Tuple[str, ...]] = None,
                   force: Optional[Dict[str, str]] = None,
                   hotspot_k: int = 8,
                   switch_capacity: Optional[int] = None,
                   error_budget: Union[float, Dict[str, float]] = 0.0,
                   bucket_bytes: Optional[int] = None,
                   decompose: Union[bool, Tuple[str, ...]] = False
                   ) -> CodesignReport:
    """Run one training iteration through the full co-design pipeline.

    ``placement``: a strategy name (packed/strided) or a pre-built
    Placement.  ``cost_model``: "flowsim" (price candidates on ``topo``),
    "alphabeta" (closed forms with params derived from ``topo``), or any
    CostModel.  ``force``: primitive -> algorithm overrides (e.g.
    ``{"all_reduce": "ring"}`` to measure what topology-blind flat-ring
    selection costs).  ``allow``: whitelist forwarded to selection.
    ``dp_params``: demand-shaping knobs (None = ``DemandParams()``,
    constructed per call).  ``switch_capacity``: per-switch in-network
    aggregation budget for the ``atp`` candidate (None = unlimited; see
    ``sched.atp``).  ``error_budget``: relative-error tolerance that
    admits compressed candidates (``repro_torch.compress``) into selection
    — a float for every task, or a primitive -> budget dict (e.g.
    ``{"all_reduce": 0.01}`` to quantize gradient syncs while keeping
    activation collectives exact).  Default 0 = lossless only.
    ``bucket_bytes``/``decompose``: the overlap knobs — fused gradient
    buckets of that size, and the collective-matmul rewrite of TP
    collectives (see ``core.demand_builder``)."""
    return plan(CodesignProblem.from_kwargs(
        cfg, shape, mesh, topo, policy=policy, placement=placement,
        cost_model=cost_model, dp_params=dp_params, allow=allow,
        force=force, hotspot_k=hotspot_k, switch_capacity=switch_capacity,
        error_budget=error_budget, bucket_bytes=bucket_bytes,
        decompose=decompose))
