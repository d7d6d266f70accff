"""Plan artifacts: what the co-design pipeline hands back up the stack.

``TaskChoice`` and ``CodesignReport`` are the result types of
``codesign.api.plan`` (and of the ``plan_iteration`` adapter that wraps
it).  Both serialize to plain JSON — placements as device lists, link
hot spots as ``"u->v"`` string keys — so ``experiments/`` and
``benchmarks/`` can persist plans, and round-trip back via
``from_dict`` (the live ``SimResult`` is the one field that does not
survive the trip; its executed ``timeline`` does, so a loaded report
still renders its Perfetto trace via ``to_trace`` — everything the
layers above need survives).

The port's copy of ``repro.codesign.report``, kept line for line:
importing any ``repro`` module runs the JAX package's ``__init__``, which
imports jax, so the port keeps its own.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.core.types import MeshConfig
from repro_torch.sched.tasks import SimResult

from repro_torch.codesign.placement import Placement


# ---------------------------------------------------------------------------
# Shared metric registry (training + serving objectives)
# ---------------------------------------------------------------------------

# metric name -> maximize?  ``Objective`` (codesign.api) validates its
# ``minimize`` / ``tie_break`` / ``constraints`` names against this one
# registry, so training metrics (JCT, exposed comm, ...) and serving
# metrics (TTFT/TPOT percentiles, goodput — registered by
# ``codesign.serving`` at import) share the same namespace and the same
# unknown-metric error.
OBJECTIVE_METRICS: Dict[str, bool] = {
    "jct": False,
    "exposed_comm": False,
    "comm_time": False,
    "compute_time": False,
    "worst_link_bytes": False,
    "wire_bytes_saved": True,
}


def register_metric(name: str, maximize: bool = False) -> None:
    """Register an objective metric (idempotent; re-registering with a
    different direction is an error — one name, one meaning)."""
    prev = OBJECTIVE_METRICS.get(name)
    if prev is not None and prev != maximize:
        raise ValueError(
            f"metric {name!r} already registered with maximize={prev}")
    OBJECTIVE_METRICS[name] = maximize


def metric_value(report, name: str) -> float:
    """Read metric ``name`` off a report object, with the registry's
    unknown-metric error instead of a bare AttributeError."""
    if name not in OBJECTIVE_METRICS:
        raise ValueError(
            f"unknown objective metric {name!r}; valid metrics: "
            f"{sorted(OBJECTIVE_METRICS)}")
    try:
        return float(getattr(report, name))
    except AttributeError:
        raise ValueError(
            f"metric {name!r} is not defined on {type(report).__name__} "
            f"reports (it is registered for a different problem kind)")


@dataclass
class TaskChoice:
    """One comm task's resolved placement + algorithm selection."""

    task_id: str
    primitive: str
    size_bytes: int
    group: Tuple[int, ...]
    algorithm: str
    cost_s: float
    costs: Dict[str, float] = field(default_factory=dict)
    # compression (repro_torch.compress): the codec riding on the algorithm
    # (None = uncompressed) and its wire-byte ratio
    codec: Optional[str] = None
    wire_ratio: float = 1.0

    def to_dict(self) -> Dict:
        return {
            "task_id": self.task_id, "primitive": self.primitive,
            "size_bytes": self.size_bytes, "group": list(self.group),
            "algorithm": self.algorithm, "cost_s": self.cost_s,
            "costs": dict(self.costs), "codec": self.codec,
            "wire_ratio": self.wire_ratio,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "TaskChoice":
        return cls(task_id=d["task_id"], primitive=d["primitive"],
                   size_bytes=d["size_bytes"], group=tuple(d["group"]),
                   algorithm=d["algorithm"], cost_s=d["cost_s"],
                   costs=dict(d["costs"]), codec=d["codec"],
                   wire_ratio=d["wire_ratio"])


def _link_key(link: Tuple) -> str:
    """A link tuple as a JSON object key: ``(0, 'host0')`` -> ``"0->host0"``."""
    return "->".join(str(n) for n in link)


def _parse_link_key(key: str) -> Tuple:
    """Inverse of :func:`_link_key` (integer node ids are restored)."""
    return tuple(int(p) if p.lstrip("-").isdigit() else p
                 for p in key.split("->"))


def _placement_to_dict(pl: Placement) -> Dict:
    m = pl.mesh
    return {
        "strategy": pl.strategy, "topology": pl.topology,
        "devices": list(pl.devices),
        "mesh": {"shape": list(m.shape), "axis_names": list(m.axis_names),
                 "data_axes": list(m.data_axes),
                 "model_axes": list(m.model_axes),
                 "pipeline_axis": m.pipeline_axis},
    }


def _placement_from_dict(d: Dict) -> Placement:
    m = d["mesh"]
    mesh = MeshConfig(shape=tuple(m["shape"]),
                      axis_names=tuple(m["axis_names"]),
                      data_axes=tuple(m["data_axes"]),
                      model_axes=tuple(m["model_axes"]),
                      pipeline_axis=m.get("pipeline_axis"))
    return Placement(mesh=mesh, devices=tuple(d["devices"]),
                     strategy=d["strategy"], topology=d["topology"])


@dataclass
class CodesignReport:
    """What the co-design pipeline hands back up the stack."""

    jct: float
    exposed_comm: float
    compute_time: float
    comm_time: float
    policy: str
    cost_model: str
    placement: Placement
    choices: List[TaskChoice] = field(default_factory=list)
    link_hotspots: List[Tuple[Tuple, float]] = field(default_factory=list)
    sim: Optional[SimResult] = None
    # compression accounting: the error budget selection ran under
    # (verbatim — a float, or the caller's primitive -> budget dict) and
    # the on-wire bytes saved vs running the same chosen schedules
    # uncompressed (summed over every communicator replica)
    error_budget: Union[float, Dict[str, float]] = 0.0
    wire_bytes_saved: float = 0.0
    # per-task exposure attribution from the scheduler: seconds compute
    # stalled waiting on each comm task (sums to ``exposed_comm``) —
    # the per-edge accounting the overlap search optimizes against
    task_exposed_s: Dict[str, float] = field(default_factory=dict)
    # the executed schedule (``SimResult.timeline`` verbatim): persisted —
    # unlike the live ``sim`` — so a from_dict-loaded report still renders
    # its Perfetto trace (``to_trace``)
    timeline: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def comm_fraction(self) -> float:
        return self.exposed_comm / self.jct if self.jct else 0.0

    @property
    def worst_link_bytes(self) -> float:
        """Bytes on the hottest link — the load-imbalance metric the
        Objective can minimize or constrain."""
        return self.link_hotspots[0][1] if self.link_hotspots else 0.0

    @property
    def synthesized_choices(self) -> List["TaskChoice"]:
        """The tasks the plan's synthesis pass won (algorithm
        ``synthesized`` or a compressed variant) — what to lower with
        ``ccl.primitives.synthesized_collective``; empty when synthesis
        was off or never beat the registry."""
        return [c for c in self.choices
                if c.algorithm.split("+")[0] == "synthesized"]

    def algorithms_by_primitive(self) -> Dict[str, Dict[str, int]]:
        """primitive -> {algorithm: task count} histogram."""
        out: Dict[str, Dict[str, int]] = {}
        for c in self.choices:
            hist = out.setdefault(c.primitive, {})
            hist[c.algorithm] = hist.get(c.algorithm, 0) + 1
        return out

    def top_exposed_tasks(self, k: int = 8) -> List[Tuple[str, float]]:
        """The k comm tasks compute stalled on longest (hot-task
        attribution, no timeline digging required)."""
        hot = [(t, s) for t, s in self.task_exposed_s.items() if s > 0]
        hot.sort(key=lambda ts: (-ts[1], ts[0]))
        return hot[:k]

    def codecs_by_primitive(self) -> Dict[str, Dict[str, int]]:
        """primitive -> {codec or 'none': task count} histogram."""
        out: Dict[str, Dict[str, int]] = {}
        for c in self.choices:
            hist = out.setdefault(c.primitive, {})
            key = c.codec or "none"
            hist[key] = hist.get(key, 0) + 1
        return out

    # ------------------------------------------------------------------
    # JSON persistence
    # ------------------------------------------------------------------

    def to_dict(self) -> Dict:
        """Plain-JSON form: placement as a device list, hot spots as
        ``"u->v"`` keys (insertion order keeps the hottest-first sort).
        ``sim`` is intentionally dropped — it holds the live task-graph
        trace, not plan state."""
        budget = self.error_budget
        return {
            "jct": self.jct, "exposed_comm": self.exposed_comm,
            "compute_time": self.compute_time, "comm_time": self.comm_time,
            "policy": self.policy, "cost_model": self.cost_model,
            "placement": _placement_to_dict(self.placement),
            "choices": [c.to_dict() for c in self.choices],
            "link_hotspots": {_link_key(l): b
                              for l, b in self.link_hotspots},
            "error_budget": dict(budget) if isinstance(budget, dict)
            else budget,
            "wire_bytes_saved": self.wire_bytes_saved,
            "task_exposed_s": dict(self.task_exposed_s),
            "timeline": [[n, s, e] for n, s, e in self.timeline],
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "CodesignReport":
        budget = d["error_budget"]
        return cls(
            jct=d["jct"], exposed_comm=d["exposed_comm"],
            compute_time=d["compute_time"], comm_time=d["comm_time"],
            policy=d["policy"], cost_model=d["cost_model"],
            placement=_placement_from_dict(d["placement"]),
            choices=[TaskChoice.from_dict(c) for c in d["choices"]],
            link_hotspots=[(_parse_link_key(k), b)
                           for k, b in d["link_hotspots"].items()],
            sim=None,
            error_budget=dict(budget) if isinstance(budget, dict)
            else budget,
            wire_bytes_saved=d["wire_bytes_saved"],
            task_exposed_s=dict(d.get("task_exposed_s", {})),
            timeline=[(n, s, e) for n, s, e in d.get("timeline", [])])

    # ------------------------------------------------------------------
    # Observability
    # ------------------------------------------------------------------

    def to_trace(self, topo=None, **kw):
        """This plan as a Perfetto-loadable ``repro_torch.obs.trace.Trace``:
        compute / comm / exposed-comm tracks from the persisted timeline,
        plus per-link utilization counters when the live ``Topology`` is
        passed.  Works identically on a ``from_dict``-loaded report."""
        from repro_torch.obs.trace import trace_from_report
        return trace_from_report(self.to_dict(), topo=topo, **kw)
