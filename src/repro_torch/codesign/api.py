"""Declarative co-design problems over one searchable plan space.

Three PRs of cross-layer knobs (placement, per-primitive algorithm,
codec/error budget, scheduling policy, switch capacity) grew into an
11-parameter keyword pile on ``plan_iteration``.  The paper's Sec. IV-A
point is that these are *one* joint design space to be searched, not a
flat argument list — so this module makes the space first-class:

``CodesignProblem``
    model/shape/mesh/topology plus a :class:`PlanSpace` of typed knobs
    (``repro_torch.core.knobs``): each knob is ``Fixed(v)`` (pinned),
    ``Choice(...)`` (finite candidates) or ``Search()`` (candidates come
    from an optimizer).  An :class:`Objective` says what to minimize and
    what constrains feasibility.

``plan(problem)``
    all scalar knobs pinned -> one :class:`CodesignReport` (exactly the
    legacy ``plan_iteration`` behaviour; that function is now a thin
    kwarg adapter over this).

``search(problem, budget=N)``
    walks the free knobs — enumerating ``Choice`` options, generating
    placement candidates via ``codesign.placement_search`` (heuristics +
    a hot-spot-guided swap-neighborhood hill climb) for
    ``placement=Search()`` — pricing every candidate with one shared
    memoized cost model, and returns a :class:`SearchResult`: the best
    plan, the explored frontier, and a per-knob attribution of the win.

Per-primitive ``algorithm`` knobs are *constraints*, not enumeration
axes: the CCL selection layer is already a search over algorithms priced
by the same cost model, so ``Fixed`` forces, ``Choice`` whitelists and
``Search`` opens the registry (``ccl.select.select_for_task`` reads the
knob directly).

The port's copy of ``repro.codesign.api``, kept line for line: importing
any ``repro`` module runs the JAX package's ``__init__``, which imports
jax, so the port keeps its own.
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple, Union

from repro_torch.ccl.select import (AlphaBeta, CostModel, FlowSim, Selection,
                                    constraint_from_allow, flows_on_topology,
                                    select_for_task)
from repro_torch.ccl.synth import (DEFAULT_SYNTH_CACHE, SYNTHESIZABLE, Sketch,
                                   sketch_from_hotspots)
from repro_torch.compress.codec import (base_algorithm, codec_spec,
                                        split_algorithm)
from repro_torch.core.demand_builder import (DECOMPOSABLE_PRIMITIVES,
                                             DemandParams, build_demand,
                                             decompose_demand)
from repro_torch.core.knobs import (Choice, Fixed, Knob, Search, as_knob,
                                   is_free)
from repro_torch.core.types import MeshConfig, ModelConfig, ShapeConfig
from repro_torch.net.simulate import link_utilization
from repro_torch.net.topology import Topology
from repro_torch.sched.atp import aggregation_switches
from repro_torch.sched.tasks import Policy, simulate_iteration

from repro_torch.codesign.placement import Placement, place_mesh
from repro_torch.codesign.report import (OBJECTIVE_METRICS, CodesignReport,
                                         TaskChoice, _placement_from_dict,
                                         _placement_to_dict, metric_value)

# the scalar knobs plan() needs pinned and search() may enumerate
# (per-primitive algorithm knobs are selection constraints instead).
# ``stagger`` only matters for serving problems (the co-tenant phase
# offset in seconds); training plans ignore it.
SCALAR_KNOBS = ("placement", "policy", "error_budget", "switch_capacity",
                "bucket_bytes", "decompose", "stagger", "synthesize")


@dataclass(frozen=True)
class PlanSpace:
    """The typed cross-layer design space of one job.

    ``algorithm`` maps a primitive (``"all_reduce"``, ...) to its knob;
    the ``"*"`` key applies to unlisted primitives.  ``Fixed(name)``
    forces (bypassing the error-budget gate, like the legacy single-name
    ``allow``), ``Choice(...)`` whitelists, ``Search()``/absent opens
    the full registry.  ``error_budget`` values may be a float or a
    primitive -> budget dict (the legacy shapes, verbatim).

    The two overlap knobs reshape the demand DAG itself:
    ``bucket_bytes`` (None = legacy per-layer gradient sync; an int =
    fused buckets of that size chained off the backward layer that
    filled them; ``Search()`` generates a geometric ladder from the
    total gradient bytes) and ``decompose`` (False = bulk TP
    collectives; True = rewrite them into collective-matmul ring
    permutes riding under split partial matmuls; a tuple of primitive
    names decomposes just those)."""

    placement: Knob = Fixed("packed")
    algorithm: Mapping[str, Knob] = field(default_factory=dict)
    error_budget: Knob = Fixed(0.0)
    policy: Knob = Fixed("priority")
    switch_capacity: Knob = Fixed(None)
    bucket_bytes: Knob = Fixed(None)
    decompose: Knob = Fixed(False)
    # serving problems only: phase offset (seconds) of this tenant's
    # admission clock against the co-tenant training pulses sharing its
    # fabric — the CASSINI stagger lever, per-tenant.  ``Search()``
    # generates a grid over the co-tenant period.
    stagger: Knob = Fixed(0.0)
    # SCCL/TACCL-style collective synthesis as a plan-space lever: False =
    # registered algorithms only; True = synthesize topology-specific
    # schedules (sketch-guided by this plan's hot-spot map) for the 2
    # hottest synthesizable selection keys and let them compete in
    # ``ccl.select`` under the active cost model; an int raises the
    # top-k.  ``Search()`` walks [False, True] jointly with the other
    # knobs.
    synthesize: Knob = Fixed(False)

    def scalar_knobs(self) -> Dict[str, Knob]:
        return {name: getattr(self, name) for name in SCALAR_KNOBS}

    def free_knobs(self) -> Dict[str, Knob]:
        """The knobs ``search()`` walks (Fixed ones are pinned)."""
        return {n: k for n, k in self.scalar_knobs().items() if is_free(k)}

    def constraint_for(self, primitive: str) -> Optional[Knob]:
        """The algorithm knob the selection layer sees for ``primitive``."""
        knob = self.algorithm.get(primitive)
        return knob if knob is not None else self.algorithm.get("*")

    def pinned(self, **values) -> "PlanSpace":
        """A copy with the named scalar knobs replaced: raw values are
        pinned (wrapped in ``Fixed``), Knob instances are taken as-is —
        so ``pinned(placement=Search())`` re-opens a knob instead of
        nesting it inside a Fixed."""
        for name in values:
            if name not in SCALAR_KNOBS:
                raise ValueError(f"unknown scalar knob {name!r} "
                                 f"(one of {SCALAR_KNOBS})")
        return dataclasses.replace(
            self, **{n: as_knob(v) for n, v in values.items()})


@dataclass(frozen=True)
class Objective:
    """What 'best' means.  ``minimize``/``tie_break`` name metrics from
    the shared registry (``codesign.report.OBJECTIVE_METRICS``) —
    training metrics (``jct``, ``exposed_comm``, ...) and serving
    metrics (``ttft_p99``, ``goodput``, ... registered by
    ``codesign.serving``) share one namespace, so an unknown name fails
    here with the full valid set instead of deep inside ``key()``.
    Bigger-is-better metrics (``wire_bytes_saved``, ``goodput``) are
    negated internally, so naming one always rewards more of it.

    ``constraints`` maps metric names to feasibility bounds: an *upper*
    bound for minimized metrics, a *lower* bound for maximized ones
    (``{"ttft_p99": 0.5, "goodput": 3.0}`` = p99 TTFT within 500 ms AND
    at least 3 req/s of goodput).  ``max_worst_link_bytes`` is the
    legacy spelling of ``constraints={"worst_link_bytes": ...}`` and is
    folded in."""

    minimize: str = "jct"
    tie_break: Tuple[str, ...] = ("exposed_comm", "worst_link_bytes")
    max_worst_link_bytes: Optional[float] = None
    constraints: Mapping[str, float] = field(default_factory=dict)

    # legacy class attrs, kept importable (the registry is the source of
    # truth; serving extends it at import)
    METRICS = ("jct", "exposed_comm", "comm_time", "compute_time",
               "worst_link_bytes", "wire_bytes_saved")
    _MAXIMIZED = ("wire_bytes_saved",)

    def __post_init__(self):
        merged = dict(self.constraints)
        if self.max_worst_link_bytes is not None:
            merged.setdefault("worst_link_bytes", self.max_worst_link_bytes)
        object.__setattr__(self, "constraints", merged)
        for m in (self.minimize, *self.tie_break, *merged):
            if m not in OBJECTIVE_METRICS:
                raise ValueError(
                    f"unknown objective metric {m!r}; valid metrics: "
                    f"{sorted(OBJECTIVE_METRICS)}")

    def key(self, report) -> Tuple[float, ...]:
        """Lexicographic minimization key."""
        return tuple(-metric_value(report, m) if OBJECTIVE_METRICS[m]
                     else metric_value(report, m)
                     for m in (self.minimize, *self.tie_break))

    def infeasible_reason(self, report) -> Optional[str]:
        """Why ``report`` violates the constraints (None = feasible).
        Checked in sorted-metric order so the reported reason is
        deterministic when several constraints fail."""
        for m in sorted(self.constraints):
            bound = self.constraints[m]
            v = metric_value(report, m)
            if OBJECTIVE_METRICS[m]:
                if v < bound:
                    return f"{m} {v:.6g} < required {bound:.6g}"
            elif v > bound:
                return f"{m} {v:.6g} > limit {bound:.6g}"
        return None

    def feasible(self, report) -> bool:
        return self.infeasible_reason(report) is None


@dataclass(frozen=True)
class CodesignProblem:
    """One job's co-design problem: what to train, where, and which
    knobs of the cross-layer space are open."""

    cfg: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig
    topo: Topology
    space: PlanSpace = field(default_factory=PlanSpace)
    objective: Objective = field(default_factory=Objective)
    cost_model: Union[str, CostModel] = "flowsim"
    dp_params: Optional[DemandParams] = None
    hotspot_k: int = 8
    # serving problems: a ``codesign.serving.ServingSpec`` makes this an
    # inference workload — ``plan()`` dispatches to ``plan_serving`` and
    # the objective speaks SLO metrics (ttft_p99, goodput, ...) instead
    # of JCT.  ``serving_problem(...)`` is the ergonomic constructor.
    serving: Optional[object] = None

    @classmethod
    def from_kwargs(cls, cfg: ModelConfig, shape: ShapeConfig,
                    mesh: MeshConfig, topo: Topology,
                    policy: Policy = "priority",
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
                    ) -> "CodesignProblem":
        """The legacy ``plan_iteration`` keyword surface as a problem:
        ``force`` entries become per-primitive ``Fixed`` knobs, ``allow``
        the ``"*"`` wildcard (one name -> ``Fixed`` = forced, several ->
        ``Choice`` = whitelist), everything else a pinned scalar knob."""
        algorithm: Dict[str, Knob] = {}
        if force:
            algorithm.update({p: Fixed(a) for p, a in force.items()})
        if allow:  # empty allow always behaved like None: full registry
            algorithm["*"] = constraint_from_allow(tuple(allow))
        space = PlanSpace(
            placement=Fixed(placement), algorithm=algorithm,
            error_budget=Fixed(error_budget), policy=Fixed(policy),
            switch_capacity=Fixed(switch_capacity),
            bucket_bytes=Fixed(bucket_bytes), decompose=Fixed(decompose))
        return cls(cfg=cfg, shape=shape, mesh=mesh, topo=topo, space=space,
                   cost_model=cost_model, dp_params=dp_params,
                   hotspot_k=hotspot_k)

    def pinned(self, **values) -> "CodesignProblem":
        """A copy with the named scalar knobs pinned (see PlanSpace)."""
        return dataclasses.replace(self, space=self.space.pinned(**values))

    def is_fully_specified(self) -> bool:
        return not self.space.free_knobs()


# ---------------------------------------------------------------------------
# Cost-model resolution
# ---------------------------------------------------------------------------


def _model_capacity(model: CostModel) -> Optional[int]:
    """The in-network aggregation budget a cost model prices ``atp`` with
    (None = unlimited): FlowSim carries ``switch_capacity``, AlphaBeta
    ``params.atp_capacity``."""
    cap = getattr(model, "switch_capacity", None)
    if cap is None:
        cap = getattr(getattr(model, "params", None), "atp_capacity", None)
    return cap


def _resolve_cost_model(cost_model: Union[str, CostModel], topo: Topology,
                        switch_capacity: Optional[int] = None
                        ) -> Tuple[CostModel, str]:
    if not isinstance(cost_model, str):
        if switch_capacity is not None and \
                _model_capacity(cost_model) != switch_capacity:
            raise ValueError(
                "switch_capacity applies to the named cost models "
                "('flowsim' | 'alphabeta'); a CostModel instance must "
                "carry its own aggregation budget (e.g. "
                "FlowSim(topo, switch_capacity=...) or "
                "CostParams(atp_capacity=...))")
        return cost_model, type(cost_model).__name__.lower()
    if cost_model == "flowsim":
        return FlowSim(topo, switch_capacity=switch_capacity), "flowsim"
    if cost_model == "alphabeta":
        ab = AlphaBeta.from_topology(topo)
        if switch_capacity is not None:
            ab = dataclasses.replace(ab, params=dataclasses.replace(
                ab.params, atp_capacity=switch_capacity))
        return ab, "alphabeta"
    raise ValueError(f"unknown cost model {cost_model!r} "
                     f"(flowsim | alphabeta | a CostModel instance)")


# ---------------------------------------------------------------------------
# plan(): all scalar knobs pinned -> one CodesignReport
# ---------------------------------------------------------------------------


def plan(problem: CodesignProblem,
         _resolved: Optional[Tuple[CostModel, str]] = None
         ) -> CodesignReport:
    """Run one training iteration through the full co-design pipeline:

      Para.   build_demand(cfg, shape, mesh)          logical CommDemand
      Place.  place_mesh(mesh, topo).place_demand()   physical groups
      CCL     select_for_task(task, CostModel)        per-task algorithm
      Net.    FlowSim prices candidates on the real topology
      Sched.  simulate_iteration(...)                 JCT + exposed comm

    Every scalar knob of ``problem.space`` must be ``Fixed`` — free
    knobs are ``search()``'s job.  ``_resolved`` lets the search loop
    share one memoized cost model across candidates.

    Serving problems (``problem.serving`` set) dispatch to
    ``codesign.serving.plan_serving``: same knob discipline, but the
    report speaks TTFT/TPOT/goodput under the arrival process."""
    space = problem.space
    free = space.free_knobs()
    if free:
        raise ValueError(
            f"plan() needs every scalar knob Fixed, but "
            f"{sorted(free)} are free ({free}) — use search(problem) "
            f"to walk them")
    if problem.serving is not None:
        from repro_torch.codesign.serving import plan_serving
        return plan_serving(problem, _resolved=_resolved)
    topo = problem.topo
    placement = space.placement.value
    policy: Policy = space.policy.value
    error_budget = space.error_budget.value
    switch_capacity = space.switch_capacity.value
    bucket_bytes = space.bucket_bytes.value
    decompose = space.decompose.value

    pl = placement if isinstance(placement, Placement) else \
        place_mesh(problem.mesh, topo, strategy=placement)
    model, model_name = _resolved if _resolved is not None else \
        _resolve_cost_model(problem.cost_model, topo, switch_capacity)
    # the aggregation budget selection actually priced atp with — an
    # instance cost model carries its own; the hot-spot map must match it
    agg_capacity = switch_capacity if switch_capacity is not None \
        else _model_capacity(model)

    demand = build_demand(problem.cfg, problem.shape, problem.mesh,
                          problem.dp_params, bucket_bytes=bucket_bytes)
    if decompose:
        # rewrite TP collectives into collective-matmul ring permutes
        # BEFORE placement, so axis-tagged replica accounting still works
        prims = DECOMPOSABLE_PRIMITIVES if decompose is True \
            else tuple(decompose)
        demand = decompose_demand(demand, primitives=prims)
    placed = pl.place_demand(demand)

    def budget_of(primitive: str) -> float:
        if isinstance(error_budget, dict):
            return error_budget.get(primitive, 0.0)
        return error_budget

    # Per-task selection, memoized on the selection key — a 40-layer demand
    # repeats a handful of unique (primitive, size, group) combinations.
    sel_memo: Dict[Tuple, Selection] = {}
    choices: Dict[str, TaskChoice] = {}
    for task in placed.comm_tasks:
        key = (task.primitive, task.size_bytes, task.group)
        sel = sel_memo.get(key)
        if sel is None:
            sel = select_for_task(
                task, model, constraint=space.constraint_for(task.primitive),
                error_budget=budget_of(task.primitive))
            sel_memo[key] = sel
        _, codec = split_algorithm(sel.algorithm)
        choices[task.task_id] = TaskChoice(
            task.task_id, task.primitive, task.size_bytes, task.group,
            sel.algorithm, sel.cost, sel.costs, codec=codec,
            wire_ratio=codec_spec(codec).wire_ratio if codec else 1.0)

    def comm_cost(task):
        c = choices[task.task_id]
        return c.cost_s, c.algorithm

    sim = simulate_iteration(placed, comm_cost, policy)

    # Hot-spot map.  The JCT simulation above prices one *representative*
    # communicator per task (all replicas along an axis run the same
    # collective concurrently), but the per-link byte map must cover every
    # replica or whole hosts would look idle.  Flowsets are memoized on the
    # same (primitive, algorithm, size, group) key selection dedups on.
    def replicas_of(task):
        if task.axis == "model":
            return len(pl.model_groups())
        if task.axis == "data":
            return len(pl.data_groups())
        return 1

    def traffic_map(sketch_by_key=None) -> Tuple[Dict[Tuple, float], float]:
        """Per-link byte map + compression wire-byte savings over every
        replica of every task, under the current ``choices``.
        ``sketch_by_key`` maps a selection key (primitive, size, placed
        group) to the sketch its winning schedule was synthesized under
        (None = unbiased) so the second pass replays the schedules that
        actually won, replicas included."""
        util: Dict[Tuple, float] = {}
        fs_memo: Dict[Tuple, object] = {}
        bytes_saved = 0.0
        for ltask, ptask in zip(demand.comm_tasks, placed.comm_tasks):
            choice = choices[ptask.task_id]
            algo = choice.algorithm
            for r in range(replicas_of(ltask)):
                group = ptask.group if r == 0 else \
                    pl.place_group(ltask.group, ltask.axis, replica=r)
                key = (ltask.primitive, algo, ltask.size_bytes, group)
                fs = fs_memo.get(key)
                if fs is None:
                    replica = dataclasses.replace(ptask, group=group)
                    try:
                        if base_algorithm(algo) == "synthesized":
                            sk = (sketch_by_key or {}).get(
                                (ltask.primitive, ltask.size_bytes,
                                 ptask.group))
                            fs = DEFAULT_SYNTH_CACHE.schedule(
                                topo, replica, sk).to_flowset(
                                    wire_ratio=choice.wire_ratio,
                                    algorithm=algo)
                        else:
                            fs = flows_on_topology(topo, replica, algo)
                    except (ValueError, KeyError):
                        # replica-r's group can be shaped differently from
                        # the representative's (irregular placement); skip
                        # rather than mis-attribute its bytes
                        continue
                    fs_memo[key] = fs
                agg = aggregation_switches(topo, group, agg_capacity) \
                    if base_algorithm(algo) == "atp" else None
                for link, nbytes in link_utilization(topo, fs, agg).items():
                    util[link] = util.get(link, 0.0) + nbytes
                if choice.codec:
                    # vs the same schedule uncompressed (the wire-byte win
                    # the compression layer hands the network layer)
                    bytes_saved += fs.bytes_on_wire() \
                        * (1.0 / choice.wire_ratio - 1.0)
        return util, bytes_saved

    util, bytes_saved = traffic_map()

    # Second pass — the synthesis lever (paper Sec. III-B, SCCL/TACCL):
    # rank selection keys by exposed seconds, synthesize sketch-guided
    # schedules for the hottest ones (the sketch's link penalties are
    # THIS plan's hot-spot map, steering chunks off contended uplinks),
    # and let them compete as priced candidates.  Wins re-simulate.
    synthesize = space.synthesize.value
    if synthesize:
        topk = 2 if synthesize is True else int(synthesize)
        sketch = sketch_from_hotspots(topo, util)
        exposure: Dict[Tuple, float] = {}
        rep: Dict[Tuple, object] = {}
        for task in placed.comm_tasks:
            if task.primitive not in SYNTHESIZABLE or len(task.group) < 2:
                continue
            key = (task.primitive, task.size_bytes, task.group)
            exposure[key] = exposure.get(key, 0.0) \
                + sim.task_exposed_s.get(task.task_id, 0.0)
            rep.setdefault(key, task)
        changed = False
        won_sketch: Dict[Tuple, Optional[Sketch]] = {}
        pricer = getattr(model, "cost_flowset", None)
        for key in sorted(exposure, key=lambda k: -exposure[k])[:topk]:
            task = rep[key]
            budget = budget_of(task.primitive)
            # the hot-spot map includes THIS task's own first-pass traffic
            # (the very bytes a win would reroute), so the sketch is a
            # bias, not a mandate: the sketched and unbiased schedules
            # both compete and the active cost model keeps the cheaper
            sched = DEFAULT_SYNTH_CACHE.schedule(topo, task, sketch)
            plain = DEFAULT_SYNTH_CACHE.schedule(topo, task, None)
            won_sketch[key] = sketch
            if sched is not plain and pricer is not None:
                if pricer(task, plain.to_flowset(job_id=task.job_id),
                          algorithm="synthesized") \
                        <= pricer(task, sched.to_flowset(job_id=task.job_id),
                                  algorithm="synthesized"):
                    sched, won_sketch[key] = plain, None
            extras = {"synthesized": sched.to_flowset(job_id=task.job_id)}
            q8 = codec_spec("q8")
            if q8.effective_error <= budget:
                extras["synthesized+q8"] = sched.to_flowset(
                    job_id=task.job_id, wire_ratio=q8.wire_ratio,
                    algorithm="synthesized+q8")
            sel = select_for_task(
                task, model, constraint=space.constraint_for(task.primitive),
                error_budget=budget, extra_flowsets=extras)
            sel_memo[key] = sel
            for t in placed.comm_tasks:
                if (t.primitive, t.size_bytes, t.group) != key:
                    continue
                if choices[t.task_id].algorithm != sel.algorithm:
                    changed = True
                _, codec = split_algorithm(sel.algorithm)
                choices[t.task_id] = TaskChoice(
                    t.task_id, t.primitive, t.size_bytes, t.group,
                    sel.algorithm, sel.cost, sel.costs, codec=codec,
                    wire_ratio=codec_spec(codec).wire_ratio if codec
                    else 1.0)
        if changed:
            sim = simulate_iteration(placed, comm_cost, policy)
            util, bytes_saved = traffic_map(won_sketch)
    hotspots = sorted(util.items(), key=lambda kv: -kv[1])[:problem.hotspot_k]

    return CodesignReport(
        jct=sim.jct, exposed_comm=sim.exposed_comm,
        compute_time=sim.compute_time, comm_time=sim.comm_time,
        policy=policy, cost_model=model_name, placement=pl,
        choices=[choices[t.task_id] for t in placed.comm_tasks],
        link_hotspots=hotspots, sim=sim,
        error_budget=error_budget, wire_bytes_saved=bytes_saved,
        task_exposed_s=dict(sim.task_exposed_s),
        timeline=list(sim.timeline))


# ---------------------------------------------------------------------------
# search(): walk the free knobs
# ---------------------------------------------------------------------------


def _assignment_value_json(v):
    """An assignment value in JSON form (placements as device lists)."""
    if isinstance(v, Placement):
        return _placement_to_dict(v)
    return v


def _assignment_value_from_json(v):
    """Inverse of :func:`_assignment_value_json`: serialized placements
    come back as real Placement objects, so a round-tripped result walks
    and talks like a live one."""
    if isinstance(v, dict) and {"devices", "strategy", "mesh"} <= set(v):
        return _placement_from_dict(v)
    return v


def _assignment_from_json(d: Mapping) -> Dict[str, object]:
    return {n: _assignment_value_from_json(v) for n, v in d.items()}


@dataclass
class Candidate:
    """One explored point of the plan space.  Only the search winner
    keeps its full ``report`` (and live sim trace); runners-up carry the
    headline metrics, their knob assignment, and the per-candidate
    telemetry record (which search phase priced it, why it was ruled
    infeasible, how often deduplication re-served it)."""

    assignment: Dict[str, object]
    jct: float
    exposed_comm: float
    worst_link_bytes: float
    feasible: bool
    report: Optional[CodesignReport] = None
    key: Optional[Tuple[float, ...]] = None  # objective key, not serialized
    # telemetry (repro_torch.obs): infeasibility reason (None = feasible),
    # which search phase first priced this point, and how many times the
    # walk asked for it (1 = priced once, >1 = memo re-served)
    reason: Optional[str] = None
    phase: str = "sweep"
    requests: int = 1

    def to_dict(self) -> Dict:
        return {
            "assignment": {n: _assignment_value_json(v)
                           for n, v in self.assignment.items()},
            "jct": self.jct, "exposed_comm": self.exposed_comm,
            "worst_link_bytes": self.worst_link_bytes,
            "feasible": self.feasible,
            "reason": self.reason, "phase": self.phase,
            "requests": self.requests,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "Candidate":
        return cls(assignment=_assignment_from_json(d["assignment"]),
                   jct=d["jct"], exposed_comm=d["exposed_comm"],
                   worst_link_bytes=d["worst_link_bytes"],
                   feasible=d["feasible"], report=None,
                   reason=d.get("reason"), phase=d.get("phase", "sweep"),
                   requests=d.get("requests", 1))


@dataclass
class SearchResult:
    """What ``search()`` hands back: the winning plan, the frontier it
    explored, and which knob bought how much of the win."""

    best: CodesignReport
    best_assignment: Dict[str, object]
    frontier: List[Candidate]
    # knob -> JCT the best plan saves vs reverting that one knob to its
    # baseline (Choice: the first option; placement Search: "packed")
    attribution: Dict[str, float]
    evaluated: int
    budget: int
    truncated: bool = False  # budget ran out before the walk finished
    # search telemetry (repro_torch.obs.meters): plan evaluations, memo
    # re-serves, and the cost models' cache counters (FlowSim hit/miss
    # per switch-capacity bucket + hit rates)
    telemetry: Dict[str, object] = field(default_factory=dict)

    @property
    def best_jct(self) -> float:
        return self.best.jct

    def to_dict(self) -> Dict:
        return {
            "best": self.best.to_dict(),
            "best_assignment": {n: _assignment_value_json(v)
                                for n, v in self.best_assignment.items()},
            "frontier": [c.to_dict() for c in self.frontier],
            "attribution": dict(self.attribution),
            "evaluated": self.evaluated, "budget": self.budget,
            "truncated": self.truncated,
            "telemetry": dict(self.telemetry),
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "SearchResult":
        return cls(best=CodesignReport.from_dict(d["best"]),
                   best_assignment=_assignment_from_json(
                       d["best_assignment"]),
                   frontier=[Candidate.from_dict(c) for c in d["frontier"]],
                   attribution=dict(d["attribution"]),
                   evaluated=d["evaluated"], budget=d["budget"],
                   truncated=d["truncated"],
                   telemetry=dict(d.get("telemetry", {})))

    def to_trace(self, topo=None, **kw):
        """This search as a Perfetto trace: the winner's full tracks plus
        the frontier/telemetry on a search process
        (``repro_torch.obs.trace.trace_from_search``)."""
        from repro_torch.obs.trace import trace_from_search
        return trace_from_search(self.to_dict(), topo=topo, **kw)


def _bucket_candidates(problem: CodesignProblem,
                       seeds: Tuple = ()) -> List[Optional[int]]:
    """Candidate sizes for ``bucket_bytes=Search()``: ``None`` first (the
    legacy per-layer baseline attribution reverts to), then a geometric
    ladder total/2^k over the job's gradient-sync bytes — the classic
    MG-WFBP/ByteScheduler fusion space, whole-model sync down to fine
    buckets.  Deterministic; ``seeds`` appends explicit extra sizes."""
    demand = build_demand(problem.cfg, problem.shape, problem.mesh,
                          problem.dp_params)
    total = sum(t.size_bytes for t in demand.comm_tasks
                if t.axis == "data" and t.before_compute == "opt")
    floor = 1 << 20  # below ~1 MiB per bucket alpha always dominates
    out: List[Optional[int]] = [None]
    if total:
        for k in (1, 2, 4, 8, 16, 32):
            v = max(total // k, floor)
            if v not in out:
                out.append(v)
    for s in seeds or ():
        if s not in out:
            out.append(int(s))
    return out


def _stagger_candidates(problem: CodesignProblem,
                        seeds: Tuple = ()) -> List[float]:
    """Candidate phase offsets for ``stagger=Search()`` on a serving
    problem: 0 first (the naive co-tenant baseline attribution reverts
    to), then an even grid over the first co-tenant training pulse's
    period — the CASSINI insight applied to the serving admission clock.
    Deterministic; ``seeds`` appends explicit extra offsets."""
    spec = problem.serving
    cotenants = getattr(spec, "cotenants", ()) if spec is not None else ()
    out: List[float] = [0.0]
    if cotenants:
        period = cotenants[0].period_s
        grid = 8
        for i in range(1, grid):
            out.append(i * period / grid)
    for s in seeds or ():
        v = float(s)
        if v not in out:
            out.append(v)
    return out


def _canon(value) -> Tuple:
    """Hashable identity of an assignment value (dedup key)."""
    if isinstance(value, Placement):
        return ("placement", value.devices)
    if isinstance(value, dict):
        return ("dict", tuple(sorted(value.items())))
    return ("value", value)


def search(problem: CodesignProblem, budget: int = 32,
           seeds_dir: Optional[str] = None) -> SearchResult:
    """Walk the free knobs of ``problem.space`` and return the best plan.

    ``Choice`` knobs are enumerated (Cartesian product, declaration
    order); ``placement=Search()`` additionally pulls heuristic
    candidates from ``codesign.placement_search`` and, with budget left,
    refines the incumbent with a hot-spot-guided swap-neighborhood hill
    climb.  Every candidate is priced by ``plan()`` through one shared
    cost model per switch-capacity value, so FlowSim memoization spans
    the whole walk.  ``budget`` caps the number of full plan
    evaluations; per-knob attribution baselines are priced on top (at
    most one extra evaluation per free knob).

    ``seeds_dir`` persists searched plans per (topology, model, mesh):
    a previous run's winning assignment is loaded as a warm start (the
    first candidate priced, phase ``"warm_start"``), and this run's
    winner is saved back — ``codesign.seeds``.

    Deterministic by construction: no randomness, stable enumeration and
    neighbor order — the same problem and budget always return the same
    best plan."""
    if budget < 1:
        raise ValueError(f"search budget must be >= 1, got {budget}")
    from repro_torch.codesign.placement_search import (heuristic_placements,
                                                       swap_neighbors)
    space = problem.space
    free = space.free_knobs()
    synth_base = DEFAULT_SYNTH_CACHE.meters.snapshot()

    # candidate values per enumerable knob, declaration order
    axes: Dict[str, List] = {}
    placement_open = False  # Search(): swap-walk refinement after sweep
    for name, knob in free.items():
        if isinstance(knob, Choice):
            axes[name] = list(knob.options)
        elif name == "placement":  # Search
            placement_open = True
            axes[name] = heuristic_placements(problem.mesh, problem.topo,
                                              seeds=knob.seeds)
        elif name == "bucket_bytes":  # Search: geometric bucket ladder
            axes[name] = _bucket_candidates(problem, knob.seeds)
        elif name == "decompose":  # Search: bulk baseline, then rewritten
            axes[name] = [False, True]
        elif name == "stagger":  # Search: grid over the co-tenant period
            axes[name] = _stagger_candidates(problem, knob.seeds)
        elif name == "synthesize":  # Search: registry-only, then + synth
            axes[name] = [False, True]
        else:
            raise ValueError(
                f"knob {name!r} is Search() but only placement, "
                f"bucket_bytes, decompose, stagger and synthesize have "
                f"candidate generators — use Choice(...) for it")
    pinned = {name: knob.value
              for name, knob in space.scalar_knobs().items()
              if name not in axes}

    # one resolved cost model per switch-capacity value: memoization
    # spans every candidate priced under the same aggregation budget
    models: Dict[Tuple, Tuple[CostModel, str]] = {}

    def model_for(cap) -> Tuple[CostModel, str]:
        key = _canon(cap)
        if key not in models:
            models[key] = _resolve_cost_model(problem.cost_model,
                                              problem.topo, cap)
        return models[key]

    objective = problem.objective
    seen: Dict[Tuple, Candidate] = {}
    order: List[Candidate] = []
    state = {"evaluated": 0, "memo_hits": 0}

    def evaluate(assignment: Dict[str, object], charge: bool = True,
                 phase: str = "sweep") -> Candidate:
        key = tuple((n, _canon(assignment[n])) for n in sorted(assignment))
        if key in seen:
            cand = seen[key]
            cand.requests += 1
            state["memo_hits"] += 1
            return cand
        values = dict(pinned)
        values.update(assignment)
        prob = problem.pinned(**values)
        report = plan(prob, _resolved=model_for(values["switch_capacity"]))
        reason = objective.infeasible_reason(report)
        feasible = reason is None
        cand = Candidate(assignment=dict(assignment), jct=report.jct,
                         exposed_comm=report.exposed_comm,
                         worst_link_bytes=report.worst_link_bytes,
                         feasible=feasible, report=report,
                         key=objective.key(report), reason=reason,
                         phase=phase)
        seen[key] = cand
        order.append(cand)
        if charge:
            state["evaluated"] += 1
        return cand

    def better(a: Candidate, b: Optional[Candidate]) -> bool:
        if b is None:
            return True
        if a.feasible != b.feasible:
            return a.feasible
        return a.key < b.key

    best: Optional[Candidate] = None

    def consider(cand: Candidate) -> None:
        """Advance the incumbent; losers drop their full report right
        away so peak memory stays at one live report, not one per
        explored candidate."""
        nonlocal best
        if better(cand, best):
            if best is not None:
                best.report = None
            best = cand
        elif cand is not best:
            cand.report = None

    # --- phase 0: warm start from a persisted seed -----------------------
    names = list(axes)
    truncated = False
    if seeds_dir is not None and names:
        from repro_torch.codesign.seeds import load_seed
        warm = load_seed(seeds_dir, problem)
        if warm is not None and set(warm) == set(names):
            consider(evaluate(warm, phase="warm_start"))

    # --- phase 1: enumerate the Choice/heuristic sweep -------------------
    if names:
        for combo in itertools.product(*(axes[n] for n in names)):
            if state["evaluated"] >= budget:
                truncated = True
                break
            consider(evaluate(dict(zip(names, combo))))
    else:
        best = evaluate({})

    # --- phase 2: swap-neighborhood hill climb on the placement ----------
    if placement_open and best is not None:
        improved = True
        while improved:
            improved = False
            incumbent = best.assignment["placement"]
            if not isinstance(incumbent, Placement):
                incumbent = place_mesh(problem.mesh, problem.topo,
                                       strategy=incumbent)
            for nb in swap_neighbors(incumbent, problem.topo,
                                     report=best.report):
                if state["evaluated"] >= budget:
                    truncated = True
                    break
                prev = best
                consider(evaluate({**best.assignment, "placement": nb},
                                  phase="hillclimb"))
                if best is not prev:
                    improved = True
                    break

    if best is None or not best.feasible:
        hint = "" if best is None else \
            f" (best infeasible plan: {best.reason})"
        raise ValueError(f"search found no feasible plan within "
                         f"budget={budget}{hint}")

    # --- per-knob attribution: revert one knob to its baseline -----------
    baselines: Dict[str, object] = {}
    for name in names:
        knob = free[name]
        # Choice: the declared first option; placement Search: the first
        # heuristic candidate, which heuristic_placements pins to packed
        baselines[name] = knob.options[0] if isinstance(knob, Choice) \
            else axes[name][0]
    attribution: Dict[str, float] = {}
    for name, base_value in baselines.items():
        if _canon(best.assignment[name]) == _canon(base_value):
            attribution[name] = 0.0
            continue
        reverted = evaluate({**best.assignment, name: base_value},
                            charge=False, phase="baseline")
        # objective-primary delta (== JCT delta for the default training
        # objective; TTFT-p99 delta for a latency-SLO serving objective)
        attribution[name] = reverted.key[0] - best.key[0]
        if reverted is not best:
            reverted.report = None

    if seeds_dir is not None and names:
        from repro_torch.codesign.seeds import save_seed
        save_seed(seeds_dir, problem, best.assignment)

    frontier = sorted(order, key=lambda c: (not c.feasible, c.key))
    telemetry = _search_telemetry(state, order, models)
    # synthesis-solver cache counters, as THIS search's delta against the
    # process-wide cache (repeated identical runs then report identical
    # numbers, which the bench guards rely on)
    synth_now = DEFAULT_SYNTH_CACHE.meters.snapshot()
    hits = synth_now.get("synth.hit", 0.0) - synth_base.get("synth.hit", 0.0)
    misses = synth_now.get("synth.miss", 0.0) \
        - synth_base.get("synth.miss", 0.0)
    if hits + misses > 0:
        counters = telemetry["counters"]
        counters["synth.hit"] = hits
        counters["synth.miss"] = misses
        counters["synth.entries"] = \
            DEFAULT_SYNTH_CACHE.cache_stats()["synth.entries"]
        telemetry["synth_hit_rate"] = hits / (hits + misses)
    return SearchResult(
        best=best.report, best_assignment=dict(best.assignment),
        frontier=frontier, attribution=attribution,
        evaluated=state["evaluated"], budget=budget, truncated=truncated,
        telemetry=telemetry)


def _search_telemetry(state: Dict, order: List[Candidate],
                      models: Dict) -> Dict[str, object]:
    """The walk's deterministic counters (``repro_torch.obs``): how many plans
    were priced vs re-served from the assignment memo, the feasibility
    split, and the cost models' cache counters — FlowSim hit/miss per
    switch-capacity bucket plus an overall cost-memo hit rate."""
    counters: Dict[str, float] = {}
    for model, _name in models.values():
        stats = getattr(model, "cache_stats", None)
        if stats is None:
            continue
        # bucket-labelled keys are disjoint across models (one FlowSim
        # per switch capacity), so a plain merge keeps buckets apart
        counters.update(stats())
    hits = sum(v for k, v in counters.items() if k.endswith(".cost.hit"))
    misses = sum(v for k, v in counters.items()
                 if k.endswith(".cost.miss"))
    out: Dict[str, object] = {
        "plan_evals": len(order),
        "charged_evals": state["evaluated"],
        "memo_hits": state["memo_hits"],
        "infeasible": sum(1 for c in order if not c.feasible),
        "counters": {k: counters[k] for k in sorted(counters)},
    }
    if hits + misses > 0:
        out["flowsim_cost_hit_rate"] = hits / (hits + misses)
    return out
