"""Serving co-design: inference as a first-class workload in the plan space.

The engine so far optimizes training JCT; the survey's workload-dependence
argument (communication scheduling must fit the traffic class) means
latency-SLO serving needs its own demand shape, its own objective, and its
own time base:

  * **Demand** — a request is a *prefill* phase (full-sequence forward on a
    prefill group: TP All-Reduce per layer, MoE All-to-All), a *KV hand-off*
    (each prefill rank ships its KV-cache shard to a decode rank — a ``p2p``
    CommTask routed through ``net.Topology`` like any collective), and a
    *decode* loop (one-token steps on a decode group under continuous
    batching).  Both phase graphs are priced through the same
    ``ccl.select`` / ``sched.tasks`` pipeline as training iterations.
  * **Objective** — TTFT/TPOT percentiles and goodput under an open-loop
    arrival process (``sched.arrivals``), not JCT.  The metrics register
    into the shared registry (``codesign.report.OBJECTIVE_METRICS``) so
    ``Objective(minimize="ttft_p99", constraints={"tpot_p99": ...})`` is
    validated exactly like a training objective.
  * **Time base** — arrivals are open-loop, so ``plan_serving`` runs a
    deterministic queueing simulation: FIFO prefill batching, slot-based
    continuous-batching decode, with co-tenant training pulses
    (:class:`CotenantPulse`) contending on shared links under the same
    rate law as ``sched.flows`` (rate = min over links of 1/total demand).
    The ``stagger`` knob shifts the co-tenant pulses' phase against the
    serving admission clock — the CASSINI lever, now SLO-aware.

``serving_problem(spec, topo)`` builds a ``CodesignProblem`` whose
``plan()``/``search()`` speak :class:`ServingReport` instead of
``CodesignReport``.

The port's copy of ``repro.codesign.serving``, kept line for line:
importing any ``repro`` module runs the JAX package's ``__init__``, which
imports jax, so the port keeps its own.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.ccl.select import CostModel, Selection, flows_on_topology, \
    select_for_task
from repro_torch.compress.codec import codec_spec, split_algorithm
from repro_torch.core.demand import CommDemand, CommTask
from repro_torch.core.demand_builder import DemandParams, build_demand
from repro_torch.core.types import MeshConfig, ModelConfig, ShapeConfig
from repro_torch.net.simulate import link_utilization
from repro_torch.net.topology import Topology
from repro_torch.sched.arrivals import (Arrival, arrivals_from_dict,
                                        arrivals_to_dict, offered_load)
from repro_torch.sched.tasks import simulate_iteration

from repro_torch.codesign.api import (CodesignProblem, Objective, PlanSpace,
                                      _resolve_cost_model)
from repro_torch.codesign.placement import Placement, place_mesh
from repro_torch.codesign.report import (CodesignReport, TaskChoice, _link_key,
                                         _parse_link_key, register_metric)

# SLO metrics join the shared objective registry at import (the codesign
# package imports this module, so `Objective(minimize="ttft_p99")` works
# as soon as `repro_torch.codesign` is loaded).  True = bigger-is-better.
SERVING_METRICS: Dict[str, bool] = {
    "ttft_p50": False, "ttft_p95": False, "ttft_p99": False,
    "tpot_p50": False, "tpot_p99": False,
    "goodput": True, "slo_attainment": True,
}
for _name, _maximize in SERVING_METRICS.items():
    register_metric(_name, maximize=_maximize)


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ServingSLO:
    """Latency targets a request must meet to count toward goodput:
    time-to-first-token and time-per-output-token, both in seconds."""

    ttft_s: float = 0.5
    tpot_s: float = 0.05

    def to_dict(self) -> Dict[str, float]:
        return {"ttft_s": self.ttft_s, "tpot_s": self.tpot_s}

    @classmethod
    def from_dict(cls, d: Mapping[str, float]) -> "ServingSLO":
        return cls(ttft_s=float(d["ttft_s"]), tpot_s=float(d["tpot_s"]))


@dataclass(frozen=True)
class CotenantPulse:
    """A co-tenant training job's periodic communication pulse as the
    serving tenant sees it: every ``period_s`` seconds, for ``comm_s``
    seconds starting at ``phase_s``, the tenant loads the listed links
    with ``demand`` (fraction of link bandwidth, the ``sched.flows``
    convention)."""

    name: str
    period_s: float
    comm_s: float
    phase_s: float = 0.0
    demand: Mapping[Tuple, float] = field(default_factory=dict)

    def __post_init__(self):
        if self.period_s <= 0:
            raise ValueError(f"period_s must be > 0, got {self.period_s}")
        if self.comm_s < 0:
            raise ValueError(f"comm_s must be >= 0, got {self.comm_s}")

    def active_at(self, t: float) -> bool:
        return (t - self.phase_s) % self.period_s < self.comm_s

    def next_boundary(self, t: float) -> float:
        """Next instant the pulse turns on or off after ``t``."""
        u = (t - self.phase_s) % self.period_s
        if u < self.comm_s:
            return t + (self.comm_s - u)
        return t + (self.period_s - u)

    def to_dict(self) -> Dict[str, object]:
        return {"name": self.name, "period_s": self.period_s,
                "comm_s": self.comm_s, "phase_s": self.phase_s,
                "demand": {_link_key(l): f for l, f in self.demand.items()}}

    @classmethod
    def from_dict(cls, d: Mapping[str, object]) -> "CotenantPulse":
        return cls(name=str(d["name"]), period_s=float(d["period_s"]),
                   comm_s=float(d["comm_s"]), phase_s=float(d["phase_s"]),
                   demand={_parse_link_key(k): float(f)
                           for k, f in dict(d["demand"]).items()})


@dataclass(frozen=True)
class ServingSpec:
    """One serving tenant: the model, its prefill/decode disaggregation,
    the offered load, and the SLO it must hold.

    ``prompt_tokens``/``decode_tokens`` are the *representative* request
    mix the phase graphs are priced at (per-request budgets in a trace may
    vary; timing uses each arrival's own decode budget).  ``cotenants``
    are the training pulses sharing this tenant's fabric — ``plan_cluster``
    fills them from the co-scheduled jobs' link demand maps."""

    name: str
    cfg: ModelConfig
    prefill_devices: int
    decode_devices: int
    arrivals: object  # PoissonArrivals | TraceArrivals
    slo: ServingSLO = field(default_factory=ServingSLO)
    prompt_tokens: int = 0   # 0 -> from the arrival process (or 512)
    decode_tokens: int = 0   # 0 -> from the arrival process (or 128)
    prefill_batch: int = 4
    decode_slots: int = 16
    horizon_s: float = 10.0
    cotenants: Tuple[CotenantPulse, ...] = ()
    dp_params: DemandParams = field(default_factory=DemandParams)

    def __post_init__(self):
        if self.prefill_devices < 1 or self.decode_devices < 1:
            raise ValueError("serving needs >=1 prefill and >=1 decode "
                             "device")
        if self.prefill_batch < 1 or self.decode_slots < 1:
            raise ValueError("prefill_batch and decode_slots must be >= 1")
        if not self.prompt_tokens:
            object.__setattr__(self, "prompt_tokens",
                               getattr(self.arrivals, "prompt_tokens", 512))
        if not self.decode_tokens:
            object.__setattr__(self, "decode_tokens",
                               getattr(self.arrivals, "decode_tokens", 128))

    @property
    def num_devices(self) -> int:
        return self.prefill_devices + self.decode_devices

    def mesh(self) -> MeshConfig:
        """The carve mesh: one flat ``serve`` axis over prefill + decode
        devices (the placement layer maps it onto the topology; rank-wise
        groups keep prefill ranks 0..P-1 and decode ranks P..P+D-1)."""
        return MeshConfig(shape=(self.num_devices,), axis_names=("serve",),
                          data_axes=(), model_axes=("serve",))

    def to_dict(self) -> Dict[str, object]:
        return {
            "name": self.name, "model": self.cfg.name,
            "prefill_devices": self.prefill_devices,
            "decode_devices": self.decode_devices,
            "arrivals": arrivals_to_dict(self.arrivals),
            "slo": self.slo.to_dict(),
            "prompt_tokens": self.prompt_tokens,
            "decode_tokens": self.decode_tokens,
            "prefill_batch": self.prefill_batch,
            "decode_slots": self.decode_slots,
            "horizon_s": self.horizon_s,
            "cotenants": [c.to_dict() for c in self.cotenants],
        }


def kv_bytes_per_token(cfg: ModelConfig, act_bytes: int = 2) -> int:
    """KV-cache footprint of one token across the whole stack — the
    payload the prefill->decode hand-off moves per prompt token.  MLA
    caches the compressed latent (+ rope key) per layer; GQA caches
    K and V per kv-head.  Mamba layers keep recurrent state instead of a
    token-indexed cache and contribute nothing per-token."""
    if cfg.attention == "mla":
        per_layer = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    else:
        per_layer = 2 * cfg.num_kv_heads * cfg.resolved_head_dim
    n_attn = sum(1 for s in cfg.layer_specs()
                 if s.mixer in ("attn", "cross_attn"))
    return int(n_attn * per_layer * act_bytes)


# ---------------------------------------------------------------------------
# Phase pricing: a placed serving demand through the CCL + sched layers
# ---------------------------------------------------------------------------


def _price_phase(placed: CommDemand, pl: Placement, model: CostModel,
                 space: PlanSpace, policy: str, model_name: str,
                 topo: Topology, hotspot_k: int,
                 error_budget: Union[float, Dict[str, float]]
                 ) -> Tuple[CodesignReport, Dict[Tuple, float]]:
    """One serving phase graph (prefill batch or decode step) through
    per-task selection, iteration simulation, and link accounting —
    ``codesign.api.plan``'s core, for a pre-built placed demand (serving
    groups are rank-wise, so there is no replica fan-out)."""

    def budget_of(primitive: str) -> float:
        if isinstance(error_budget, dict):
            return error_budget.get(primitive, 0.0)
        return error_budget

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

    sim = simulate_iteration(
        placed, lambda t: (choices[t.task_id].cost_s,
                           choices[t.task_id].algorithm), policy)

    util: Dict[Tuple, float] = {}
    fs_memo: Dict[Tuple, object] = {}
    for task in placed.comm_tasks:
        algo = choices[task.task_id].algorithm
        key = (task.primitive, algo, task.size_bytes, task.group)
        fs = fs_memo.get(key)
        if fs is None:
            fs = flows_on_topology(topo, task, algo)
            fs_memo[key] = fs
        for link, nbytes in link_utilization(topo, fs).items():
            util[link] = util.get(link, 0.0) + nbytes
    hotspots = sorted(util.items(), key=lambda kv: -kv[1])[:hotspot_k]

    report = CodesignReport(
        jct=sim.jct, exposed_comm=sim.exposed_comm,
        compute_time=sim.compute_time, comm_time=sim.comm_time,
        policy=policy, cost_model=model_name, placement=pl,
        choices=[choices[t.task_id] for t in placed.comm_tasks],
        link_hotspots=hotspots, sim=sim, error_budget=error_budget,
        task_exposed_s=dict(sim.task_exposed_s),
        timeline=list(sim.timeline))
    return report, util


# ---------------------------------------------------------------------------
# Contention-aware time advance (the sched.flows rate law, open-loop)
# ---------------------------------------------------------------------------


def _advance(t: float, compute_s: float, comm_s: float,
             demand: Mapping[Tuple, float],
             pulses: Sequence[CotenantPulse]) -> float:
    """Finish time of one serving work item started at ``t``: compute
    first (never contended), then ``comm_s`` of communication slowed by
    whichever co-tenant pulses are active on shared links.  Same rate law
    as ``sched.flows._simulate_links``: rate = min over the phase's links
    of min(1, 1 / total demand), piecewise-constant between pulse
    boundaries."""
    t += compute_s
    remaining = comm_s
    if remaining <= 0.0:
        return t
    live = [p for p in pulses
            if p.comm_s > 0 and any(l in demand for l in p.demand)]
    if not live or not demand:
        return t + remaining
    guard = 0
    while remaining > 1e-12:
        guard += 1
        if guard > 1_000_000:
            raise RuntimeError("serving contention advance livelock")
        rate = 1.0
        for link, f in demand.items():
            tot = f
            for p in live:
                if link in p.demand and p.active_at(t):
                    tot += p.demand[link]
            if tot > 1.0:
                rate = min(rate, 1.0 / tot)
        nb = min(p.next_boundary(t) for p in live)
        # fp guard: a boundary can land on t to within rounding, which
        # would advance neither t nor remaining — force progress
        nb = max(nb, t + max(abs(t), 1.0) * 1e-12)
        if t + remaining / rate <= nb + 1e-15:
            return t + remaining / rate
        remaining -= (nb - t) * rate
        t = nb
    return t


def _percentile(vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (deterministic, no interpolation)."""
    if not vals:
        return 0.0
    s = sorted(vals)
    k = max(0, min(len(s) - 1, math.ceil(q * len(s)) - 1))
    return s[k]


# ---------------------------------------------------------------------------
# ServingReport
# ---------------------------------------------------------------------------


@dataclass
class ServingReport:
    """What ``plan_serving`` hands back: SLO metrics under the arrival
    process, per-request lifecycle spans, and the priced phase reports.

    Exposes the registered serving metrics (``ttft_p99``, ``goodput``,
    ...) plus the training-metric names the search bookkeeping reads
    (``jct`` = mean end-to-end request latency — the documented stand-in;
    ``exposed_comm``; ``worst_link_bytes``), so a serving problem drops
    into ``search()`` unchanged."""

    name: str
    cost_model: str
    slo: ServingSLO
    stagger_s: float
    horizon_s: float
    offered_rps: float
    goodput_rps: float
    slo_attainment: float
    ttft: Dict[str, float]
    tpot: Dict[str, float]
    kv_bytes_per_request: int
    # per-request lifecycle: rid, t_arrive, t_prefill (admission into the
    # prefill batch), t_first (first output token), t_finish, ttft, tpot,
    # slo_ok — the spans trace_from_serving renders
    requests: List[Dict[str, object]] = field(default_factory=list)
    prefill: Optional[CodesignReport] = None
    decode: Optional[CodesignReport] = None
    link_hotspots: List[Tuple[Tuple, float]] = field(default_factory=list)

    # -- registered serving metrics ------------------------------------
    @property
    def ttft_p50(self) -> float:
        return self.ttft["p50"]

    @property
    def ttft_p95(self) -> float:
        return self.ttft["p95"]

    @property
    def ttft_p99(self) -> float:
        return self.ttft["p99"]

    @property
    def tpot_p50(self) -> float:
        return self.tpot["p50"]

    @property
    def tpot_p99(self) -> float:
        return self.tpot["p99"]

    @property
    def goodput(self) -> float:
        return self.goodput_rps

    # -- training-metric views for the shared search bookkeeping -------
    @property
    def jct(self) -> float:
        """Mean end-to-end request latency (arrival -> last token) — the
        closest JCT analogue an open-loop workload has."""
        if not self.requests:
            return 0.0
        return sum(r["t_finish"] - r["t_arrive"] for r in self.requests) \
            / len(self.requests)

    @property
    def exposed_comm(self) -> float:
        pf = self.prefill.exposed_comm if self.prefill else 0.0
        dc = self.decode.exposed_comm if self.decode else 0.0
        return pf + dc

    @property
    def comm_time(self) -> float:
        pf = self.prefill.comm_time if self.prefill else 0.0
        dc = self.decode.comm_time if self.decode else 0.0
        return pf + dc

    @property
    def compute_time(self) -> float:
        pf = self.prefill.compute_time if self.prefill else 0.0
        dc = self.decode.compute_time if self.decode else 0.0
        return pf + dc

    @property
    def worst_link_bytes(self) -> float:
        return self.link_hotspots[0][1] if self.link_hotspots else 0.0

    def slo_violations(self) -> List[Dict[str, object]]:
        """The requests that missed the SLO (for traces and debugging)."""
        return [r for r in self.requests if not r["slo_ok"]]

    # -- JSON persistence ----------------------------------------------
    def to_dict(self) -> Dict:
        return {
            "name": self.name, "cost_model": self.cost_model,
            "slo": self.slo.to_dict(), "stagger_s": self.stagger_s,
            "horizon_s": self.horizon_s, "offered_rps": self.offered_rps,
            "goodput_rps": self.goodput_rps,
            "slo_attainment": self.slo_attainment,
            "ttft": dict(self.ttft), "tpot": dict(self.tpot),
            "kv_bytes_per_request": self.kv_bytes_per_request,
            "requests": [dict(r) for r in self.requests],
            "prefill": self.prefill.to_dict() if self.prefill else None,
            "decode": self.decode.to_dict() if self.decode else None,
            "link_hotspots": {_link_key(l): b
                              for l, b in self.link_hotspots},
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "ServingReport":
        return cls(
            name=d["name"], cost_model=d["cost_model"],
            slo=ServingSLO.from_dict(d["slo"]),
            stagger_s=d["stagger_s"], horizon_s=d["horizon_s"],
            offered_rps=d["offered_rps"], goodput_rps=d["goodput_rps"],
            slo_attainment=d["slo_attainment"],
            ttft=dict(d["ttft"]), tpot=dict(d["tpot"]),
            kv_bytes_per_request=d["kv_bytes_per_request"],
            requests=[dict(r) for r in d["requests"]],
            prefill=CodesignReport.from_dict(d["prefill"])
            if d.get("prefill") else None,
            decode=CodesignReport.from_dict(d["decode"])
            if d.get("decode") else None,
            link_hotspots=[(_parse_link_key(k), b)
                           for k, b in d["link_hotspots"].items()])

    def to_trace(self, topo=None, **kw):
        """Request-lifetime spans + SLO-violation instants as a
        Perfetto-loadable ``repro_torch.obs.trace.Trace``."""
        from repro_torch.obs.trace import trace_from_serving
        return trace_from_serving(self.to_dict(), topo=topo, **kw)


# ---------------------------------------------------------------------------
# plan_serving
# ---------------------------------------------------------------------------


def plan_serving(problem: CodesignProblem,
                 _resolved: Optional[Tuple[CostModel, str]] = None
                 ) -> ServingReport:
    """Price one serving plan end to end:

      1. carve prefill + decode groups from the placement knob;
      2. build + price the prefill batch graph (TP collectives, MoE
         All-to-All, per-rank KV ``p2p`` hand-off) and the one-token
         decode step graph through the shared CCL/network layers;
      3. replay the arrival process through a deterministic queueing
         simulation — FIFO prefill batching, slot-based continuous
         decode — with co-tenant pulses contending on shared links
         (shifted by the ``stagger`` knob);
      4. fold per-request TTFT/TPOT into percentiles, goodput, and SLO
         attainment."""
    spec = problem.serving
    if spec is None:
        raise ValueError("plan_serving needs problem.serving "
                         "(a ServingSpec); use serving_problem(...)")
    space = problem.space
    free = space.free_knobs()
    if free:
        raise ValueError(
            f"plan_serving() needs every scalar knob Fixed, but "
            f"{sorted(free)} are free — use search(problem)")
    topo = problem.topo
    placement = space.placement.value
    policy = space.policy.value
    error_budget = space.error_budget.value
    switch_capacity = space.switch_capacity.value
    stagger = float(space.stagger.value or 0.0)

    P, D = spec.prefill_devices, spec.decode_devices
    mesh = spec.mesh()
    pl = placement if isinstance(placement, Placement) else \
        place_mesh(mesh, topo, strategy=placement)
    if len(pl.devices) != P + D:
        raise ValueError(
            f"serving placement covers {len(pl.devices)} devices but spec "
            f"{spec.name} needs {P}+{D}")
    model, model_name = _resolved if _resolved is not None else \
        _resolve_cost_model(problem.cost_model, topo, switch_capacity)
    prefill_dev = pl.devices[:P]
    decode_dev = pl.devices[P:]

    # --- phase graphs -----------------------------------------------------
    pf_mesh = MeshConfig(shape=(P,), axis_names=("model",), data_axes=(),
                         model_axes=("model",))
    pf_shape = ShapeConfig(f"{spec.name}-prefill", spec.prompt_tokens,
                           spec.prefill_batch, "prefill")
    pf_demand = build_demand(spec.cfg, pf_shape, pf_mesh, spec.dp_params)
    pf_pl = Placement(mesh=pf_mesh, devices=prefill_dev,
                      strategy=pl.strategy, topology=topo.name)
    pf_placed = pf_pl.place_demand(pf_demand)
    pf_placed.comm_tasks = [dataclasses.replace(t, phase="prefill")
                            for t in pf_placed.comm_tasks]
    kv_req = spec.prompt_tokens * kv_bytes_per_token(
        spec.cfg, spec.dp_params.act_bytes)
    kv_batch = spec.prefill_batch * kv_req
    for i in range(P):
        src, dst = prefill_dev[i], decode_dev[i % D]
        pf_placed.comm_tasks.append(CommTask(
            f"kv{i}", "p2p", max(1, kv_batch // P), (src, dst),
            after_compute=("head",), job_id=pf_placed.job_id, phase="kv"))

    dec_mesh = MeshConfig(shape=(D,), axis_names=("model",), data_axes=(),
                          model_axes=("model",))
    dec_shape = ShapeConfig(f"{spec.name}-decode", 1, spec.decode_slots,
                            "decode")
    dec_demand = build_demand(spec.cfg, dec_shape, dec_mesh, spec.dp_params)
    dec_pl = Placement(mesh=dec_mesh, devices=decode_dev,
                       strategy=pl.strategy, topology=topo.name)
    dec_placed = dec_pl.place_demand(dec_demand)
    dec_placed.comm_tasks = [dataclasses.replace(t, phase="decode")
                             for t in dec_placed.comm_tasks]

    prefill_report, pf_util = _price_phase(
        pf_placed, pf_pl, model, space, policy, model_name, topo,
        problem.hotspot_k, error_budget)
    decode_report, dec_util = _price_phase(
        dec_placed, dec_pl, model, space, policy, model_name, topo,
        problem.hotspot_k, error_budget)

    # --- per-phase link demand fractions (the sched.flows convention) -----
    def fracs(util: Dict[Tuple, float], comm_s: float) -> Dict[Tuple, float]:
        out: Dict[Tuple, float] = {}
        for link, nbytes in util.items():
            bw = topo.link_bw(*link)
            if comm_s > 0 and bw > 0:
                out[link] = min(1.0, nbytes / (bw * comm_s))
        return out

    pf_comm = min(prefill_report.comm_time, prefill_report.jct)
    pf_compute = max(0.0, prefill_report.jct - pf_comm)
    pf_fracs = fracs(pf_util, pf_comm)
    dec_comm = min(decode_report.comm_time, decode_report.jct)
    dec_compute = max(0.0, decode_report.jct - dec_comm)
    dec_fracs = fracs(dec_util, dec_comm)

    pulses = tuple(dataclasses.replace(p, phase_s=p.phase_s + stagger)
                   for p in spec.cotenants)

    # --- open-loop queueing simulation ------------------------------------
    arrivals = tuple(spec.arrivals.sample(spec.horizon_s))
    recs: Dict[str, Dict[str, object]] = {}

    # prefill: FIFO server, batches of up to prefill_batch
    pending: List[Arrival] = []
    done_prefill: List[Tuple[float, Arrival]] = []
    i = 0
    t_free = 0.0
    while i < len(arrivals) or pending:
        if not pending:
            t_free = max(t_free, arrivals[i].t)
        while i < len(arrivals) and arrivals[i].t <= t_free + 1e-12:
            pending.append(arrivals[i])
            i += 1
        batch = pending[:spec.prefill_batch]
        del pending[:len(batch)]
        finish = _advance(t_free, pf_compute, pf_comm, pf_fracs, pulses)
        for a in batch:
            recs[a.rid] = {"rid": a.rid, "t_arrive": a.t,
                           "t_prefill": t_free, "t_first": None,
                           "t_finish": None}
            done_prefill.append((finish, a))
        t_free = finish

    # decode: slot-based continuous batching, variable step duration
    done_prefill.sort(key=lambda fa: (fa[0], fa[1].rid))
    active: Dict[str, int] = {}
    started: Dict[str, float] = {}
    j = 0
    t = 0.0
    while j < len(done_prefill) or active:
        if not active:
            t = max(t, done_prefill[j][0])
        while j < len(done_prefill) and \
                done_prefill[j][0] <= t + 1e-12 and \
                len(active) < spec.decode_slots:
            ready, a = done_prefill[j]
            active[a.rid] = max(1, a.decode_tokens)
            started[a.rid] = t
            j += 1
        step_end = _advance(t, dec_compute, dec_comm, dec_fracs, pulses)
        for rid in list(active):
            rec = recs[rid]
            if rec["t_first"] is None:
                rec["t_first"] = step_end
            active[rid] -= 1
            if active[rid] == 0:
                rec["t_finish"] = step_end
                del active[rid]
        t = step_end

    # --- SLO accounting ---------------------------------------------------
    requests: List[Dict[str, object]] = []
    ttfts: List[float] = []
    tpots: List[float] = []
    ok = 0
    for a in arrivals:
        rec = recs[a.rid]
        ttft = rec["t_first"] - rec["t_arrive"]
        steps = max(1, a.decode_tokens)
        tpot = (rec["t_finish"] - started[a.rid]) / steps
        slo_ok = ttft <= spec.slo.ttft_s and tpot <= spec.slo.tpot_s
        rec.update(ttft=ttft, tpot=tpot, slo_ok=slo_ok)
        requests.append(rec)
        ttfts.append(ttft)
        tpots.append(tpot)
        ok += int(slo_ok)

    def dist(vals: List[float]) -> Dict[str, float]:
        return {"mean": sum(vals) / len(vals) if vals else 0.0,
                "p50": _percentile(vals, 0.50),
                "p95": _percentile(vals, 0.95),
                "p99": _percentile(vals, 0.99)}

    util: Dict[Tuple, float] = dict(pf_util)
    for link, nbytes in dec_util.items():
        util[link] = util.get(link, 0.0) + nbytes
    hotspots = sorted(util.items(),
                      key=lambda kv: -kv[1])[:problem.hotspot_k]

    return ServingReport(
        name=spec.name, cost_model=model_name, slo=spec.slo,
        stagger_s=stagger, horizon_s=spec.horizon_s,
        offered_rps=offered_load(arrivals, spec.horizon_s),
        goodput_rps=ok / spec.horizon_s if spec.horizon_s > 0 else 0.0,
        slo_attainment=ok / len(arrivals) if arrivals else 1.0,
        ttft=dist(ttfts), tpot=dist(tpots),
        kv_bytes_per_request=kv_req, requests=requests,
        prefill=prefill_report, decode=decode_report,
        link_hotspots=hotspots)


def serving_problem(spec: ServingSpec, topo: Topology,
                    space: Optional[PlanSpace] = None,
                    objective: Optional[Objective] = None,
                    cost_model: Union[str, CostModel] = "flowsim",
                    hotspot_k: int = 8) -> CodesignProblem:
    """A ``CodesignProblem`` for one serving tenant.  The default
    objective minimizes p99 TTFT (tie-broken by p99 TPOT then goodput)
    under the spec's SLO as feasibility constraints, so ``search()``
    returns SLO-feasible plans or raises with the binding constraint."""
    if objective is None:
        objective = Objective(
            minimize="ttft_p99", tie_break=("tpot_p99", "goodput"),
            constraints={"ttft_p99": spec.slo.ttft_s,
                         "tpot_p99": spec.slo.tpot_s})
    shape = ShapeConfig(f"{spec.name}-serve", spec.prompt_tokens,
                        spec.prefill_batch, "prefill")
    return CodesignProblem(
        cfg=spec.cfg, shape=shape, mesh=spec.mesh(), topo=topo,
        space=space if space is not None else PlanSpace(),
        objective=objective, cost_model=cost_model, hotspot_k=hotspot_k,
        serving=spec)
