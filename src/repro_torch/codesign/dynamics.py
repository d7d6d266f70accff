"""Event-driven cluster dynamics with incremental re-planning.

The paper's "opportunities" (Sec. VII) include elastic and fault-tolerant
training: a production cluster is not a static co-design problem.  Jobs
arrive and depart, links fail or lose bandwidth, hosts drop out, and
stragglers appear — and each such event invalidates only *part* of the
standing plan.  Re-running :func:`plan_cluster` from scratch on every
event re-prices every tenant's collectives and sweeps a ``grid**(n-1)``
phase search; almost all of that work reproduces the previous answer.

:class:`ClusterDynamics` consumes a trace of :class:`Event`s and re-plans
incrementally:

  1. **diff** — an event dirties a set of physical links (the failed or
     degraded link, a dead host's incident links) and thereby the jobs
     whose per-link byte maps touch them; job arrivals/departures dirty
     only the jobs they share links with;
  2. **vertical re-plan** — only jobs whose *topology view* changed under
     their routes (or whose devices died, or that just arrived) are
     re-placed and re-priced on a degradation view of the base topology
     (``Topology.without_link`` / ``without_host`` / ``scaled_bw``);
     clean jobs keep their ``CodesignReport`` verbatim — a job's vertical
     plan is a single-tenant quantity, so other tenants' churn cannot
     invalidate it;
  3. **horizontal re-stagger** — :func:`restagger_cluster` sweeps phase
     offsets of the dirty jobs only, holding everyone else frozen
     (``grid**|dirty|`` instead of ``grid**(n-1)``);
  4. **fallback** — if the incremental plan is infeasible (a job cannot
     be re-placed, no route survives, a JCT diverges) the engine falls
     back to the full from-scratch search on the current view, evicting
     the most recently arrived tenants when the surviving fabric cannot
     hold everyone.

The engine warm-starts from a persisted :class:`ClusterReport` (its JSON
``to_dict``/``from_dict`` round-trip), so a restarted controller does not
re-search a running cluster.  Every event yields an :class:`EventRecord`
with its time-to-replan and — when ``compare_full=True`` — the wall-clock
and worst-stretch *regret* of the incremental answer against a full
re-search on the same view.  :class:`DynamicsReport` aggregates the trace
for the ``replan`` benchmark row.

The port's copy of ``repro.codesign.dynamics``, kept line for line:
importing any ``repro`` module runs the JAX package's ``__init__``, which
imports jax, so the port keeps its own.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import networkx as nx

from repro_torch.net.topology import Topology
from repro_torch.obs.meters import Meters
from repro_torch.codesign.api import plan
from repro_torch.codesign.cluster import (ClusterReport, JobPlan, JobSpec,
                                          _carve_devices, _job_profile,
                                          _stagger_plans, restagger_cluster)
from repro_torch.codesign.placement import place_mesh
from repro_torch.codesign.report import _link_key, _parse_link_key

EVENT_KINDS = ("job_arrive", "job_depart", "link_fail", "link_degrade",
               "host_fail", "straggler")


@dataclass(frozen=True)
class Event:
    """One cluster event.  Field use by kind:

    * ``job_arrive``   — ``job`` (the new :class:`JobSpec`);
    * ``job_depart``   — ``name``;
    * ``link_fail``    — ``link`` (a physical ``(u, v)``; both
      orientations fail);
    * ``link_degrade`` — ``link`` + ``factor`` in (0, 1) (bandwidth
      multiplier, compounding across events);
    * ``host_fail``    — ``host`` (index into the *base* topology's
      ``hosts``);
    * ``straggler``    — ``name`` + ``factor`` > 1 (compute slowdown,
      compounding)."""

    kind: str
    time: float = 0.0
    job: Optional[JobSpec] = None
    name: Optional[str] = None
    link: Optional[Tuple] = None
    host: Optional[int] = None
    factor: float = 1.0

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {self.kind!r} "
                             f"(one of {EVENT_KINDS})")
        need = {"job_arrive": self.job is not None,
                "job_depart": self.name is not None,
                "link_fail": self.link is not None,
                "link_degrade": self.link is not None,
                "host_fail": self.host is not None,
                "straggler": self.name is not None}
        if not need[self.kind]:
            raise ValueError(f"event {self.kind!r} is missing its target "
                             f"field (see Event docstring)")
        if self.kind == "link_degrade" and not 0 < self.factor < 1:
            raise ValueError(f"link_degrade factor must be in (0, 1), got "
                             f"{self.factor} (use link_fail for outage)")
        if self.kind == "straggler" and self.factor <= 1:
            raise ValueError(f"straggler factor must be > 1 (a slowdown), "
                             f"got {self.factor}")

    @property
    def target(self) -> str:
        if self.kind == "job_arrive":
            return self.job.name
        if self.kind in ("job_depart", "straggler"):
            return self.name
        if self.kind == "host_fail":
            return f"host{self.host}"
        return _link_key(self.link)


@dataclass
class EventRecord:
    """What one event cost and what plan it left behind."""

    kind: str
    target: str
    time: float
    mode: str                     # "incremental" | "full"
    dirty_jobs: List[str]         # jobs whose phases were re-searched
    dirty_links: List[Tuple]      # physical links the event touched
    replan_s: float               # wall-clock of the engine's re-plan
    worst_stretch: float          # staggered worst stretch after the event
    jct: Dict[str, float]         # staggered per-job JCT after the event
    full_replan_s: Optional[float] = None  # compare_full: full re-search
    regret: Optional[float] = None         # inc/full worst stretch - 1
    evicted: List[str] = field(default_factory=list)
    # checkpoint-restore bill for tenants this event moved or evicted
    # (modeled data-plane seconds, not controller wall-clock)
    restore_s: float = 0.0

    def to_dict(self) -> Dict:
        d = {"kind": self.kind, "target": self.target, "time": self.time,
             "mode": self.mode, "dirty_jobs": list(self.dirty_jobs),
             "dirty_links": [_link_key(l) for l in self.dirty_links],
             "replan_s": self.replan_s, "worst_stretch": self.worst_stretch,
             "jct": dict(self.jct), "full_replan_s": self.full_replan_s,
             "regret": self.regret, "evicted": list(self.evicted),
             "restore_s": self.restore_s}
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "EventRecord":
        return cls(kind=d["kind"], target=d["target"], time=d["time"],
                   mode=d["mode"], dirty_jobs=list(d["dirty_jobs"]),
                   dirty_links=[_parse_link_key(k)
                                for k in d["dirty_links"]],
                   replan_s=d["replan_s"],
                   worst_stretch=d["worst_stretch"], jct=dict(d["jct"]),
                   full_replan_s=d.get("full_replan_s"),
                   regret=d.get("regret"),
                   evicted=list(d.get("evicted", [])),
                   restore_s=d.get("restore_s", 0.0))


@dataclass
class DynamicsReport:
    """A trace's worth of :class:`EventRecord`s plus the final plan."""

    records: List[EventRecord]
    final: ClusterReport
    # engine telemetry (``repro_torch.obs.meters`` snapshot): replan-mode
    # tallies, dirty-set sizes, phase-search evaluation counts
    telemetry: Dict[str, float] = field(default_factory=dict)

    @property
    def incremental_speedup(self) -> Optional[float]:
        """Aggregate wall-clock win of incremental re-planning: total full
        re-search time over total incremental time, across the events
        where both were measured (``compare_full=True`` runs).  Summing
        before dividing keeps single-event timer noise from dominating."""
        pairs = [(r.full_replan_s, r.replan_s) for r in self.records
                 if r.mode == "incremental" and r.full_replan_s is not None]
        if not pairs:
            return None
        return sum(f for f, _ in pairs) / max(
            sum(i for _, i in pairs), 1e-12)

    @property
    def worst_regret(self) -> Optional[float]:
        rs = [r.regret for r in self.records if r.regret is not None]
        return max(rs) if rs else None

    @property
    def mean_replan_s(self) -> float:
        if not self.records:
            return 0.0
        return sum(r.replan_s for r in self.records) / len(self.records)

    @property
    def total_restore_s(self) -> float:
        """Checkpoint-restore seconds billed across the whole trace —
        the data-plane price of every eviction/re-placement."""
        return sum(r.restore_s for r in self.records)

    def to_dict(self) -> Dict:
        return {"records": [r.to_dict() for r in self.records],
                "final": self.final.to_dict(),
                "telemetry": dict(self.telemetry)}

    @classmethod
    def from_dict(cls, d: Dict, specs: Dict[str, JobSpec]
                  ) -> "DynamicsReport":
        return cls(records=[EventRecord.from_dict(r) for r in d["records"]],
                   final=ClusterReport.from_dict(d["final"], specs),
                   telemetry=dict(d.get("telemetry", {})))

    def to_trace(self, topo=None, **kw):
        """The whole trace as a Perfetto timeline: event/replan/stretch
        tracks for the dynamics run plus the final cluster plan's per-job
        timelines (``repro_torch.obs.trace.trace_from_dynamics``)."""
        from repro_torch.obs.trace import trace_from_dynamics
        return trace_from_dynamics(self.to_dict(), topo=topo, **kw)


def _restore_cost_s(spec: JobSpec, devices: Sequence[int],
                    view: Topology) -> float:
    """Checkpoint-restore bill for moving (or evicting) a tenant: the
    job's full training state (``checkpoint.io.checkpoint_state_bytes``:
    f32 master params + AdamW moments) streamed in over the job's
    ingress bandwidth — each device pulls its shard through its own NIC,
    so ingress is the sum over the job's devices of their slowest
    incident inbound link on the current view."""
    if not devices:
        return 0.0
    from repro_torch.checkpoint.io import checkpoint_state_bytes
    state = checkpoint_state_bytes(spec.cfg)
    ingress = 0.0
    for d in devices:
        if d not in view.graph:
            continue
        bws = [view.link_bw(u, d) for u in view.graph.predecessors(d)]
        if bws:
            ingress += min(bws)
    return state / ingress if ingress > 0 else 0.0


def _respec(spec: JobSpec, devices: Optional[Tuple[int, ...]]) -> JobSpec:
    """A copy of ``spec`` with a different device pin.  (``replace`` can't
    be used: a problem-carrying JobSpec fills its flat fields in
    ``__post_init__``, and passing both back is rejected.)"""
    if spec.problem is not None:
        return JobSpec(spec.name, devices=devices, problem=spec.problem)
    return JobSpec(spec.name, spec.cfg, spec.shape, spec.mesh,
                   devices=devices, policy=spec.policy,
                   dp_params=spec.dp_params, force=spec.force,
                   error_budget=spec.error_budget)


class ClusterDynamics:
    """The event loop: holds the cluster's current plan and failure state,
    applies events, and re-plans incrementally (full search as fallback).

    ``warm_start`` seeds the standing plan — a live :class:`ClusterReport`
    or its ``to_dict()`` JSON — instead of running the initial full
    search; ``compare_full=True`` additionally prices every incremental
    answer against a from-scratch full re-search (for the speedup/regret
    metrics; it does not affect the engine's own state)."""

    def __init__(self, jobs: Sequence[JobSpec], topo: Topology,
                 cost_model: str = "flowsim", grid: int = 8,
                 horizon_iters: int = 12, dt: Optional[float] = None,
                 switch_capacity: Optional[int] = None,
                 max_contended_links: int = 8, compare_full: bool = False,
                 warm_start: Optional[Union[ClusterReport, Dict]] = None,
                 clock=time.perf_counter):
        names = [s.name for s in jobs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate job names: {names}")
        self.base_topo = topo
        self.cost_model = cost_model
        self.grid = grid
        self.horizon_iters = horizon_iters
        self.dt = dt
        self.switch_capacity = switch_capacity
        self.max_contended_links = max_contended_links
        self.compare_full = compare_full
        # injectable clock: tests pass a fake counter to make ``replan_s``
        # / ``full_replan_s`` deterministic; the obs meters share it
        self.clock = clock
        self.meters = Meters(clock=clock)
        self.specs: Dict[str, JobSpec] = {s.name: s for s in jobs}
        self.failed_hosts: Set[int] = set()
        self.failed_links: Set[Tuple] = set()
        self.bw_scale: Dict[Tuple, float] = {}
        self.straggle: Dict[str, float] = {}
        self.records: List[EventRecord] = []
        if warm_start is None:
            self.report, _ = self._plan_full(self._view())
        elif isinstance(warm_start, ClusterReport):
            self.report = warm_start
        else:
            self.report = ClusterReport.from_dict(warm_start, self.specs)

    # ------------------------------------------------------------------
    # Topology view
    # ------------------------------------------------------------------

    def _view(self) -> Topology:
        """The base topology through every failure/degradation so far.
        Host removals go first, highest base index first, so the indices
        recorded at event time stay valid while removing."""
        t = self.base_topo
        for h in sorted(self.failed_hosts, reverse=True):
            t = t.without_host(h)
        for u, v in sorted(self.failed_links, key=str):
            t = t.without_link(u, v)
        scales = {l: f for l, f in self.bw_scale.items()
                  if f != 1.0 and t.graph.has_edge(*l)}
        return t.scaled_bw(scales) if scales else t

    # ------------------------------------------------------------------
    # Planning helpers
    # ------------------------------------------------------------------

    def _plan_job(self, spec: JobSpec, devs: Tuple[int, ...],
                  view: Topology) -> JobPlan:
        placement = place_mesh(spec.mesh, view, "custom", custom=devs)
        report = plan(spec.to_problem(
            view, placement, self.cost_model, self.switch_capacity,
            hotspot_k=view.graph.number_of_edges()))
        prof = _job_profile(spec.name, report,
                            self.straggle.get(spec.name, 1.0))
        return JobPlan(spec=spec, devices=tuple(devs), report=report,
                       profile=prof, link_bytes=dict(report.link_hotspots))

    def _empty_report(self) -> ClusterReport:
        return ClusterReport(jobs=[], contended={}, phases={},
                             naive_jct={}, staggered_jct={},
                             cost_model=str(self.cost_model),
                             link_demands={})

    def _plan_full(self, view: Topology
                   ) -> Tuple[ClusterReport, List[str]]:
        """From-scratch re-plan of every tenant on ``view``.  Device pins
        that no longer exist fall back to first-fit; when the surviving
        fabric cannot hold everyone, the most recently arrived tenants
        are marked for eviction (LIFO) and planned out.  Pure: the
        eviction list is *returned*, not applied — ``apply`` commits it
        only when this plan becomes the standing one."""
        alive = set(view.accelerators)
        names = list(self.specs)
        evicted: List[str] = []
        while names and sum(self.specs[n].mesh.num_devices
                            for n in names) > len(alive):
            evicted.append(names.pop())
        if not names:
            return self._empty_report(), evicted
        devmap = {jp.spec.name: jp.devices
                  for jp in getattr(self, "report", self._empty_report()
                                    ).jobs}
        specs = []
        for n in names:
            spec = self.specs[n]
            devs = devmap.get(n, spec.devices)
            if devs is not None and not set(devs) <= alive:
                devs = None
            specs.append(_respec(spec, tuple(devs) if devs else None))
        blocks = _carve_devices(specs, view)
        plans = [self._plan_job(spec, devs, view)
                 for spec, devs in zip(specs, blocks)]
        rep = _stagger_plans(plans, view, grid=self.grid,
                             horizon_iters=self.horizon_iters, dt=self.dt,
                             max_contended_links=self.max_contended_links,
                             cost_model=plans[0].report.cost_model,
                             meters=getattr(self, "meters", None))
        return rep, evicted

    def _rebuild_plans(self, view: Topology, vertical: Set[str]
                       ) -> List[JobPlan]:
        """Current per-job plans on ``view``: jobs in ``vertical`` (plus
        any without a standing plan) are re-placed and re-priced; clean
        jobs keep their plan, with the profile refreshed so sticky
        straggle factors apply.  Raises ``ValueError`` when a dirty job
        cannot be re-placed — the caller's cue to fall back."""
        old = {jp.spec.name: jp for jp in self.report.jobs}
        alive = set(view.accelerators)
        keep: Dict[str, JobPlan] = {}
        taken: Set[int] = set()
        pending: List[JobSpec] = []
        for name, spec in self.specs.items():
            jp = old.get(name)
            if jp is None or name in vertical:
                pending.append(spec)
                continue
            prof = _job_profile(name, jp.report,
                                self.straggle.get(name, 1.0))
            if prof != jp.profile:
                jp = replace(jp, profile=prof)
            keep[name] = jp
            taken |= set(jp.devices)
        free = [a for a in view.accelerators if a not in taken]
        for spec in pending:
            prev = old[spec.name].devices if spec.name in old \
                else spec.devices
            devs = tuple(prev) if prev is not None else None
            if devs is not None and (not set(devs) <= alive
                                     or set(devs) & taken):
                devs = None   # lost (or re-taken) devices: re-carve
            if devs is None:
                n = spec.mesh.num_devices
                if n > len(free):
                    raise ValueError(
                        f"job {spec.name!r}: {n} devices needed but only "
                        f"{len(free)} remain on {view.name}")
                devs, free = tuple(free[:n]), free[n:]
            taken |= set(devs)
            keep[spec.name] = self._plan_job(spec, devs, view)
        return [keep[n] for n in self.specs]

    # ------------------------------------------------------------------
    # The event loop
    # ------------------------------------------------------------------

    def apply(self, ev: Event) -> EventRecord:
        """Apply one event: update failure state, diff the dirty set,
        re-plan (incrementally if possible), record the cost."""
        link_maps = {jp.spec.name: set(jp.link_bytes)
                     for jp in self.report.jobs}
        old_devs = {jp.spec.name: tuple(jp.devices)
                    for jp in self.report.jobs}
        dirty_links: Set[Tuple] = set()
        vertical: Set[str] = set()      # jobs needing a vertical re-plan
        phase_dirty: Set[str] = set()   # jobs whose phase is re-searched

        if ev.kind == "job_arrive":
            if ev.job.name in self.specs:
                raise ValueError(f"job {ev.job.name!r} already running")
            self.specs[ev.job.name] = ev.job
            vertical.add(ev.job.name)
        elif ev.kind == "job_depart":
            if ev.name not in self.specs:
                raise ValueError(f"job {ev.name!r} not running")
            del self.specs[ev.name]
            self.straggle.pop(ev.name, None)
            dirty_links |= link_maps.pop(ev.name, set())
        elif ev.kind in ("link_fail", "link_degrade"):
            u, v = ev.link
            if ev.kind == "link_fail":
                self.failed_links.add((u, v))
            else:
                self.bw_scale[(u, v)] = (self.bw_scale.get((u, v), 1.0)
                                         * ev.factor)
            dirty_links |= {(u, v), (v, u)}
        elif ev.kind == "host_fail":
            prev = self._view()
            dead = set(self.base_topo.hosts[ev.host])
            for d in dead & set(prev.graph.nodes):
                for nbr in prev.graph.successors(d):
                    dirty_links |= {(d, nbr), (nbr, d)}
            self.failed_hosts.add(ev.host)
            for jp in self.report.jobs:
                if set(jp.devices) & dead and jp.spec.name in self.specs:
                    vertical.add(jp.spec.name)
        else:  # straggler
            if ev.name not in self.specs:
                raise ValueError(f"job {ev.name!r} not running")
            self.straggle[ev.name] = (self.straggle.get(ev.name, 1.0)
                                      * ev.factor)
            phase_dirty.add(ev.name)

        # a topology change under a job's routes invalidates its vertical
        # plan; mere tenant churn (arrive/depart) only re-opens phases —
        # the vertical plan is a single-tenant quantity
        topo_changed = ev.kind in ("link_fail", "link_degrade", "host_fail")
        for name, links in link_maps.items():
            if name in self.specs and links & dirty_links:
                (vertical if topo_changed else phase_dirty).add(name)
        phase_dirty |= vertical

        view = self._view()
        t0 = self.clock()
        report: Optional[ClusterReport] = None
        evicted: List[str] = []
        mode = "incremental"
        if self.specs:
            try:
                plans = self._rebuild_plans(view, vertical)
                if ev.kind == "job_arrive":
                    # now that the arrival is routed, free the phases of
                    # every tenant it shares links with
                    new_links = set(plans[-1].link_bytes) \
                        if plans[-1].spec.name == ev.job.name else set()
                    for jp in plans:
                        if set(jp.link_bytes) & new_links:
                            phase_dirty.add(jp.spec.name)
                report = restagger_cluster(
                    plans, view, phases=self.report.phases,
                    dirty=sorted(phase_dirty & set(self.specs)),
                    grid=self.grid, horizon_iters=self.horizon_iters,
                    dt=self.dt,
                    max_contended_links=self.max_contended_links,
                    cost_model=self.report.cost_model,
                    meters=self.meters)
            except (ValueError, KeyError, nx.NetworkXException):
                report = None
            if report is not None and any(
                    v == float("inf")
                    for v in report.staggered_jct.values()):
                report = None   # diverged under the frozen phases
            if report is None:
                mode = "full"
                report, evicted = self._plan_full(view)
                evicted_specs = {n: self.specs[n] for n in evicted}
                for n in evicted:
                    del self.specs[n]
                    self.straggle.pop(n, None)
        else:
            report = self._empty_report()
        replan_s = self.clock() - t0

        # checkpoint-restore bill: every surviving tenant whose device
        # set moved re-ingests its training state at the new seats;
        # evicted tenants drain theirs through the seats they had left
        restore_s = 0.0
        for jp in report.jobs:
            prev = old_devs.get(jp.spec.name)
            if prev is not None and prev != tuple(jp.devices):
                restore_s += _restore_cost_s(jp.spec, jp.devices, view)
        for n in evicted:
            restore_s += _restore_cost_s(evicted_specs[n],
                                         old_devs.get(n, ()), view)

        full_s = regret = None
        if self.compare_full and mode == "incremental" and self.specs:
            t1 = self.clock()
            full_rep, _ = self._plan_full(view)
            full_s = self.clock() - t1
            if report.jobs and full_rep.jobs:
                regret = (report.staggered_worst_stretch
                          / full_rep.staggered_worst_stretch - 1.0)

        self.meters.incr(f"dynamics.mode.{mode}")
        self.meters.incr(f"dynamics.event.{ev.kind}")
        self.meters.observe("dynamics.dirty_jobs",
                            float(len(phase_dirty & set(self.specs))))
        self.meters.observe("dynamics.dirty_links",
                            float(len(dirty_links)))
        if evicted:
            self.meters.incr("dynamics.evictions", float(len(evicted)))
        if restore_s > 0:
            self.meters.observe("dynamics.restore_s", restore_s)

        self.report = report
        rec = EventRecord(
            kind=ev.kind, target=ev.target, time=ev.time, mode=mode,
            dirty_jobs=sorted(phase_dirty & set(self.specs)),
            dirty_links=sorted(dirty_links, key=str),
            replan_s=replan_s,
            worst_stretch=(report.staggered_worst_stretch
                           if report.jobs else 1.0),
            jct=dict(report.staggered_jct),
            full_replan_s=full_s, regret=regret, evicted=evicted,
            restore_s=restore_s)
        self.records.append(rec)
        return rec

    def run(self, events: Sequence[Event]) -> DynamicsReport:
        """Apply a whole trace (sorted by event time) and aggregate."""
        for ev in sorted(events, key=lambda e: e.time):
            self.apply(ev)
        return DynamicsReport(records=list(self.records),
                              final=self.report,
                              telemetry=self.meters.snapshot())
