"""Horizontal multi-job cluster planner (paper Sec. IV-A, CASSINI [16]).

``plan_iteration`` plans one job on an empty network; real clusters run many
jobs whose communication bursts meet on shared links (the Fig. 5(b) case at
(2)).  ``plan_cluster`` closes the loop between the vertical co-design
engine and the horizontal flow scheduler:

  1. carve the topology's accelerators into per-job partitions (explicit
     ``JobSpec.devices`` or first-fit consecutive blocks);
  2. run every job's pinned :class:`CodesignProblem` through ``api.plan``
     — placement, per-task algorithm selection priced on the shared
     topology, JCT — and keep its full per-link byte map;
  3. ask the network layer which links carry traffic from >= 2 jobs
     (``net.simulate.shared_link_load``);
  4. compress each job into a :class:`sched.flows.JobProfile` (compute
     phase, comm burst, per-contended-link demand fraction) and search
     phase shifts with ``sched.flows.stagger_jobs`` to minimize the
     worst-case JCT stretch.

The result is a :class:`ClusterReport`: per-job naive (zero-phase) vs.
staggered JCT, the contended-link map, and the chosen phases — the first
genuinely multi-tenant answer the engine can hand back up the stack.

The port's copy of ``repro.codesign.cluster``, kept line for line:
importing any ``repro`` module runs the JAX package's ``__init__``, which
imports jax, so the port keeps its own.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.ccl.select import CostModel
from repro_torch.core.demand_builder import DemandParams
from repro_torch.core.knobs import Fixed
from repro_torch.core.types import MeshConfig, ModelConfig, ShapeConfig
from repro_torch.net.simulate import shared_link_load
from repro_torch.net.topology import Topology
from repro_torch.sched.flows import (BurstProfile, JobProfile,
                                     restagger_jobs, stagger_jobs,
                                     stagger_mixed, worst_stretch)
from repro_torch.sched.tasks import Policy

from repro_torch.codesign.api import CodesignProblem, plan
from repro_torch.codesign.placement import Placement, place_mesh
from repro_torch.codesign.report import (CodesignReport, _link_key,
                                         _parse_link_key)


@dataclass(frozen=True)
class JobSpec:
    """One tenant job: what to train, how to shard it, and (optionally)
    which physical devices it owns.

    A job is at heart a :class:`CodesignProblem` minus the cluster-level
    concerns (topology, device carving, switch budget).  Pass either the
    flat fields (the legacy surface) or ``problem=`` — a problem carries
    every per-job knob, so mixing it with flat per-job fields is an
    error; the flat views (``cfg``/``mesh``/``policy``/...) are then
    filled from it."""

    name: str
    cfg: Optional[ModelConfig] = None
    shape: Optional[ShapeConfig] = None
    mesh: Optional[MeshConfig] = None
    devices: Optional[Tuple[int, ...]] = None  # None = first-fit block
    policy: Policy = "priority"
    dp_params: Optional[DemandParams] = None
    force: Optional[Dict[str, str]] = None
    # per-tenant compression tolerance (repro_torch.compress): admits
    # compressed candidates into this job's selection; smaller per-job flows also
    # shrink what the horizontal layer sees on contended links
    error_budget: Union[float, Dict[str, float]] = 0.0
    problem: Optional[CodesignProblem] = None
    # a serving tenant (codesign.serving.ServingSpec): prefill/decode
    # disaggregation + open-loop arrivals instead of a training iteration.
    # Mutually exclusive with the flat fields and with problem=.
    serving: Optional[object] = None

    def __post_init__(self):
        if self.serving is not None:
            if (self.problem is not None or self.cfg is not None
                    or self.shape is not None or self.mesh is not None
                    or self.policy != "priority"
                    or self.dp_params is not None or self.force is not None
                    or self.error_budget != 0.0):
                raise ValueError(
                    f"job {self.name!r}: serving= carries the per-tenant "
                    f"config; don't also pass cfg/shape/mesh/policy/"
                    f"dp_params/force/error_budget/problem")
            object.__setattr__(self, "cfg", self.serving.cfg)
            object.__setattr__(self, "mesh", self.serving.mesh())
            object.__setattr__(self, "dp_params", self.serving.dp_params)
            return
        if self.problem is None:
            if self.cfg is None or self.shape is None or self.mesh is None:
                raise ValueError(f"job {self.name!r} needs cfg/shape/mesh "
                                 f"(or a CodesignProblem via problem=)")
            return
        if (self.cfg is not None or self.shape is not None
                or self.mesh is not None or self.policy != "priority"
                or self.dp_params is not None or self.force is not None
                or self.error_budget != 0.0):
            raise ValueError(
                f"job {self.name!r}: problem= carries the per-job knobs; "
                f"don't also pass cfg/shape/mesh/policy/dp_params/force/"
                f"error_budget")
        sp = self.problem.space
        for knob_name in ("policy", "error_budget"):
            if not isinstance(getattr(sp, knob_name), Fixed):
                raise ValueError(
                    f"job {self.name!r}: plan_cluster needs fully "
                    f"specified per-job problems — {knob_name} is "
                    f"{getattr(sp, knob_name)!r}; run search() per job "
                    f"first or pin it")
        object.__setattr__(self, "cfg", self.problem.cfg)
        object.__setattr__(self, "shape", self.problem.shape)
        object.__setattr__(self, "mesh", self.problem.mesh)
        object.__setattr__(self, "policy", sp.policy.value)
        object.__setattr__(self, "dp_params", self.problem.dp_params)
        object.__setattr__(self, "error_budget", sp.error_budget.value)
        forced = {p: k.value for p, k in sp.algorithm.items()
                  if p != "*" and isinstance(k, Fixed)}
        object.__setattr__(self, "force", forced or None)

    def to_problem(self, topo: Topology, placement: Placement,
                   cost_model: Union[str, CostModel],
                   switch_capacity: Optional[int],
                   hotspot_k: int) -> CodesignProblem:
        """This job as a fully pinned problem on the shared cluster:
        the carved placement and the cluster-level cost model / switch
        budget override whatever the carried problem held."""
        if self.serving is not None:
            from repro_torch.codesign.serving import serving_problem
            prob = serving_problem(self.serving, topo,
                                   cost_model=cost_model,
                                   hotspot_k=hotspot_k)
            space = dataclasses.replace(
                prob.space, placement=Fixed(placement),
                switch_capacity=Fixed(switch_capacity))
            return dataclasses.replace(prob, space=space)
        if self.problem is not None:
            space = dataclasses.replace(
                self.problem.space, placement=Fixed(placement),
                switch_capacity=Fixed(switch_capacity))
            return dataclasses.replace(
                self.problem, topo=topo, space=space,
                cost_model=cost_model, hotspot_k=hotspot_k)
        return CodesignProblem.from_kwargs(
            self.cfg, self.shape, self.mesh, topo, policy=self.policy,
            placement=placement, cost_model=cost_model,
            dp_params=self.dp_params, force=self.force,
            hotspot_k=hotspot_k, switch_capacity=switch_capacity,
            error_budget=self.error_budget)


@dataclass
class JobPlan:
    """One job's single-tenant plan plus its horizontal-layer summary."""

    spec: JobSpec
    devices: Tuple[int, ...]
    report: CodesignReport
    profile: JobProfile
    link_bytes: Dict[Tuple, float]

    def to_dict(self) -> Dict:
        """Plain-JSON form (the ``spec`` carries live configs and is keyed
        by name only — ``from_dict`` takes the live specs back)."""
        return {
            "name": self.spec.name, "devices": list(self.devices),
            "report": self.report.to_dict(),
            "profile": {"compute_s": self.profile.compute_s,
                        "comm_s": self.profile.comm_s,
                        "demand_frac": self.profile.demand_frac},
            "link_bytes": {_link_key(l): b
                           for l, b in self.link_bytes.items()},
        }

    @classmethod
    def from_dict(cls, d: Dict, spec: JobSpec) -> "JobPlan":
        p = d["profile"]
        if "ttft" in d["report"]:  # a serving tenant's report
            from repro_torch.codesign.serving import ServingReport
            report = ServingReport.from_dict(d["report"])
        else:
            report = CodesignReport.from_dict(d["report"])
        return cls(
            spec=spec, devices=tuple(d["devices"]), report=report,
            profile=JobProfile(d["name"], p["compute_s"], p["comm_s"],
                               p["demand_frac"]),
            link_bytes={_parse_link_key(k): b
                        for k, b in d["link_bytes"].items()})


@dataclass
class ClusterReport:
    """What the horizontal planner hands back up the stack."""

    jobs: List[JobPlan]
    contended: Dict[Tuple, Dict[str, float]]  # link -> {job: bytes}
    phases: Dict[str, float]
    naive_jct: Dict[str, float]
    staggered_jct: Dict[str, float]
    cost_model: str = "flowsim"
    link_demands: Dict[str, Dict[Tuple, float]] = field(default_factory=dict)
    # per serving tenant: naive (zero training phases) vs. staggered SLO
    # numbers under co-tenancy — {name: {"naive_ttft_p99": ..., ...}}
    serving: Dict[str, Dict[str, float]] = field(default_factory=dict)

    @property
    def solo_jct(self) -> Dict[str, float]:
        """Each job's JCT alone on the cluster (its iteration period)."""
        return {jp.spec.name: jp.profile.period for jp in self.jobs}

    def _stretch(self, jct: Dict[str, float]) -> float:
        # training tenants only: serving quality lives in SLO metrics
        # (self.serving), not in iteration stretch
        profs = [jp.profile for jp in self.jobs if jp.spec.serving is None]
        if not profs:
            return 1.0
        return worst_stretch(jct, profs)

    @property
    def naive_worst_stretch(self) -> float:
        return self._stretch(self.naive_jct)

    @property
    def staggered_worst_stretch(self) -> float:
        return self._stretch(self.staggered_jct)

    @property
    def stagger_speedup(self) -> float:
        """Worst-case JCT improvement of staggering over zero phases."""
        return self.naive_worst_stretch / self.staggered_worst_stretch

    # ------------------------------------------------------------------
    # JSON persistence (the warm-start seed codesign.dynamics re-plans
    # from: per-job reports round-trip via CodesignReport, links as
    # "u->v" keys; JobSpec objects carry live model configs so from_dict
    # takes them back by name)
    # ------------------------------------------------------------------

    def to_dict(self) -> Dict:
        return {
            "jobs": [jp.to_dict() for jp in self.jobs],
            "contended": {_link_key(l): dict(users)
                          for l, users in self.contended.items()},
            "phases": dict(self.phases),
            "naive_jct": dict(self.naive_jct),
            "staggered_jct": dict(self.staggered_jct),
            "cost_model": self.cost_model,
            "link_demands": {name: {_link_key(l): f
                                    for l, f in dem.items()}
                             for name, dem in self.link_demands.items()},
            "serving": {name: dict(m) for name, m in self.serving.items()},
        }

    @classmethod
    def from_dict(cls, d: Dict, specs: Dict[str, JobSpec]
                  ) -> "ClusterReport":
        missing = [j["name"] for j in d["jobs"] if j["name"] not in specs]
        if missing:
            raise ValueError(f"ClusterReport.from_dict needs the live "
                             f"JobSpec for {missing} (specs= by name)")
        return cls(
            jobs=[JobPlan.from_dict(j, specs[j["name"]])
                  for j in d["jobs"]],
            contended={_parse_link_key(k): dict(users)
                       for k, users in d["contended"].items()},
            phases=dict(d["phases"]),
            naive_jct=dict(d["naive_jct"]),
            staggered_jct=dict(d["staggered_jct"]),
            cost_model=d["cost_model"],
            link_demands={name: {_parse_link_key(k): f
                                 for k, f in dem.items()}
                          for name, dem in d["link_demands"].items()},
            serving={name: dict(m)
                     for name, m in d.get("serving", {}).items()})

    def to_trace(self, topo=None, **kw):
        """The cluster plan as a Perfetto trace: one process group per
        tenant, each tenant's iteration tracks shifted by its staggered
        phase, contended links on a cluster process
        (``repro_torch.obs.trace.trace_from_cluster``)."""
        from repro_torch.obs.trace import trace_from_cluster
        return trace_from_cluster(self.to_dict(), topo=topo, **kw)


def _carve_devices(jobs: Sequence[JobSpec], topo: Topology
                   ) -> List[Tuple[int, ...]]:
    """Assign each job its accelerators: explicit ``devices`` first, then
    first-fit consecutive blocks from what remains."""
    taken: Dict[int, str] = {}
    out: List[Optional[Tuple[int, ...]]] = [None] * len(jobs)
    accel = list(topo.accelerators)
    accel_set = set(accel)
    for i, spec in enumerate(jobs):
        if spec.devices is None:
            continue
        devs = tuple(spec.devices)
        if len(devs) != spec.mesh.num_devices:
            raise ValueError(
                f"job {spec.name!r}: {len(devs)} devices for mesh "
                f"{spec.mesh.shape} ({spec.mesh.num_devices} needed)")
        bad = set(devs) - accel_set
        if bad:
            raise ValueError(f"job {spec.name!r}: non-accelerator devices "
                             f"{sorted(bad)} on {topo.name}")
        for d in devs:
            if d in taken:
                raise ValueError(
                    f"device {d} claimed by both {taken[d]!r} and "
                    f"{spec.name!r}")
            taken[d] = spec.name
        out[i] = devs
    free = [d for d in accel if d not in taken]
    for i, spec in enumerate(jobs):
        if out[i] is not None:
            continue
        n = spec.mesh.num_devices
        if n > len(free):
            raise ValueError(
                f"job {spec.name!r} needs {n} devices but only {len(free)} "
                f"of {topo.name}'s {len(accel)} remain")
        out[i] = tuple(free[:n])
        for d in out[i]:
            taken[d] = spec.name
        free = free[n:]
    return out  # type: ignore[return-value]


def _job_profile(name: str, report: CodesignReport,
                 compute_scale: float = 1.0) -> JobProfile:
    """Compress a CodesignReport into the flow scheduler's pulse model.

    The comm burst is the *exposed* communication — the stretch of the
    iteration where the network gates progress.  Overlapped plans hide
    most of ``comm_time`` under compute; using the raw busy time there
    overstated the burst, inflated apparent contention, and mis-staggered
    phases (for serial plans the two are identical).  The compute phase
    is the rest of the iteration, so the period equals the job's solo
    JCT.  ``compute_scale`` > 1 models a straggler (slowed compute, same
    burst — the ``codesign.dynamics`` event)."""
    comm_s = max(min(report.exposed_comm, report.jct), 0.0)
    compute_s = max(report.jct - comm_s, 1e-9) * compute_scale
    return JobProfile(name, compute_s, comm_s)


def plan_cluster(jobs: Sequence[JobSpec], topo: Topology,
                 cost_model: Union[str, CostModel] = "flowsim",
                 grid: int = 8, horizon_iters: int = 12,
                 dt: Optional[float] = None,
                 switch_capacity: Optional[int] = None,
                 max_contended_links: int = 8,
                 meters=None) -> ClusterReport:
    """Plan N jobs sharing one physical cluster and stagger their phases.

    ``dt`` is the flow scheduler's time step (None = 1/400 of the shortest
    job period); ``grid`` the CASSINI phase-search resolution;
    ``max_contended_links`` bounds the per-job demand maps to the hottest
    shared links so the phase search stays cheap.  ``switch_capacity``
    (ATP) is forwarded to per-job selection.  ``meters``
    (``repro_torch.obs.meters``) counts the phase-search evaluations."""
    if not jobs:
        raise ValueError("plan_cluster needs at least one JobSpec")
    names = [s.name for s in jobs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate job names: {names}")

    device_blocks = _carve_devices(jobs, topo)
    n_links = topo.graph.number_of_edges()
    plans: List[JobPlan] = []
    for spec, devs in zip(jobs, device_blocks):
        placement = place_mesh(spec.mesh, topo, "custom", custom=devs)
        report = plan(spec.to_problem(topo, placement, cost_model,
                                      switch_capacity, hotspot_k=n_links))
        if spec.serving is not None:
            # per-batch pulse: the prefill batch graph + KV hand-off +
            # one decode step's comm, pressed whenever a batch is in
            # flight (the burst schedule comes from the arrivals)
            profile = JobProfile(spec.name,
                                 max(report.compute_time, 1e-9),
                                 max(report.comm_time, 0.0))
        else:
            profile = _job_profile(spec.name, report)
        plans.append(JobPlan(
            spec=spec, devices=devs, report=report, profile=profile,
            link_bytes=dict(report.link_hotspots)))
    model_name = plans[0].report.cost_model  # as the driver resolved it
    return _stagger_plans(plans, topo, grid=grid,
                          horizon_iters=horizon_iters, dt=dt,
                          max_contended_links=max_contended_links,
                          cost_model=model_name, meters=meters)


def _detect_contention(plans: Sequence[JobPlan], topo: Topology,
                       max_contended_links: int
                       ) -> Tuple[Dict[Tuple, Dict[str, float]],
                                  List[Dict[Tuple, float]]]:
    """Contended links (>= 2 jobs) + per-job demand fractions over them.
    Pure dict math over the plans' link-byte maps — cheap enough to rerun
    on every dynamics event."""
    contended = shared_link_load(
        {jp.spec.name: jp.link_bytes for jp in plans})
    if len(contended) > max_contended_links:
        hottest = sorted(contended,
                         key=lambda l: -sum(contended[l].values()))
        contended = {l: contended[l] for l in hottest[:max_contended_links]}
    link_demands = []
    for jp in plans:
        comm_s = max(jp.profile.comm_s, 1e-12)
        dem = {}
        for link in contended:
            nbytes = jp.link_bytes.get(link, 0.0)
            if nbytes <= 0:
                continue
            bw = topo.link_bw(*link)
            dem[link] = min(1.0, nbytes / (bw * comm_s))
        link_demands.append(dem)
    return contended, link_demands


def _stagger_plans(plans: List[JobPlan], topo: Topology, grid: int,
                   horizon_iters: int, dt: Optional[float],
                   max_contended_links: int, cost_model: str,
                   phases: Optional[Dict[str, float]] = None,
                   dirty: Optional[Sequence[str]] = None,
                   meters=None) -> ClusterReport:
    """The horizontal layer's back half: contention detection -> demand
    maps -> phase search.  With ``phases``/``dirty`` given, only the
    dirty jobs' phases are searched (the rest stay frozen — incremental
    re-planning); otherwise the full CASSINI grid runs."""
    names = [jp.spec.name for jp in plans]
    contended, link_demands = _detect_contention(plans, topo,
                                                 max_contended_links)
    profiles = [jp.profile for jp in plans]

    if not contended:
        # nothing shared: every job runs at its solo JCT, staggering no-op
        solo = {jp.spec.name: jp.profile.period for jp in plans}
        return ClusterReport(
            jobs=plans, contended={},
            phases={n: 0.0 for n in names},
            naive_jct=dict(solo), staggered_jct=dict(solo),
            cost_model=cost_model,
            link_demands={n: {} for n in names},
            serving={jp.spec.name: _solo_serving_metrics(jp.report)
                     for jp in plans if jp.spec.serving is not None})

    if any(jp.spec.serving is not None for jp in plans):
        # training/serving co-tenancy: bursts are pinned by arrivals, so
        # the phase grid only sweeps the training jobs (stagger_mixed);
        # incremental re-staggering redoes the full mixed grid — the
        # sweep is grid**n_training, already the small side
        return _stagger_mixed_plans(plans, topo, contended, link_demands,
                                    grid, horizon_iters, dt, cost_model,
                                    meters)

    if dt is None:
        dt = min(p.period for p in profiles) / 400.0
    if phases is None:
        best_phases, naive, staggered = stagger_jobs(
            profiles, grid=grid, link_demands=link_demands,
            horizon_iters=horizon_iters, dt=dt, meters=meters)
    else:
        current = [phases.get(n, 0.0) for n in names]
        dirty_set = set(names if dirty is None else dirty)
        free = [i for i, n in enumerate(names) if n in dirty_set]
        if len(free) == len(names) and len(free) > 1:
            # every phase free: a uniform shift of all phases is just a
            # time-origin change, so pin the first job as the reference
            # (as stagger_jobs does) and sweep one fewer grid dimension
            free = free[1:]
        best_phases, naive, staggered = restagger_jobs(
            profiles, current, free, grid=grid,
            link_demands=link_demands, horizon_iters=horizon_iters, dt=dt,
            meters=meters)
    return ClusterReport(
        jobs=plans, contended=contended,
        phases=dict(zip(names, best_phases)),
        naive_jct=naive, staggered_jct=staggered,
        cost_model=cost_model,
        link_demands={jp.spec.name: d
                      for jp, d in zip(plans, link_demands)})


def _solo_serving_metrics(report) -> Dict[str, float]:
    """Serving SLO numbers when co-tenancy changes nothing (no shared
    links): naive == staggered == the tenant's solo report."""
    out = {}
    for k in ("ttft_p99", "tpot_p99", "goodput", "slo_attainment"):
        v = float(getattr(report, k))
        out[f"naive_{k}"] = v
        out[f"staggered_{k}"] = v
    out["naive_burst_stretch"] = 1.0
    out["staggered_burst_stretch"] = 1.0
    return out


def _serving_bursts(jp: JobPlan) -> BurstProfile:
    """The serving tenant as the flow scheduler sees it: one comm burst
    per prefill batch (arrival order, batches of ``prefill_batch``), each
    scheduled when its last member arrives and carrying the per-batch
    comm time; FIFO chaining in the simulator models the busy server."""
    spec = jp.spec.serving
    arrivals = spec.arrivals.sample(spec.horizon_s)
    comm_s = jp.profile.comm_s
    starts = [arrivals[min(i + spec.prefill_batch, len(arrivals)) - 1].t
              for i in range(0, len(arrivals), spec.prefill_batch)]
    return BurstProfile(jp.spec.name,
                        tuple((s, comm_s) for s in starts))


def _serving_under_pulses(jp: JobPlan, topo: Topology, cost_model: str,
                          train_plans: Sequence[JobPlan],
                          train_demands: Sequence[Dict[Tuple, float]],
                          phases: Dict[str, float]):
    """Re-price one serving tenant with every training co-tenant folded
    in as a :class:`serving.CotenantPulse` at the given phases.  The
    pulse's comm window starts where the flow scheduler puts it:
    ``compute_s + phase`` into the iteration."""
    from repro_torch.codesign.serving import CotenantPulse, serving_problem
    pulses = []
    for tjp, dem in zip(train_plans, train_demands):
        prof = tjp.profile
        if prof.comm_s <= 0 or not dem:
            continue
        ph = (prof.compute_s
              + phases.get(tjp.spec.name, 0.0)) % prof.period
        pulses.append(CotenantPulse(tjp.spec.name, prof.period,
                                    prof.comm_s, ph, dict(dem)))
    spec2 = dataclasses.replace(jp.spec.serving, cotenants=tuple(pulses))
    placement = place_mesh(jp.spec.mesh, topo, "custom", custom=jp.devices)
    prob = serving_problem(spec2, topo, cost_model=cost_model)
    space = dataclasses.replace(prob.space, placement=Fixed(placement))
    return plan(dataclasses.replace(prob, space=space))


def _stagger_mixed_plans(plans: List[JobPlan], topo: Topology,
                         contended: Dict[Tuple, Dict[str, float]],
                         link_demands: List[Dict[Tuple, float]],
                         grid: int, horizon_iters: int,
                         dt: Optional[float], cost_model: str,
                         meters=None) -> ClusterReport:
    """The co-tenancy back half: CASSINI over the training phases with
    the serving bursts pinned, then serving SLO numbers re-priced under
    the naive (zero-phase) and chosen training pulse trains."""
    names = [jp.spec.name for jp in plans]
    train = [(i, jp) for i, jp in enumerate(plans)
             if jp.spec.serving is None]
    serve = [(i, jp) for i, jp in enumerate(plans)
             if jp.spec.serving is not None]
    tprofiles = [jp.profile for _, jp in train]
    tdemands = [link_demands[i] for i, _ in train]
    bursts = [_serving_bursts(jp) for _, jp in serve]
    bdemands = [link_demands[i] for i, _ in serve]
    if dt is None:
        dt = min(jp.profile.period for jp in plans) / 400.0
    best_phases, (jct0, st0), (jct1, st1) = stagger_mixed(
        tprofiles, bursts, grid=grid, link_demands=tdemands,
        burst_demands=bdemands, horizon_iters=horizon_iters, dt=dt,
        meters=meters)
    phase_map = {jp.spec.name: ph
                 for (_, jp), ph in zip(train, best_phases)}
    naive_jct = dict(jct0)
    staggered_jct = dict(jct1)
    serving_metrics: Dict[str, Dict[str, float]] = {}
    train_plans = [jp for _, jp in train]
    for (_, jp), burst in zip(serve, bursts):
        n = jp.spec.name
        # serving "JCT" entries are per-batch pulse periods (solo); SLO
        # truth lives in the serving dict below
        naive_jct[n] = jp.profile.period
        staggered_jct[n] = jp.profile.period
        zero = {tjp.spec.name: 0.0 for tjp in train_plans}
        rep0 = _serving_under_pulses(jp, topo, cost_model, train_plans,
                                     tdemands, zero)
        rep1 = _serving_under_pulses(jp, topo, cost_model, train_plans,
                                     tdemands, phase_map)
        serving_metrics[n] = {
            "naive_burst_stretch": st0.get(n, 1.0),
            "staggered_burst_stretch": st1.get(n, 1.0),
        }
        for k in ("ttft_p99", "tpot_p99", "goodput", "slo_attainment"):
            serving_metrics[n][f"naive_{k}"] = float(getattr(rep0, k))
            serving_metrics[n][f"staggered_{k}"] = float(getattr(rep1, k))
    phases = {n: phase_map.get(n, 0.0) for n in names}
    return ClusterReport(
        jobs=plans, contended=contended, phases=phases,
        naive_jct=naive_jct, staggered_jct=staggered_jct,
        cost_model=cost_model,
        link_demands={jp.spec.name: d
                      for jp, d in zip(plans, link_demands)},
        serving=serving_metrics)


def restagger_cluster(plans: List[JobPlan], topo: Topology,
                      phases: Dict[str, float],
                      dirty: Sequence[str], grid: int = 8,
                      horizon_iters: int = 12, dt: Optional[float] = None,
                      max_contended_links: int = 8,
                      cost_model: str = "flowsim",
                      meters=None) -> ClusterReport:
    """Incrementally re-stagger a cluster plan: jobs named in ``dirty``
    get fresh phase offsets, everyone else keeps ``phases``.  This is
    the horizontal half of event-driven re-planning — contention is
    re-detected from the plans' (possibly re-routed) link maps, but the
    phase grid only sweeps the jobs whose demand actually changed, so
    the search is ``grid**len(dirty)`` instead of ``grid**(n-1)``.

    ``naive_jct`` in the returned report is the cluster at the *frozen*
    phases (the do-nothing baseline an event leaves behind), so
    ``stagger_speedup`` measures what the incremental re-stagger
    recovered."""
    if not plans:
        raise ValueError("restagger_cluster needs at least one JobPlan")
    names = {jp.spec.name for jp in plans}
    unknown = set(dirty) - names
    if unknown:
        raise ValueError(f"dirty jobs {sorted(unknown)} not in cluster "
                         f"{sorted(names)}")
    return _stagger_plans(plans, topo, grid=grid,
                          horizon_iters=horizon_iters, dt=dt,
                          max_contended_links=max_contended_links,
                          cost_model=cost_model, phases=phases,
                          dirty=dirty, meters=meters)
