"""Flow scheduler — "Horizontal" co-design across jobs (paper Sec. IV-A).

Multiple training jobs' iterations are periodic bandwidth pulses (compute
phase, then a communication burst).  When bursts from different jobs hit a
shared link simultaneously, both stretch (the Fig. 5(b) case at (2)).
CASSINI's observation: shifting jobs' iteration *phases* interleaves the
bursts ("staggering peak") and recovers most of the loss.

We model each job as a rectangular bandwidth-demand pulse train and compute
the stretch factor of the communication phase under proportional max-min
sharing, then search over phase shifts to minimize the worst JCT.

Two granularities:

  * single link — every job presses ``JobProfile.demand_frac`` onto one
    shared link (the original CASSINI toy model);
  * a **set of contended links** — each job carries a per-link demand map
    (``link_demands``) derived from its ``CodesignReport`` hot-spot map by
    ``codesign.cluster.plan_cluster``; a job's burst progresses at the rate
    of its most-contended link (the network-layer bottleneck rule).

The simulator steps from phase transition to phase transition (rates are
piecewise constant in between), so results are exact and independent of
the ``dt`` knob, which survives in signatures as a floating-point fallback
step — see ``tests/test_sched.py``'s convergence check.

The port's copy of ``repro.sched.flows``, kept line for line: importing any
``repro`` module runs the JAX package's ``__init__``, which imports jax, so
the port keeps its own.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

LinkDemands = Sequence[Dict[Hashable, float]]  # per-job {link: demand frac}


@dataclass(frozen=True)
class JobProfile:
    """One training job as seen by the shared network."""

    name: str
    compute_s: float        # compute phase duration per iteration
    comm_s: float           # communication burst duration (alone on link)
    demand_frac: float = 1.0  # fraction of the link the burst wants

    @property
    def period(self) -> float:
        return self.compute_s + self.comm_s


def _simulate_links(jobs: Sequence[JobProfile], phases: Sequence[float],
                    link_demands: Optional[LinkDemands] = None,
                    horizon_iters: int = 20, dt: float = 1e-4
                    ) -> Dict[str, float]:
    """Time-stepped sharing of a set of contended links.

    Each job alternates compute (no demand) and comm phases; during comm it
    presses its per-link demand fractions onto every link in its map, and
    its burst progresses at the rate of its most oversubscribed link
    (proportional sharing: rate = min over links of 1/total_demand, capped
    at 1).  Returns average iteration time ('JCT') per job."""
    if len(phases) != len(jobs):
        raise ValueError(f"{len(phases)} phases for {len(jobs)} jobs")
    if link_demands is None:
        link_demands = [{"shared": j.demand_frac} for j in jobs]
    elif len(link_demands) != len(jobs):
        raise ValueError(f"{len(link_demands)} link-demand maps for "
                         f"{len(jobs)} jobs")
    t = 0.0
    state = []
    for j, ph in zip(jobs, phases):
        state.append({
            "job": j, "phase": "compute",
            "remaining": j.compute_s + (ph % j.period),
            "iters": 0, "t_done": [],
        })
    # run until EVERY job finishes its horizon (a global iteration budget
    # would starve a slow tenant sharing with a much faster one and report
    # inf); the wall-clock cap guards pathological stretch
    max_t = horizon_iters * max(j.period for j in jobs) * (len(jobs) + 3)
    # Event-driven stepping: link demand (and so every job's rate) is
    # piecewise constant between phase transitions, so advancing exactly
    # onto the next transition integrates the sharing model *exactly*.
    # The old fixed-dt loop discarded each transition's overshoot and
    # held other jobs' rates stale across the transition step, an O(dt)
    # bias per phase per job that made dt-halving converge only first
    # order.  ``dt`` is kept as a public knob / fp fallback: steps never
    # need to be smaller than the next event, so results are now
    # dt-independent (dt-halving changes nothing but runtime).
    while any(s["iters"] < horizon_iters for s in state) and t < max_t:
        total_d: Dict[Hashable, float] = {}
        for s, dem in zip(state, link_demands):
            if s["phase"] == "comm":
                for link, d in dem.items():
                    total_d[link] = total_d.get(link, 0.0) + d
        rates = []
        for s, dem in zip(state, link_demands):
            if s["phase"] == "compute":
                rates.append(1.0)
            else:
                rate = 1.0
                for link in dem:
                    td = total_d.get(link, 0.0)
                    if td > 1.0:
                        rate = min(rate, 1.0 / td)
                rates.append(rate)
        step = min((s["remaining"] / r for s, r in zip(state, rates)
                    if r > 0), default=dt)
        step = max(step, 1e-12)  # fp guard: always make progress
        for s, rate in zip(state, rates):
            s["remaining"] -= step * rate
            if s["remaining"] <= 1e-12:
                if s["phase"] == "compute":
                    s["phase"] = "comm"
                    s["remaining"] = s["job"].comm_s
                else:
                    s["phase"] = "compute"
                    s["remaining"] = s["job"].compute_s
                    s["iters"] += 1
                    s["t_done"].append(t + step)
        t += step
    out = {}
    for s in state:
        if s["iters"] >= 2:
            d = s["t_done"]
            out[s["job"].name] = (d[-1] - d[0]) / (len(d) - 1)
        else:
            out[s["job"].name] = float("inf")
    return out


def _simulate_link(jobs: Sequence[JobProfile], phases: Sequence[float],
                   horizon_iters: int = 20, dt: float = 1e-4
                   ) -> Dict[str, float]:
    """Single shared link (every job demands ``demand_frac`` of it)."""
    return _simulate_links(jobs, phases, None, horizon_iters, dt)


# ---------------------------------------------------------------------------
# Non-periodic (arrival-driven) profiles: the serving path
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BurstProfile:
    """A non-periodic tenant as seen by the shared network: an explicit
    list of communication bursts at absolute ``(scheduled_start_s,
    comm_s)`` — e.g. a serving tenant's per-batch transfer windows under
    an open-loop arrival process.  Bursts are FIFO-chained: a burst
    starts at ``max(scheduled_start, previous burst's finish)`` (one
    transfer engine per tenant), so queueing delay propagates."""

    name: str
    bursts: Tuple[Tuple[float, float], ...] = ()
    demand_frac: float = 1.0

    @property
    def total_comm_s(self) -> float:
        return sum(c for _, c in self.bursts)


def _simulate_mixed(jobs: Sequence[JobProfile], phases: Sequence[float],
                    bursts: Sequence[BurstProfile],
                    link_demands: Optional[LinkDemands] = None,
                    burst_demands: Optional[LinkDemands] = None,
                    horizon_iters: int = 20, dt: float = 1e-4
                    ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Periodic pulse trains and non-periodic burst tenants sharing one
    set of links.  Same exact event-driven engine as
    :func:`_simulate_links` (rates are piecewise constant between phase
    transitions / burst starts), with burst tenants idle between their
    scheduled windows.  Returns ``(avg iteration time per periodic job,
    comm stretch per burst tenant)`` — stretch = total contended burst
    time / total solo burst time (1.0 = unaffected)."""
    if len(phases) != len(jobs):
        raise ValueError(f"{len(phases)} phases for {len(jobs)} jobs")
    if link_demands is None:
        link_demands = [{"shared": j.demand_frac} for j in jobs]
    if burst_demands is None:
        burst_demands = [{"shared": b.demand_frac} for b in bursts]
    if len(link_demands) != len(jobs) or len(burst_demands) != len(bursts):
        raise ValueError("demand maps must match jobs/bursts 1:1")
    t = 0.0
    state = []
    for j, ph in zip(jobs, phases):
        state.append({"job": j, "phase": "compute",
                      "remaining": j.compute_s + (ph % j.period),
                      "iters": 0, "t_done": []})
    bstate = []
    for b in bursts:
        bstate.append({"prof": b, "i": 0, "active": False,
                       "remaining": 0.0, "busy": 0.0})
    horizon_t = max((b.bursts[-1][0] for b in bursts if b.bursts),
                    default=0.0)
    periods = [j.period for j in jobs]
    max_t = (horizon_iters * max(periods, default=1.0)
             * (len(jobs) + len(bursts) + 3)) + 2 * horizon_t + 1.0

    def unfinished() -> bool:
        if any(s["iters"] < horizon_iters for s in state):
            return True
        return any(bs["active"] or bs["i"] < len(bs["prof"].bursts)
                   for bs in bstate)

    while unfinished() and t < max_t:
        # start any burst whose scheduled time has come (FIFO per tenant)
        for bs in bstate:
            if not bs["active"] and bs["i"] < len(bs["prof"].bursts):
                sched, comm = bs["prof"].bursts[bs["i"]]
                if t >= sched - 1e-12:
                    bs["active"] = True
                    bs["remaining"] = comm
        total_d: Dict[Hashable, float] = {}
        for s, dem in zip(state, link_demands):
            if s["phase"] == "comm":
                for link, d in dem.items():
                    total_d[link] = total_d.get(link, 0.0) + d
        for bs, dem in zip(bstate, burst_demands):
            if bs["active"]:
                for link, d in dem.items():
                    total_d[link] = total_d.get(link, 0.0) + d

        def rate_of(dem) -> float:
            rate = 1.0
            for link in dem:
                td = total_d.get(link, 0.0)
                if td > 1.0:
                    rate = min(rate, 1.0 / td)
            return rate

        rates = [1.0 if s["phase"] == "compute" else rate_of(dem)
                 for s, dem in zip(state, link_demands)]
        brates = [rate_of(dem) if bs["active"] else 0.0
                  for bs, dem in zip(bstate, burst_demands)]
        events = [s["remaining"] / r for s, r in zip(state, rates) if r > 0]
        events += [bs["remaining"] / r for bs, r in zip(bstate, brates)
                   if bs["active"] and r > 0]
        # idle bursts wake at their scheduled start — that's an event too
        for bs in bstate:
            if not bs["active"] and bs["i"] < len(bs["prof"].bursts):
                events.append(max(bs["prof"].bursts[bs["i"]][0] - t, 0.0))
        step = max(min(events, default=dt), 1e-12)
        for s, rate in zip(state, rates):
            s["remaining"] -= step * rate
            if s["remaining"] <= 1e-12:
                if s["phase"] == "compute":
                    s["phase"] = "comm"
                    s["remaining"] = s["job"].comm_s
                else:
                    s["phase"] = "compute"
                    s["remaining"] = s["job"].compute_s
                    s["iters"] += 1
                    s["t_done"].append(t + step)
        for bs, rate in zip(bstate, brates):
            if bs["active"]:
                bs["remaining"] -= step * rate
                bs["busy"] += step
                if bs["remaining"] <= 1e-12:
                    bs["active"] = False
                    bs["i"] += 1
        t += step
    jct: Dict[str, float] = {}
    for s in state:
        if s["iters"] >= 2:
            d = s["t_done"]
            jct[s["job"].name] = (d[-1] - d[0]) / (len(d) - 1)
        else:
            jct[s["job"].name] = float("inf")
    stretch: Dict[str, float] = {}
    for bs in bstate:
        solo = bs["prof"].total_comm_s
        stretch[bs["prof"].name] = bs["busy"] / solo if solo > 0 else 1.0
    return jct, stretch


def multi_job_jct(jobs: Sequence[JobProfile], phases: Sequence[float],
                  link_demands: Optional[LinkDemands] = None,
                  horizon_iters: int = 20, dt: float = 1e-4
                  ) -> Dict[str, float]:
    """Average iteration time per job at the given phase offsets."""
    return _simulate_links(jobs, phases, link_demands, horizon_iters, dt)


def worst_stretch(jct: Dict[str, float],
                  jobs: Sequence[JobProfile]) -> float:
    """Worst relative slowdown vs. running alone (>= 1 up to dt noise)."""
    return max(jct[j.name] / j.period for j in jobs)


def stagger_jobs(jobs: Sequence[JobProfile], grid: int = 8,
                 link_demands: Optional[LinkDemands] = None,
                 horizon_iters: int = 20, dt: float = 1e-4, meters=None
                 ) -> Tuple[Tuple[float, ...], Dict[str, float],
                            Dict[str, float]]:
    """CASSINI-style phase search: grid over phase offsets of jobs[1:]
    (job 0 pinned at 0), minimizing the worst relative slowdown.
    Returns (best_phases, jct_unstaggered, jct_staggered).  The zero-phase
    schedule is always in the search set, so the staggered worst case is
    never worse than the naive one.  ``meters`` (``repro_torch.obs.meters``)
    counts the grid points simulated."""

    base_phases = tuple(0.0 for _ in jobs)

    def sim(phases):
        if meters is not None:
            meters.incr("flows.stagger.evals")
        return _simulate_links(jobs, phases, link_demands, horizon_iters, dt)

    base = sim(base_phases)
    best = base_phases
    best_jct = base
    best_val = worst_stretch(base, jobs)
    grids = [[i / grid * j.period for i in range(grid)] for j in jobs[1:]]
    for combo in itertools.product(*grids):
        phases = (0.0, *combo)
        jct = sim(phases)
        val = worst_stretch(jct, jobs)
        if val < best_val - 1e-9:
            best_val = val
            best = phases
            best_jct = jct
    return best, base, best_jct


def stagger_mixed(jobs: Sequence[JobProfile],
                  bursts: Sequence[BurstProfile], grid: int = 8,
                  link_demands: Optional[LinkDemands] = None,
                  burst_demands: Optional[LinkDemands] = None,
                  horizon_iters: int = 20, dt: float = 1e-4, meters=None
                  ) -> Tuple[Tuple[float, ...],
                             Tuple[Dict[str, float], Dict[str, float]],
                             Tuple[Dict[str, float], Dict[str, float]]]:
    """CASSINI for training/serving co-tenancy: grid over the periodic
    jobs' phase offsets with the serving bursts pinned at their
    arrival-driven absolute times (you cannot stagger a user's request),
    minimizing the worst of (training stretch, serving burst stretch).

    Returns ``(best_phases, (jct, burst_stretch) naive,
    (jct, burst_stretch) staggered)``.  The zero-phase schedule is in the
    search set, so the staggered worst case is never worse."""

    def sim(phases):
        if meters is not None:
            meters.incr("flows.stagger_mixed.evals")
        return _simulate_mixed(jobs, phases, bursts, link_demands,
                               burst_demands, horizon_iters, dt)

    def val(jct, stretch):
        worst = max(stretch.values(), default=1.0)
        if jobs:
            worst = max(worst, worst_stretch(jct, jobs))
        return worst

    base_phases = tuple(0.0 for _ in jobs)
    base = sim(base_phases)
    best, best_res, best_val = base_phases, base, val(*base)
    # every periodic job is free: the bursts are the pinned reference
    grids = [[i / grid * j.period for i in range(grid)] for j in jobs]
    for combo in itertools.product(*grids):
        phases = tuple(combo)
        if phases == base_phases:
            continue
        res = sim(phases)
        v = val(*res)
        if v < best_val - 1e-9:
            best_val, best, best_res = v, phases, res
    return best, base, best_res


def restagger_jobs(jobs: Sequence[JobProfile], phases: Sequence[float],
                   free: Sequence[int], grid: int = 8,
                   link_demands: Optional[LinkDemands] = None,
                   horizon_iters: int = 20, dt: float = 1e-4, meters=None
                   ) -> Tuple[Tuple[float, ...], Dict[str, float],
                              Dict[str, float]]:
    """Incremental CASSINI: search phase offsets only for the jobs at the
    ``free`` indices, holding every other job at its current phase — the
    horizontal half of event-driven re-planning (``codesign.dynamics``),
    where only the jobs touching changed links are dirty and the full
    ``grid**(n-1)`` sweep of :func:`stagger_jobs` is wasted work.

    Returns ``(best_phases, jct_at_current_phases, jct_staggered)``.  The
    current phase vector is in the search set, so the re-staggered worst
    case is never worse than leaving the phases untouched."""
    if len(phases) != len(jobs):
        raise ValueError(f"{len(phases)} phases for {len(jobs)} jobs")
    bad = [i for i in free if not 0 <= i < len(jobs)]
    if bad:
        raise ValueError(f"free indices {bad} out of range for "
                         f"{len(jobs)} jobs")
    base_phases = tuple(phases)

    def sim(ph):
        if meters is not None:
            meters.incr("flows.restagger.evals")
        return _simulate_links(jobs, ph, link_demands, horizon_iters, dt)

    base = sim(base_phases)
    best = base_phases
    best_jct = base
    best_val = worst_stretch(base, jobs)
    free = sorted(set(free))
    grids = [[i / grid * jobs[f].period for i in range(grid)]
             for f in free]
    for combo in itertools.product(*grids):
        ph = list(base_phases)
        for f, v in zip(free, combo):
            ph[f] = v
        jct = sim(tuple(ph))
        val = worst_stretch(jct, jobs)
        if val < best_val - 1e-9:
            best_val = val
            best = tuple(ph)
            best_jct = jct
    return best, base, best_jct
