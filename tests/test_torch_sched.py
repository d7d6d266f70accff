"""Twin of tests/test_sched.py and tests/test_arrivals.py: the port's
scheduler layers (``repro_torch.sched.tasks``, ``sched.flows``,
``sched.arrivals``) against the JAX package's on the same inputs,
exactly: every ``SimResult`` (timeline, exposure attribution, algorithm
choices) under each policy, every multi-job JCT, phase search and
re-stagger, every sampled arrival stream.  Each test of the two JAX files
also runs on the port."""
import dataclasses
import json

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.ccl.cost import CostParams, algo_cost
from repro_torch.ccl.select import select_algorithm
from repro_torch.configs import get_config
from repro_torch.core.demand import CommDemand, CommTask, ComputeTask
from repro_torch.core.demand_builder import build_demand, janus_traffic_ratio
from repro_torch.core.types import SHAPES_BY_NAME, SINGLE_POD_MESH
from repro_torch.sched.arrivals import (Arrival, PoissonArrivals,
                                        TraceArrivals, arrivals_from_dict,
                                        arrivals_to_dict, demand_series,
                                        offered_load)
from repro_torch.sched.flows import (BurstProfile, JobProfile, multi_job_jct,
                                     restagger_jobs, stagger_jobs,
                                     stagger_mixed, worst_stretch)
from repro_torch.sched.tasks import simulate_iteration
from torch_twin import same, same_raises, twin

CP = CostParams()
POLICIES = ["serial", "fifo", "priority", "slack", "preempt"]


def _cost(t):
    if t.primitive == "all_reduce":
        return select_algorithm(t.primitive, t.size_bytes, len(t.group),
                                CP)[1]
    algo = "direct" if t.primitive == "all_to_all" else "ring"
    return algo_cost(t.primitive, algo, t.size_bytes, len(t.group), CP)


def _cost_of(pkg):
    """``_cost`` in package ``pkg``."""
    cp = pkg.ccl.cost.CostParams()

    def cost(t):
        if t.primitive == "all_reduce":
            return pkg.ccl.select.select_algorithm(
                t.primitive, t.size_bytes, len(t.group), cp)[1]
        algo = "direct" if t.primitive == "all_to_all" else "ring"
        return pkg.ccl.cost.algo_cost(t.primitive, algo, t.size_bytes,
                                      len(t.group), cp)
    return cost


@pytest.fixture
def pinned_peak(monkeypatch):
    import repro.core.hw as ref_hw
    import repro_torch.core.hw as port_hw
    monkeypatch.setattr(port_hw, "PEAK_FLOPS_BF16", ref_hw.PEAK_FLOPS_BF16)


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ["granite-3-8b", "dbrx-132b",
                                  "jamba-1.5-large-398b"])
def test_simulate_iteration_equals_reference(pinned_peak, arch, policy):
    """The JAX tests' demands (train_4k on the single-pod mesh) under each
    policy: the same ``SimResult``, timeline segment for segment."""
    same(lambda pkg: pkg.sched.tasks.simulate_iteration(
        pkg.core.demand_builder.build_demand(
            pkg.configs.get_config(arch), pkg.core.types.SHAPES_BY_NAME[
                "train_4k"], pkg.core.types.SINGLE_POD_MESH),
        _cost_of(pkg), policy))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("model", ["alphabeta", "flowsim"])
def test_simulate_iteration_with_selection_equals_reference(
        pinned_peak, model, policy):
    """The planner's loop: a DP-2 x TP-8 qwen2-0.5b demand with 64 MiB
    gradient buckets on ``dgx_cluster(2)``, each task priced by
    ``select_for_task`` (returning ``(seconds, algorithm)``), then the
    result's trace."""
    def run(pkg):
        topo = pkg.net.topology.dgx_cluster(2)
        mesh = pkg.core.types.MeshConfig(shape=(2, 8),
                                         axis_names=("data", "model"))
        dem = pkg.core.demand_builder.build_demand(
            pkg.configs.get_config("qwen2-0.5b"),
            pkg.core.types.ShapeConfig("t", 512, 32, "train"), mesh,
            bucket_bytes=64 * 2 ** 20)
        sel = pkg.ccl.select
        m = (sel.AlphaBeta.from_topology(topo) if model == "alphabeta"
             else sel.FlowSim(topo))

        def cost(t):
            s = sel.select_for_task(t, m)
            return s.cost, s.algorithm
        r = pkg.sched.tasks.simulate_iteration(dem, cost, policy)
        return r, r.comm_fraction, r.to_trace().to_json()
    same(run)


@given(st.lists(st.tuples(st.floats(1e-4, 1e-2), st.floats(1e-5, 1e-2)),
                min_size=1, max_size=12),
       st.sampled_from(POLICIES))
@settings(max_examples=30, deadline=None)
def test_random_graphs_equal_reference(layers, policy):
    def run(pkg):
        d = pkg.core.demand
        demand = d.CommDemand()
        for i, (comp, comm) in enumerate(layers):
            demand.compute_tasks.append(d.ComputeTask(f"fwd{i}", 0.0, comp))
            demand.comm_tasks.append(d.CommTask(
                f"c{i}", "all_reduce", int(comm * 50e9), tuple(range(4)),
                after_compute=(f"fwd{i}",),
                before_compute=f"fwd{i+1}" if i + 1 < len(layers) else None,
                slack=comp * (i % 3)))
        demand.compute_tasks.append(d.ComputeTask("tail", 0.0, 1e-4))
        return pkg.sched.tasks.simulate_iteration(demand, _cost_of(pkg),
                                                  policy)
    same(run)


def _jobs(pkg, specs):
    return [pkg.sched.flows.JobProfile(f"j{i}", *s)
            for i, s in enumerate(specs)]


JOB_SPECS = [(0.012, 0.008), (0.010, 0.010, 0.7), (0.003, 0.004)]


def test_flow_scheduler_equals_reference():
    """``multi_job_jct`` (one shared link and link maps), ``stagger_jobs``
    with its meters, ``restagger_jobs`` and ``worst_stretch``."""
    def run(pkg):
        fl = pkg.sched.flows
        jobs = _jobs(pkg, JOB_SPECS)
        m = pkg.obs.meters.Meters()
        demands = [{"l1": 1.0}, {"l1": 0.5, "l2": 1.0}, {"l2": 0.8}]
        out = [fl.multi_job_jct(jobs, (0.0, 0.003, 0.001)),
               fl.multi_job_jct(jobs, (0.0, 0.0, 0.0), link_demands=demands,
                                horizon_iters=10, dt=2e-5),
               fl.stagger_jobs(jobs, grid=4, horizon_iters=6, meters=m),
               fl.restagger_jobs(jobs, (0.0, 0.002, 0.001), [1, 2], grid=3,
                                 horizon_iters=6, meters=m),
               m.snapshot()]
        out.append(fl.worst_stretch(out[0], jobs))
        return out
    same(run)


def test_stagger_mixed_equals_reference():
    """Training jobs beside a serving tenant's bursts."""
    def run(pkg):
        fl = pkg.sched.flows
        jobs = _jobs(pkg, JOB_SPECS[:2])
        bursts = [fl.BurstProfile("serve", ((0.001, 0.002), (0.004, 0.001),
                                            (0.02, 0.003)), 0.6)]
        m = pkg.obs.meters.Meters()
        return (fl.stagger_mixed(jobs, bursts, grid=3, horizon_iters=5,
                                 meters=m),
                fl.stagger_mixed([], bursts, grid=2, horizon_iters=3),
                bursts[0].total_comm_s, m.snapshot())
    same(run)


def test_flow_scheduler_errors_equal_reference():
    for bad in (
            lambda pkg: pkg.sched.flows.multi_job_jct(
                _jobs(pkg, JOB_SPECS[:2]), (0.0, 0.0),
                link_demands=[{"l": 1.0}]),
            lambda pkg: pkg.sched.flows.multi_job_jct(
                _jobs(pkg, JOB_SPECS[:2]), (0.0,)),
            lambda pkg: pkg.sched.flows.restagger_jobs(
                _jobs(pkg, JOB_SPECS[:2]), (0.0,), [0]),
            lambda pkg: pkg.sched.flows.restagger_jobs(
                _jobs(pkg, JOB_SPECS[:2]), (0.0, 0.0), [5])):
        same_raises(bad, "ValueError")


@pytest.mark.parametrize("seed", [0, 3, 2 ** 32])
def test_arrivals_equal_reference(seed):
    """Seeded Poisson streams (the splitmix64 generator, bit for bit),
    traces, their dict round trips, offered load and demand series."""
    def run(pkg):
        ar = pkg.sched.arrivals
        p = ar.PoissonArrivals(rate_rps=37.5, prompt_tokens=64,
                               decode_tokens=4, seed=seed)
        a = p.sample(5.0)
        tr = ar.TraceArrivals((ar.Arrival("b", 0.5, 128, 16),
                               ar.Arrival("a", 0.1, 256, 8)))
        return (a, ar.arrivals_to_dict(p), ar.arrivals_to_dict(tr),
                ar.arrivals_from_dict(ar.arrivals_to_dict(p)).sample(1.0),
                tr.sample(0.3), ar.offered_load(a, 5.0),
                ar.demand_series(a, 5.0, window_s=0.5),
                [x.to_dict() for x in a[:3]])
    same(run)


def test_janus_equals_reference():
    same(lambda pkg: [pkg.core.demand_builder.janus_traffic_ratio(
        pkg.configs.get_config(arch), pkg.core.types.SHAPES_BY_NAME[s],
        pkg.core.types.SINGLE_POD_MESH)
        for arch in ("dbrx-132b", "deepseek-v2-236b", "qwen2-0.5b")
        for s in ("train_4k", "decode_32k")])


# ---------------------------------------------------------------------------
# the tests of tests/test_sched.py on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-3-8b", "dbrx-132b",
                                  "jamba-1.5-large-398b"])
def test_overlap_beats_serial(arch):
    dem = build_demand(get_config(arch), SHAPES_BY_NAME["train_4k"],
                       SINGLE_POD_MESH)
    serial = simulate_iteration(dem, _cost, "serial")
    for pol in ("fifo", "priority", "slack"):
        r = simulate_iteration(dem, _cost, pol)
        assert r.jct <= serial.jct + 1e-9, (arch, pol)
        assert r.exposed_comm <= serial.exposed_comm + 1e-9
    assert 0.0 < serial.exposed_comm / serial.jct < 1.0


@pytest.mark.parametrize("arch", ["granite-3-8b", "dbrx-132b"])
@pytest.mark.parametrize("policy", ["serial", "fifo", "priority", "slack"])
def test_sim_invariants(arch, policy):
    dem = build_demand(get_config(arch), SHAPES_BY_NAME["train_4k"],
                       SINGLE_POD_MESH)
    r = simulate_iteration(dem, _cost, policy)
    assert r.jct >= r.compute_time - 1e-9
    assert r.exposed_comm <= r.comm_time + 1e-9
    assert r.jct <= r.compute_time + r.comm_time + 1e-9


@given(st.lists(st.tuples(st.floats(1e-4, 1e-2), st.floats(1e-5, 1e-2)),
                min_size=1, max_size=12),
       st.sampled_from(["fifo", "priority", "slack"]))
@settings(max_examples=30, deadline=None)
def test_random_graphs_bounds(layers, policy):
    demand = CommDemand()
    for i, (comp, comm) in enumerate(layers):
        demand.compute_tasks.append(ComputeTask(f"fwd{i}", 0.0, comp))
        demand.comm_tasks.append(CommTask(
            f"c{i}", "all_reduce", int(comm * 50e9), tuple(range(4)),
            after_compute=(f"fwd{i}",),
            before_compute=f"fwd{i+1}" if i + 1 < len(layers) else None))
    demand.compute_tasks.append(ComputeTask("tail", 0.0, 1e-4))
    r = simulate_iteration(demand, _cost, policy)
    total_comp = sum(c.duration for c in demand.compute_tasks)
    assert r.jct >= total_comp - 1e-12
    assert r.jct <= total_comp + r.comm_time + 1e-9


def _stranded_blocker(pkg):
    d = pkg.core.demand
    demand = d.CommDemand()
    demand.compute_tasks = [d.ComputeTask("c0", 0, 10e-3)] + [
        d.ComputeTask(f"c{i}", 0, 25e-3) for i in range(1, 6)
    ] + [d.ComputeTask("opt", 0, 1e-3)]
    demand.comm_tasks = [
        d.CommTask("grad", "all_reduce", int(100e-3 * 50e9), (0, 1),
                   after_compute=("c0",), before_compute="opt", slack=1.0),
        d.CommTask("a2a", "all_to_all", int(20e-3 * 50e9 * 2), (0, 1),
                   after_compute=("c0",), before_compute="c1", slack=0.0),
    ]
    cp = pkg.ccl.cost.CostParams(alpha=1e-6, link_bw=50e9)

    def cost(t):
        if t.primitive == "all_reduce":
            return pkg.ccl.select.select_algorithm(
                t.primitive, t.size_bytes, len(t.group), cp)[1]
        return pkg.ccl.cost.algo_cost(t.primitive, "direct", t.size_bytes,
                                      len(t.group), cp)
    return [pkg.sched.tasks.simulate_iteration(demand, cost, p)
            for p in ("fifo", "preempt")]


def test_preemption_beats_fifo_on_stranded_blocker():
    _, (fifo, pre) = same(_stranded_blocker)
    assert pre.jct < fifo.jct * 0.85
    assert pre.comm_time == pytest.approx(fifo.comm_time, rel=1e-6)


def test_janus_matches_paper_claim():
    ratio = janus_traffic_ratio(get_config("dbrx-132b"),
                                SHAPES_BY_NAME["train_4k"],
                                SINGLE_POD_MESH)["ratio"]
    assert 8 <= ratio <= 32


def test_stagger_improves_contended_jobs():
    jobs = [JobProfile("j1", 0.010, 0.010),
            JobProfile("j2", 0.010, 0.010)]
    phases, base, best = stagger_jobs(jobs, grid=4)
    worst_base = max(base[j.name] / j.period for j in jobs)
    worst_best = max(best[j.name] / j.period for j in jobs)
    assert worst_best <= worst_base + 1e-6
    assert worst_best < 1.2
    assert worst_base > 1.2


def test_multi_job_no_contention_when_alone():
    jobs = [JobProfile("solo", 0.01, 0.005)]
    jct = multi_job_jct(jobs, [0.0])
    assert jct["solo"] == pytest.approx(0.015, rel=0.05)


@given(st.lists(st.tuples(st.floats(2e-3, 2e-2), st.floats(2e-3, 2e-2)),
                min_size=1, max_size=3))
@settings(max_examples=6, deadline=None)
def test_stretch_at_least_one_and_stagger_never_worse(specs):
    jobs = [JobProfile(f"j{i}", comp, comm)
            for i, (comp, comm) in enumerate(specs)]
    dt = min(j.period for j in jobs) / 300
    phases, base, best = stagger_jobs(jobs, grid=3, horizon_iters=6, dt=dt)
    for j in jobs:
        assert base[j.name] >= j.period * 0.97
        assert best[j.name] >= j.period * 0.97
    assert worst_stretch(best, jobs) <= worst_stretch(base, jobs) + 1e-9
    assert phases[0] == 0.0


@given(st.floats(2e-3, 2e-2), st.floats(2e-3, 2e-2))
@settings(max_examples=5, deadline=None)
def test_single_job_staggering_is_noop(comp, comm):
    job = JobProfile("solo", comp, comm)
    dt = job.period / 300
    phases, base, best = stagger_jobs([job], grid=5, horizon_iters=6, dt=dt)
    assert phases == (0.0,)
    assert base == best
    assert base["solo"] == pytest.approx(job.period, rel=0.03)


def test_multi_link_contention_is_localized():
    jobs = [JobProfile("a", 0.01, 0.01), JobProfile("b", 0.01, 0.01),
            JobProfile("c", 0.01, 0.01)]
    demands = [{"l1": 1.0}, {"l1": 1.0}, {"l2": 0.8}]
    jct = multi_job_jct(jobs, (0.0, 0.0, 0.0), link_demands=demands,
                        horizon_iters=10)
    assert jct["c"] == pytest.approx(0.02, rel=0.03)
    assert jct["a"] > 0.0215 and jct["b"] > 0.0215
    demands2 = [{"l1": 1.0, "l3": 1.0}, {"l1": 1.0}, {"l2": 0.8}]
    jct2 = multi_job_jct(jobs, (0.0, 0.0, 0.0), link_demands=demands2,
                         horizon_iters=10)
    assert jct2["a"] == pytest.approx(jct["a"], rel=1e-6)


def test_heterogeneous_periods_stay_finite():
    jobs = [JobProfile("fast", 0.001, 0.001), JobProfile("slow", 0.02, 0.02)]
    jct = multi_job_jct(jobs, (0.0, 0.0),
                        link_demands=[{"l": 1.0}, {"l": 1.0}],
                        horizon_iters=12, dt=2e-5)
    assert all(v != float("inf") for v in jct.values())
    assert jct["fast"] >= 0.002 * 0.97
    assert 0.04 * 0.97 <= jct["slow"] <= 0.08


def test_simulate_link_dt_convergence():
    jobs = [JobProfile("a", 0.012, 0.008), JobProfile("b", 0.010, 0.010)]
    coarse = multi_job_jct(jobs, (0.0, 0.003), horizon_iters=20, dt=1e-4)
    fine = multi_job_jct(jobs, (0.0, 0.003), horizon_iters=20, dt=5e-5)
    for name in coarse:
        assert coarse[name] == pytest.approx(fine[name], rel=1e-9)
    solo = multi_job_jct([jobs[0]], (0.0,), horizon_iters=10, dt=1e-3)
    assert solo["a"] == pytest.approx(jobs[0].period, rel=1e-9)


@given(st.lists(st.tuples(st.floats(2e-3, 2e-2), st.floats(2e-3, 2e-2),
                          st.floats(0.0, 1.0)),
                min_size=2, max_size=3),
       st.floats(1e-4, 2e-3))
@settings(max_examples=8, deadline=None)
def test_simulate_links_dt_independent(specs, dt):
    jobs = [JobProfile(f"j{i}", comp, comm)
            for i, (comp, comm, _) in enumerate(specs)]
    phases = tuple(frac * j.period for (_, _, frac), j in zip(specs, jobs))
    a = multi_job_jct(jobs, phases, horizon_iters=6, dt=dt)
    b = multi_job_jct(jobs, phases, horizon_iters=6, dt=dt / 2)
    for name in a:
        assert a[name] == pytest.approx(b[name], rel=1e-9)


@given(st.lists(st.tuples(st.floats(2e-3, 2e-2), st.floats(2e-3, 2e-2)),
                min_size=2, max_size=3),
       st.integers(0, 2))
@settings(max_examples=6, deadline=None)
def test_restagger_never_worse_than_frozen(specs, free_idx):
    jobs = [JobProfile(f"j{i}", comp, comm)
            for i, (comp, comm) in enumerate(specs)]
    free_idx = free_idx % len(jobs)
    current = [0.25 * j.period for j in jobs]
    best, base, staggered = restagger_jobs(jobs, current, [free_idx],
                                           grid=3, horizon_iters=6)
    assert worst_stretch(staggered, jobs) <= worst_stretch(base, jobs) + 1e-9
    for i, (b, c) in enumerate(zip(best, current)):
        if i != free_idx:
            assert b == pytest.approx(c)


def test_stagger_mixed_never_worse():
    jobs = [JobProfile("a", 0.01, 0.01)]
    bursts = [BurstProfile("s", ((0.0, 0.005), (0.02, 0.005)))]
    best, base, staggered = stagger_mixed(jobs, bursts, grid=4,
                                          horizon_iters=6)

    def worst(res):
        jct, stretch = res
        return max(max(stretch.values()), worst_stretch(jct, jobs))
    assert worst(staggered) <= worst(base) + 1e-9


# ---------------------------------------------------------------------------
# the tests of tests/test_arrivals.py on the port
# ---------------------------------------------------------------------------


@given(st.integers(0, 2 ** 32), st.floats(1.0, 200.0))
@settings(max_examples=10, deadline=None)
def test_poisson_seeded_determinism(seed, rate):
    p1 = PoissonArrivals(rate_rps=rate, seed=seed)
    p2 = PoissonArrivals(rate_rps=rate, seed=seed)
    a1, a2 = p1.sample(2.0), p2.sample(2.0)
    assert a1 == a2
    assert all(a.t < 2.0 for a in a1)
    ts = [a.t for a in a1]
    assert ts == sorted(ts)
    assert len({a.rid for a in a1}) == len(a1)
    r, q = twin(lambda pkg: [dataclasses.astuple(a) for a in
                             pkg.sched.arrivals.PoissonArrivals(
                                 rate_rps=rate, seed=seed).sample(2.0)])
    assert q == r


def test_poisson_different_seeds_differ():
    a = PoissonArrivals(rate_rps=50.0, seed=1).sample(2.0)
    b = PoissonArrivals(rate_rps=50.0, seed=2).sample(2.0)
    assert [x.t for x in a] != [x.t for x in b]


def test_poisson_interarrival_mean():
    rate = 40.0
    arr = PoissonArrivals(rate_rps=rate, seed=7).sample(200.0)
    gaps = [b.t - a.t for a, b in zip(arr, arr[1:])]
    mean = sum(gaps) / len(gaps)
    assert mean == pytest.approx(1.0 / rate, rel=0.1)
    assert offered_load(arr, 200.0) == pytest.approx(rate, rel=0.1)


def test_trace_round_trip_and_sorting():
    raw = (Arrival("b", 0.5, 128, 16), Arrival("a", 0.1, 256, 8))
    tr = TraceArrivals(raw)
    assert [a.rid for a in tr.sample(1.0)] == ["a", "b"]
    assert [a.rid for a in tr.sample(0.3)] == ["a"]
    d = json.loads(json.dumps(arrivals_to_dict(tr)))
    tr2 = arrivals_from_dict(d)
    assert tr2.sample(1.0) == tr.sample(1.0)


def test_poisson_process_round_trip():
    p = PoissonArrivals(rate_rps=25.0, prompt_tokens=64, decode_tokens=4,
                        seed=9)
    d = json.loads(json.dumps(arrivals_to_dict(p)))
    p2 = arrivals_from_dict(d)
    assert p2.sample(3.0) == p.sample(3.0)


def test_demand_series_partitions_arrivals():
    arr = PoissonArrivals(rate_rps=30.0, prompt_tokens=10, decode_tokens=2,
                          seed=3).sample(4.0)
    series = demand_series(arr, 4.0, window_s=0.5)
    assert len(series["t"]) == 8
    assert sum(series["prefill"]) == 10 * len(arr)
    assert sum(series["decode"]) == 2 * len(arr)


def test_validation():
    with pytest.raises(ValueError):
        PoissonArrivals(rate_rps=0.0)
    with pytest.raises(ValueError):
        PoissonArrivals(rate_rps=-1.0)
    same_raises(lambda pkg: pkg.sched.arrivals.PoissonArrivals(
        rate_rps=-1.0), "ValueError")
