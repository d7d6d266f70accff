"""Twin of tests/test_obs.py: the port's observability layer
(``repro_torch.obs.meters``, ``obs.trace``, ``obs.export``) against the
JAX package's.

The trace builders take report dicts (``to_dict()`` JSON), so they are
held by feeding both packages the dicts of the JAX package's own reports
(a codesign plan, a placement search, a cluster plan, a dynamics run and
a serving plan: ``codesign`` is not ported yet) and asking for the same
Chrome trace, ``json.dumps(..., sort_keys=True)``-equal; with the live
topology (each package's own) the per-link counter tracks are equal too.
Meters compare counter for counter, clock-derived observations under an
injected clock.  ``obs.probe`` is not ported yet (it has no twin here)."""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import itertools
import json
import os
import subprocess
import sys

import pytest

from repro_torch.ccl.cost import CostParams, algo_cost
from repro_torch.core.demand import CommDemand, CommTask, ComputeTask
from repro_torch.net.simulate import link_rate_series
from repro_torch.net.topology import ring
from repro_torch.obs import (EXPOSED_CNAME, Meters, Trace, timeline_tracks,
                             trace_from_cluster, trace_from_dynamics,
                             trace_from_report, trace_from_search,
                             trace_from_serving, validate_chrome)
from repro_torch.obs.export import build_trace, detect_kind, export_file
from repro_torch.obs.export import main as export_main
from repro_torch.sched.flows import JobProfile, stagger_jobs
from repro_torch.sched.tasks import simulate_iteration
from torch_twin import PORT, REF, same, twin

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)


def _json(trace) -> str:
    return json.dumps(trace.to_chrome(), sort_keys=True)


@pytest.fixture(scope="module")
def reports():
    """The JAX package's reports as ``to_dict()`` JSON, with the builder
    calls of their topologies (each side builds its own)."""
    from benchmarks.paper_claims import _placement_search_problem
    from repro.codesign import (ClusterDynamics, CodesignProblem, Event,
                                JobSpec, PlanSpace, ServingSLO, ServingSpec,
                                plan, plan_cluster, search, serving_problem)
    from repro.configs import get_config
    from repro.core.demand_builder import DemandParams
    from repro.core.types import SHAPES_BY_NAME, MeshConfig, ModelConfig
    from repro.net.topology import dgx_cluster, fat_tree
    from repro.sched.arrivals import PoissonArrivals

    cfg = get_config("qwen2-0.5b")
    shape = SHAPES_BY_NAME["train_4k"]
    out = {}
    rep = plan(CodesignProblem(
        cfg, shape, MeshConfig(shape=(2, 8), axis_names=("data", "model")),
        dgx_cluster(2), space=PlanSpace().pinned(policy="priority")))
    out["report"] = (json.loads(json.dumps(rep.to_dict())),
                     lambda t: t.dgx_cluster(2))
    res = search(_placement_search_problem(), budget=6)
    out["search"] = (json.loads(json.dumps(res.to_dict())),
                     lambda t: t.fat_tree(num_hosts=4, gpus_per_host=8,
                                          hosts_per_rack=1, oversub=8.0,
                                          pcie_bw=128e9))
    dp2 = MeshConfig(shape=(2,), axis_names=("data",), data_axes=("data",),
                     model_axes=())
    dpp = DemandParams(zero1=False)
    fab = dict(num_hosts=4, gpus_per_host=1, hosts_per_rack=1,
               racks_per_pod=1, agg_redundancy=2, nic_bw=2e9, agg_bw=8e9,
               oversub=4.0, pcie_bw=4e9)
    jobs = [JobSpec("a", cfg, shape, dp2, policy="serial", devices=(0, 2),
                    dp_params=dpp),
            JobSpec("b", cfg, shape, dp2, policy="serial", devices=(1, 3),
                    dp_params=dpp)]
    out["cluster"] = (json.loads(json.dumps(plan_cluster(
        jobs, fat_tree(**fab), grid=4, horizon_iters=6).to_dict())),
        lambda t: t.fat_tree(**fab))
    ticks = itertools.count()
    dyn = ClusterDynamics(jobs, fat_tree(**fab), grid=4, horizon_iters=6,
                          compare_full=True,
                          clock=lambda: float(next(ticks)))
    drep = dyn.run([Event("link_degrade", time=1.0,
                          link=("tor0", "agg0.0"), factor=0.5),
                    Event("straggler", time=2.0, name="a", factor=2.0)])
    out["dynamics"] = (json.loads(json.dumps(drep.to_dict())),
                       lambda t: t.fat_tree(**fab))
    tiny = ModelConfig(name="tiny", family="dense", source="[test]",
                       num_layers=4, d_model=256, num_heads=8,
                       num_kv_heads=4, d_ff=1024, vocab_size=1000)
    spec = ServingSpec(
        name="svc", cfg=tiny, prefill_devices=2, decode_devices=2,
        arrivals=PoissonArrivals(rate_rps=25.0, prompt_tokens=128,
                                 decode_tokens=8, seed=3),
        slo=ServingSLO(ttft_s=1e-5, tpot_s=1e-6), horizon_s=1.0)
    out["serving"] = (json.loads(json.dumps(plan(serving_problem(
        spec, fat_tree(16))).to_dict())), lambda t: t.fat_tree(16))
    return out


BUILDERS = {"report": "trace_from_report", "search": "trace_from_search",
            "cluster": "trace_from_cluster",
            "dynamics": "trace_from_dynamics",
            "serving": "trace_from_serving"}


@pytest.mark.parametrize("kind", sorted(BUILDERS))
@pytest.mark.parametrize("with_topo", [False, True],
                         ids=["bare", "topo"])
def test_trace_builders_equal_reference(reports, kind, with_topo):
    """Each report kind through each package's builder: the same Chrome
    trace document, and a valid one."""
    d, topo = reports[kind]

    def build(pkg):
        t = topo(pkg.net.topology) if with_topo else None
        return _json(getattr(pkg.obs.trace, BUILDERS[kind])(d, topo=t))
    ref, port = twin(build)
    assert port == ref
    assert validate_chrome(json.loads(port)) == []
    if with_topo and kind in ("report", "search"):
        assert '"ph": "C"' in port  # the link counter tracks are there


@pytest.mark.parametrize("max_links", [1, 4, 16])
def test_report_link_counters_equal_reference(reports, max_links):
    d, topo = reports["report"]
    ref, port = twin(lambda pkg: _json(pkg.obs.trace.trace_from_report(
        d, topo=topo(pkg.net.topology), max_links=max_links, t0=0.25,
        pid=3, label="x")))
    assert port == ref


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_export_equals_reference(reports, kind, tmp_path):
    """``detect_kind``, ``build_trace`` and ``export_file`` (the written
    file) of each kind, as the reference's."""
    d, _ = reports[kind]
    src = tmp_path / f"{kind}.json"
    src.write_text(json.dumps(d))
    outs = {}
    for pkg, side in ((REF, "ref"), (PORT, "port")):
        ex = pkg.obs.export
        assert ex.detect_kind(d) == kind
        outs[side] = (_json(ex.build_trace(d)),
                      _json(ex.build_trace(d, kind=kind)))
        path = ex.export_file(str(src), out=str(tmp_path / f"{side}.json"))
        with open(path) as f:
            outs[side] += (json.dumps(json.load(f), sort_keys=True),)
    assert outs["port"] == outs["ref"]


def test_export_cli_subprocess_equals_reference(reports, tmp_path):
    """``python -m repro_torch.obs.export`` as a subprocess writes the
    reference CLI's file."""
    d, _ = reports["report"]
    src = tmp_path / "rep.json"
    src.write_text(json.dumps(d))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    docs = []
    for mod, out in (("repro.obs.export", "ref.trace.json"),
                     ("repro_torch.obs.export", "port.trace.json")):
        proc = subprocess.run(
            [sys.executable, "-m", mod, str(src), "-o",
             str(tmp_path / out)], capture_output=True, text=True, env=env)
        assert proc.returncode == 0, proc.stderr
        docs.append(json.loads((tmp_path / out).read_text()))
    assert json.dumps(docs[1], sort_keys=True) == \
        json.dumps(docs[0], sort_keys=True)
    assert validate_chrome(docs[1]) == []
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.export", str(src)],
        capture_output=True, text=True, env=env)
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "rep.trace.json").exists()


def test_detect_kind_and_export_file(reports, tmp_path):
    d, _ = reports["report"]
    assert detect_kind(d) == "report"
    assert detect_kind({"best": d, "frontier": []}) == "search"
    assert detect_kind({"jobs": [], "staggered_jct": {}}) == "cluster"
    assert detect_kind({"records": [], "final": {}}) == "dynamics"
    with pytest.raises(ValueError):
        detect_kind({"mystery": 1})
    assert build_trace(d).to_json() == trace_from_report(d).to_json()
    src = tmp_path / "rep.json"
    src.write_text(json.dumps(d))
    out = export_file(str(src))
    assert out == str(tmp_path / "rep.trace.json")
    doc = json.loads((tmp_path / "rep.trace.json").read_text())
    assert validate_chrome(doc) == []
    dst = tmp_path / "explicit.trace.json"
    assert export_main([str(src), "-o", str(dst)]) == 0
    assert json.loads(dst.read_text()) == doc


def test_builders_accept_what_reports_hold(reports):
    """Each builder on its own dict, and on the nested dicts the wider
    reports hold (a search's best plan, a dynamics run's final cluster)."""
    search = reports["search"][0]
    dyn = reports["dynamics"][0]
    for doc in (trace_from_report(search["best"]),
                trace_from_cluster(dyn["final"]),
                trace_from_search(search), trace_from_dynamics(dyn),
                trace_from_serving(reports["serving"][0])):
        assert validate_chrome(doc.to_chrome()) == []
    names = {e["name"] for e in
             trace_from_serving(reports["serving"][0]).events()}
    assert any(n.startswith("slo_violation:") for n in names)


# ---------------------------------------------------------------------------
# Meters
# ---------------------------------------------------------------------------


def _meter_ops(pkg):
    ticks = itertools.count()
    m = pkg.obs.meters.Meters(clock=lambda: float(next(ticks)))
    m.incr("a")
    m.incr("a", 2.0)
    m.incr("b")
    m.observe("x", 2.0)
    m.observe("x", 4.0)
    with m.time("work"):
        pass
    other = pkg.obs.meters.Meters()
    other.incr("a", 0.5)
    other.observe("x", -1.0)
    m.merge(other)
    return (m.snapshot(), m.get("a"), m.get("zzz"), m.ratio("a", "b"),
            m.ratio("nope"))


def test_meters_equal_reference():
    same(_meter_ops)


def test_meters_counters_and_observations():
    m = Meters()
    m.incr("a")
    m.incr("a", 2.0)
    m.incr("b")
    assert m.get("a") == 3.0 and m.get("b") == 1.0 and m.get("zzz") == 0.0
    assert m.ratio("a", "b") == 0.75
    assert m.ratio("nope", "also_nope") is None
    m.observe("x", 2.0)
    m.observe("x", 4.0)
    snap = m.snapshot()
    assert snap["x.count"] == 2.0 and snap["x.sum"] == 6.0
    assert snap["x.min"] == 2.0 and snap["x.max"] == 4.0
    assert list(snap) == sorted(snap)


def test_meters_time_uses_injected_clock():
    ticks = itertools.count()
    m = Meters(clock=lambda: float(next(ticks)))
    with m.time("work"):
        pass
    snap = m.snapshot()
    assert snap["work.count"] == 1.0 and snap["work.sum"] == 1.0


def test_meters_merge():
    a, b = Meters(), Meters()
    a.incr("n", 2.0)
    b.incr("n", 3.0)
    b.observe("o", 1.0)
    a.merge(b)
    snap = a.snapshot()
    assert snap["n"] == 5.0 and snap["o.count"] == 1.0


def test_stagger_jobs_counts_evals():
    jobs = [JobProfile("a", 0.012, 0.008), JobProfile("b", 0.010, 0.010)]
    m = Meters()
    stagger_jobs(jobs, grid=5, meters=m)
    assert m.get("flows.stagger.evals") == 6.0


# ---------------------------------------------------------------------------
# Trace recorder + validator
# ---------------------------------------------------------------------------


def _recorder_ops(pkg):
    tr = pkg.obs.trace.Trace()
    tr.process(2, "late", sort_index=5)
    tr.process(1, "early")
    tr.thread(1, 0, "t0")
    tr.span("s", 1e-6, 2e-6, pid=1, tid=0, cat="c", args={"k": 1})
    tr.counter("cnt", 0.0, {"b": 2.0, "a": 1.0}, pid=1, tid=1)
    tr.instant("i", 0.0, pid=2, tid=0, scope="p")
    tr.span("neg", 0.0, -1.0, pid=1, tid=0)
    pkg.obs.trace.timeline_tracks(
        tr, 3, "job", [("comp:c0", 0.0, 1.0), ("comm:g", 0.0, 2.0),
                       ("comp:c1", 2.0, 3.0)],
        task_exposed_s={"g": 1.0}, task_args={"g": {"algorithm": "ring"}},
        t0=0.5)
    return tr.events(), tr.to_json()


def test_recorder_equals_reference():
    same(_recorder_ops)


def test_trace_event_format_and_ordering():
    tr = Trace()
    tr.process(2, "late", sort_index=5)
    tr.process(1, "early")
    tr.thread(1, 0, "t0")
    tr.span("s", 1e-6, 2e-6, pid=1, tid=0, cat="c", args={"k": 1})
    tr.counter("cnt", 0.0, {"b": 2.0, "a": 1.0}, pid=1, tid=1)
    tr.instant("i", 0.0, pid=2, tid=0, scope="p")
    evs = tr.events()
    metas = [e for e in evs if e["ph"] == "M"]
    assert evs[:len(metas)] == metas
    assert [e["name"] for e in metas] == ["process_name", "process_name",
                                         "process_sort_index", "thread_name"]
    span = next(e for e in evs if e["ph"] == "X")
    assert span["ts"] == 1.0 and span["dur"] == 2.0
    assert validate_chrome(tr.to_chrome()) == []
    tr.span("neg", 0.0, -1.0, pid=1, tid=0)
    assert validate_chrome(tr.to_chrome()) == []


BAD_DOCS = [
    {},
    {"traceEvents": [
        {"ph": "Z", "name": "x", "pid": 0, "tid": 0, "ts": 0},
        {"ph": "X", "pid": 0, "tid": 0, "ts": 0, "dur": 1},
        {"ph": "X", "name": "x", "pid": 0, "tid": 0, "ts": "soon", "dur": 1},
        {"ph": "X", "name": "x", "pid": 0, "tid": 0, "ts": 0, "dur": -5},
        {"ph": "i", "name": "x", "pid": 0, "tid": 0, "ts": 0, "s": "q"}]},
    {"traceEvents": [
        {"ph": "X", "name": "a", "pid": 0, "tid": 0, "ts": 0.0, "dur": 10.0},
        {"ph": "X", "name": "b", "pid": 0, "tid": 0, "ts": 5.0, "dur": 10.0}]},
    {"traceEvents": [
        {"ph": "X", "name": "a", "pid": 0, "tid": 0, "ts": 0.0, "dur": 10.0},
        {"ph": "X", "name": "b", "pid": 0, "tid": 1, "ts": 5.0, "dur": 10.0}]},
]


def test_validate_chrome_equals_reference():
    r, p = twin(lambda pkg: [pkg.obs.trace.validate_chrome(d)
                             for d in BAD_DOCS])
    assert p == r


def test_validate_chrome_catches_malformed_docs():
    assert validate_chrome(BAD_DOCS[0]) == \
        ["traceEvents missing or not a list"]
    assert len(validate_chrome(BAD_DOCS[1])) == 5
    assert any("overlaps" in p for p in validate_chrome(BAD_DOCS[2]))
    assert validate_chrome(BAD_DOCS[3]) == []


def test_timeline_tracks_exposed_spans():
    tr = Trace()
    timeline = [("comp:c0", 0.0, 1.0), ("comm:g", 0.0, 2.0),
                ("comp:c1", 2.0, 3.0)]
    timeline_tracks(tr, 1, "job", timeline, task_exposed_s={"g": 1.0})
    evs = tr.events()
    exposed = [e for e in evs if e["ph"] == "X"
               and e["name"] == "exposed:g"]
    assert len(exposed) == 1
    assert exposed[0]["ts"] == 1.0 * 1e6 and exposed[0]["dur"] == 1.0 * 1e6
    assert exposed[0]["cname"] == EXPOSED_CNAME
    comm = next(e for e in evs if e["ph"] == "X" and e["name"] == "g")
    assert comm["args"]["exposed_s"] == 1.0


# ---------------------------------------------------------------------------
# SimResult traces, preemption, link rate series
# ---------------------------------------------------------------------------


def _preempt_demand(pkg):
    d = pkg.core.demand
    dem = d.CommDemand()
    dem.compute_tasks = [d.ComputeTask("c0", 0, 10e-3)] + [
        d.ComputeTask(f"c{i}", 0, 25e-3) for i in range(1, 6)
    ] + [d.ComputeTask("opt", 0, 1e-3)]
    dem.comm_tasks = [
        d.CommTask("grad", "all_reduce", int(100e-3 * 50e9), (0, 1),
                   after_compute=("c0",), before_compute="opt", slack=1.0),
        d.CommTask("a2a", "all_to_all", int(20e-3 * 50e9 * 2), (0, 1),
                   after_compute=("c1",), before_compute="c2", slack=0.0),
    ]
    cp = pkg.ccl.cost.CostParams(alpha=1e-6, link_bw=50e9)

    def cost(t):
        algo = "direct" if t.primitive == "all_to_all" else "ring"
        return pkg.ccl.cost.algo_cost(t.primitive, algo, t.size_bytes,
                                      len(t.group), cp)
    return dem, cost


@pytest.mark.parametrize("policy", ["fifo", "priority", "preempt"])
def test_sim_result_trace_equals_reference(policy):
    def run(pkg):
        dem, cost = _preempt_demand(pkg)
        r = pkg.sched.tasks.simulate_iteration(dem, cost, policy)
        return _json(r.to_trace(label="iter"))
    ref, port = twin(run)
    assert port == ref
    assert validate_chrome(json.loads(port)) == []


def test_preempt_truncates_stale_timeline_spans():
    dem, cost = _preempt_demand(PORT)
    r = simulate_iteration(dem, cost, "preempt")
    comm = sorted((s, e, n) for n, s, e in r.timeline
                  if n.startswith("comm:"))
    assert len(comm) >= 3
    for (s0, e0, n0), (s1, e1, n1) in zip(comm, comm[1:]):
        assert s1 >= e0 - 1e-12, f"{n1} overlaps {n0}"
    assert validate_chrome(r.to_trace().to_chrome()) == []


def test_link_rate_series_integrates_to_bytes():
    topo = ring(4)
    task = CommTask("ar", "all_reduce", 1 << 20, tuple(topo.accelerators))
    from repro_torch.ccl.select import flows_on_topology
    from repro_torch.net.simulate import link_utilization
    fs = flows_on_topology(topo, task, "ring")
    series = link_rate_series(topo, [(fs, 0.0, 2.0), (fs, 3.0, 4.0)])
    assert series
    for points, ts in ((list(v), [t for t, _ in v])
                       for v in series.values()):
        assert ts == sorted(ts)
        assert points[-1][1] == 0.0
        assert all(r >= 0.0 for _, r in points)
    util = link_utilization(topo, fs)
    for link, points in series.items():
        integral = sum(r * (points[i + 1][0] - t)
                       for i, (t, r) in enumerate(points[:-1]))
        assert integral == pytest.approx(2.0 * util[link], rel=1e-9)


def test_cost_terms_sum_to_algo_cost():
    from repro_torch.ccl.cost import cost_terms
    cp = CostParams(alpha=1e-6, link_bw=50e9)
    for algo in ("ring", "bidir_ring", "halving_doubling", "ring+q8"):
        terms = cost_terms("all_reduce", algo, 1 << 24, 8, cp)
        assert terms["total_s"] == pytest.approx(
            algo_cost("all_reduce", algo, 1 << 24, 8, cp))


def test_the_port_imports_no_jax():
    """The port's planning layers, its co-design engine and its probe
    alone, in a fresh interpreter: no jax and no ``repro`` module is
    loaded."""
    code = ("import sys\n"
            "import repro_torch.ccl.select, repro_torch.sched, "
            "repro_torch.obs.export, repro_torch.ccl.synth, "
            "repro_torch.core.demand_builder, repro_torch.net, "
            "repro_torch.codesign, repro_torch.obs.probe\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\nprint('clean')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env)
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr


def test_compute_demand_helpers_trace_on_port():
    dem = CommDemand()
    dem.compute_tasks = [ComputeTask("c", 0, 1e-3)]
    r = simulate_iteration(dem, lambda t: 0.0, "fifo")
    assert validate_chrome(r.to_trace().to_chrome()) == []
