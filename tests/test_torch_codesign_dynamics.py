"""Twin tests of the port's co-design engine under events:
``repro_torch.codesign.ClusterDynamics`` against ``repro.codesign``'s.

Every case of ``tests/test_dynamics.py`` that builds a report runs through
both packages under the ``codesign_twin`` fixture
(``tests/torch_codesign_cases.py``); both engines time their re-plans by
the same fake clock, so the ``DynamicsReport``s (re-plan and full-search
seconds included) and the standing ``ClusterReport``s must be
``to_dict()`` JSON-equal in key order, and cross-load both ways.
"""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import json
import os
import sys

import pytest

from torch_codesign_cases import (codesign_twin, cross_load,  # noqa: F401
                                  dp_mesh, dynamic_cluster, train_4k)
from torch_twin import REF, canon

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _job(pkg, name, devices):
    return pkg.codesign.JobSpec(
        name, pkg.configs.get_config("qwen2-0.5b"), train_4k(pkg),
        dp_mesh(pkg, 2), policy="serial", devices=devices,
        dp_params=pkg.core.demand_builder.DemandParams(zero1=False))


def _small_cluster(pkg):
    """Four single-GPU hosts, one a pod, a redundant agg tier."""
    topo = pkg.net.topology.fat_tree(
        num_hosts=4, gpus_per_host=1, hosts_per_rack=1, racks_per_pod=1,
        agg_redundancy=2, nic_bw=2e9, agg_bw=8e9, oversub=4.0, pcie_bw=4e9)
    return [_job(pkg, "a", (0, 2)), _job(pkg, "b", (1, 3))], topo


def _two_gpu_hosts(pkg):
    return pkg.net.topology.fat_tree(
        num_hosts=4, gpus_per_host=2, hosts_per_rack=1, racks_per_pod=1,
        agg_redundancy=2, nic_bw=2e9, agg_bw=8e9, oversub=4.0, pcie_bw=4e9)


def _specs(jobs):
    return {s.name: s for s in jobs}


def _engine(tw, pkg, jobs, topo, **kw):
    return pkg.codesign.ClusterDynamics(jobs, topo, grid=4,
                                        clock=tw.clock(), **kw)


def _run(tw, events_of, jobs_of=_small_cluster, **kw):
    """A build: the engine over ``events_of(pkg)`` applied one by one;
    the standing report before and the records and report after each."""
    def build(pkg):
        jobs, topo = jobs_of(pkg)
        dyn = _engine(tw, pkg, jobs, topo, **kw)
        out = [dyn.report]
        for ev in events_of(pkg):
            out += [dyn.apply(ev), dyn.report, sorted(dyn.specs)]
        return out
    return tw.same(build)


def test_cluster_report_json_round_trip(codesign_twin):
    def build(pkg):
        jobs, topo = _small_cluster(pkg)
        return _engine(codesign_twin, pkg, jobs, topo).report
    ref, port = codesign_twin.same(build)
    cross_load(ref, port, "ClusterReport", "cluster",
               lambda pkg: _specs(_small_cluster(pkg)[0]))


def test_dynamics_rejects_duplicate_and_unknown_jobs(codesign_twin):
    def twice(pkg):
        jobs, topo = _small_cluster(pkg)
        return _engine(codesign_twin, pkg, [jobs[0], jobs[0]], topo)
    codesign_twin.raises(twice, "ValueError")
    for make in (lambda pkg, jobs: pkg.codesign.Event(
                     "job_arrive", job=jobs[0]),
                 lambda pkg, jobs: pkg.codesign.Event(
                     "job_depart", name="ghost"),
                 lambda pkg, jobs: pkg.codesign.Event(
                     "straggler", name="ghost", factor=2.0)):
        def apply(pkg, make=make):
            jobs, topo = _small_cluster(pkg)
            return _engine(codesign_twin, pkg, jobs, topo).apply(
                make(pkg, jobs))
        codesign_twin.raises(apply, "ValueError")


def test_straggler_is_incremental_and_local(codesign_twin):
    _, port = _run(codesign_twin, lambda pkg: [
        pkg.codesign.Event("straggler", name="a", factor=1.5)] * 2)
    assert port[1].mode == "incremental" and port[1].dirty_jobs == ["a"]


def test_arrival_and_departure(codesign_twin):
    _, port = _run(codesign_twin, lambda pkg: [
        pkg.codesign.Event("job_arrive", job=_job(pkg, "c", (1, 5))),
        pkg.codesign.Event("job_depart", name="c")],
        jobs_of=lambda pkg: ([_job(pkg, "a", (0, 4))], _two_gpu_hosts(pkg)))
    assert set(port[1].dirty_jobs) == {"a", "c"}
    assert port[4].dirty_jobs == ["a"]


def test_link_fail_and_degrade(codesign_twin):
    """test_link_fail_reroutes_on_redundant_tree and
    test_link_degrade_compounds."""
    _, port = _run(codesign_twin, lambda pkg: [
        pkg.codesign.Event("link_fail", link=("tor0", "agg0.0"))])
    assert port[1].dirty_jobs == ["a"]

    def degrade(pkg):
        jobs, topo = _small_cluster(pkg)
        dyn = _engine(codesign_twin, pkg, jobs, topo)
        recs = [dyn.apply(pkg.codesign.Event(
            "link_degrade", link=("tor0", "agg0.0"), factor=0.5))
            for _ in range(2)]
        return recs + [dyn.report, dict(dyn.bw_scale),
                       dyn._view().graph["tor0"]["agg0.0"]["bw"]]
    _, port = codesign_twin.same(degrade)
    assert port[3][("tor0", "agg0.0")] == pytest.approx(0.25)


def test_host_fail_recarves_and_bills_restore(codesign_twin):
    """test_host_fail_recarves_onto_survivors and
    test_host_fail_bills_restore_time."""
    _, port = _run(codesign_twin, lambda pkg: [
        pkg.codesign.Event("host_fail", host=2),
        pkg.codesign.Event("straggler", name="b", factor=1.5)],
        jobs_of=lambda pkg: ([_job(pkg, "a", (0, 4)), _job(pkg, "b", (2, 6))],
                             _two_gpu_hosts(pkg)))
    assert "a" in port[1].dirty_jobs and port[1].restore_s > 0.0
    assert port[4].restore_s == 0.0


def test_host_fail_evicts_and_bills(codesign_twin):
    """test_host_fail_evicts_lifo_when_cluster_too_small and
    test_eviction_bills_restore_and_report_totals."""
    def build(pkg):
        jobs, topo = _small_cluster(pkg)
        dyn = _engine(codesign_twin, pkg, jobs, topo)
        rec = dyn.apply(pkg.codesign.Event("host_fail", host=3))
        return [rec, dyn.run([])]
    ref, (rec, rep) = codesign_twin.same(build)
    assert rec.mode == "full" and rec.evicted == ["b"]
    cross_load(ref[1], rep, "DynamicsReport", "dynamics",
               lambda pkg: _specs(_small_cluster(pkg)[0]))


def test_warm_start_from_persisted_report(codesign_twin):
    """The reference's persisted standing plan warm-starts the port's
    engine, and the two evolve alike."""
    def build(pkg):
        jobs, topo = _small_cluster(pkg)
        fresh = _engine(codesign_twin, pkg, jobs, topo)
        wire = json.loads(json.dumps(fresh.report.to_dict()))
        return [fresh.report, wire]
    (ref_rep, ref_wire), _ = codesign_twin.same(build)

    def warmed(pkg):
        jobs, topo = _small_cluster(pkg)
        dyn = _engine(codesign_twin, pkg, jobs, topo, warm_start=ref_wire)
        return [dyn.report, dyn.apply(pkg.codesign.Event(
            "straggler", name="b", factor=1.4))]
    _, port = codesign_twin.same(warmed)
    assert json.dumps(port[0].to_dict()) == json.dumps(ref_rep.to_dict())


@pytest.mark.parametrize("case", ["regret", "round_trip", "order"])
def test_runs_with_events(codesign_twin, case):
    """test_compare_full_bounds_regret, test_dynamics_report_json_round_trip
    (both with ``compare_full``: the fake clock's seconds in the report)
    and test_events_applied_in_time_order."""
    def events(pkg):
        Ev = pkg.codesign.Event
        return {
            "regret": [Ev("straggler", time=1.0, name="a", factor=1.3),
                       Ev("link_degrade", time=2.0,
                          link=("tor0", "agg0.0"), factor=0.5)],
            "round_trip": [Ev("link_fail", time=1.0,
                              link=("tor2", "agg2.1")),
                           Ev("straggler", time=2.0, name="b", factor=2.0)],
            "order": [Ev("straggler", time=5.0, name="a", factor=1.2),
                      Ev("job_depart", time=1.0, name="b")],
        }[case]

    def build(pkg):
        jobs, topo = _small_cluster(pkg)
        dyn = _engine(codesign_twin, pkg, jobs, topo,
                      compare_full=case != "order")
        return dyn.run(events(pkg))
    ref, port = codesign_twin.same(build)
    if case != "order":
        assert port.worst_regret is not None and port.mean_replan_s > 0
    cross_load(ref, port, "DynamicsReport", "dynamics",
               lambda pkg: _specs(_small_cluster(pkg)[0]))


def test_bench_trace_stays_incremental(codesign_twin):
    """The benchmark's 8-event trace (``paper_claims._dynamic_cluster``)."""
    from benchmarks.paper_claims import _dynamic_cluster
    assert canon(dynamic_cluster(REF)) == canon(_dynamic_cluster())

    def build(pkg):
        jobs, topo, events = dynamic_cluster(pkg)
        return pkg.codesign.ClusterDynamics(
            jobs, topo, grid=4, clock=codesign_twin.clock()).run(events)

    def specs(pkg):
        jobs, _, events = dynamic_cluster(pkg)
        return _specs(jobs + [e.job for e in events if e.job is not None])
    ref, port = codesign_twin.same(build)
    assert len(port.records) == 8
    assert all(r.mode == "incremental" for r in port.records)
    cross_load(ref, port, "DynamicsReport", "dynamics", specs)


def test_checkpoint_state_bytes_equal_reference():
    from repro.checkpoint import checkpoint_state_bytes as ref_bytes
    from repro_torch.checkpoint.io import checkpoint_state_bytes
    from repro_torch.configs import get_config
    cfg = get_config("qwen2-0.5b")
    ref_cfg = REF.configs.get_config("qwen2-0.5b")
    for kw in ({}, {"param_bytes": 2, "moments": 0}):
        assert checkpoint_state_bytes(cfg, **kw) == ref_bytes(ref_cfg, **kw)
