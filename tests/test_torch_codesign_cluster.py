"""Twin tests of the port's co-design engine, horizontal and serving side:
``repro_torch.codesign``'s ``plan_cluster`` and ``plan_serving`` (with
``search`` over the stagger knob) against ``repro.codesign``.

Every case of ``tests/test_cluster.py`` and ``tests/test_serving.py`` that
builds a report is built through both packages under the
``codesign_twin`` fixture (``tests/torch_codesign_cases.py``), and the
reports (``ClusterReport``, ``ServingReport``, ``SearchResult``) must be
``to_dict()`` JSON-equal in key order.  Cluster and serving reports
cross-load both ways; a search over a serving problem does not load back
in either package (``SearchResult.from_dict`` reads a training plan).
"""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import dataclasses
import json
import os
import sys

import pytest

from torch_codesign_cases import (codesign_twin, contended_cluster,  # noqa: F401
                                  cross_load, dp_mesh,
                                  mixed_serving_cluster,
                                  serving_cotenant_problem, train_4k)
from torch_twin import PORT, REF, canon

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _specs(jobs_of):
    """``from_dict``'s job specs by name, in a package."""
    return lambda pkg: {j.name: j for j in jobs_of(pkg)}


def test_scenarios_are_the_references():
    from benchmarks.paper_claims import (_contended_cluster,
                                         _mixed_serving_cluster,
                                         _serving_cotenant_problem)
    assert canon(contended_cluster(REF)) == canon(_contended_cluster())
    assert canon(mixed_serving_cluster(REF)) == \
        canon(_mixed_serving_cluster())
    for cost_model in ("alphabeta", "flowsim"):
        assert canon(serving_cotenant_problem(REF, cost_model)) == \
            canon(_serving_cotenant_problem(cost_model))


# ---------------------------------------------------------------------------
# tests/test_cluster.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid", [6, 4])
def test_contended_cluster(codesign_twin, grid):
    """test_two_jobs_on_hot_link_stagger_strictly_beats_naive (grid 6),
    test_cluster_report_consistency and _is_deterministic (grid 4)."""
    def build(pkg):
        jobs, topo = contended_cluster(pkg)
        return [pkg.codesign.plan_cluster(jobs, topo, grid=grid)
                for _ in range(2)]
    ref, port = codesign_twin.same(build)
    rep = port[0]
    assert rep.contended and rep.stagger_speedup > 1.0
    assert json.dumps(port[1].to_dict()) == json.dumps(rep.to_dict())
    cross_load(ref[0], rep, "ClusterReport", "cluster",
               _specs(lambda pkg: contended_cluster(pkg)[0]))


def test_single_job_staggering_is_noop(codesign_twin):
    def build(pkg):
        jobs, topo = contended_cluster(pkg)
        return pkg.codesign.plan_cluster([jobs[0]], topo)
    _, rep = codesign_twin.same(build)
    assert rep.contended == {} and rep.stagger_speedup == 1.0


def _dgx_jobs(pkg, devices=(None, None)):
    cfg = pkg.configs.get_config("qwen2-0.5b")
    dpp = pkg.core.demand_builder.DemandParams(zero1=False)
    return [pkg.codesign.JobSpec(n, cfg, train_4k(pkg), dp_mesh(pkg, 8),
                                 devices=d, dp_params=dpp)
            for n, d in zip("ab", devices)]


def test_disjoint_jobs_and_first_fit_carving(codesign_twin):
    """test_disjoint_jobs_have_no_contention and
    test_first_fit_carving_assigns_disjoint_blocks."""
    def build(pkg):
        topo = pkg.net.topology.dgx_cluster(2)
        plan = pkg.codesign.plan_cluster
        return [plan(_dgx_jobs(pkg, topo.hosts), topo),
                plan(_dgx_jobs(pkg), topo),
                plan(_dgx_jobs(pkg, (None, tuple(range(8)))), topo)]
    _, (disjoint, carved, around) = codesign_twin.same(build)
    assert disjoint.contended == {}
    assert carved.jobs[1].devices == tuple(range(8, 16))
    assert around.jobs[0].devices == tuple(range(8, 16))


@pytest.mark.parametrize("case", ["empty", "duplicate", "overlap", "small",
                                  "count"])
def test_cluster_validation_errors(codesign_twin, case):
    def build(pkg):
        topo = pkg.net.topology.dgx_cluster(2)
        cfg = pkg.configs.get_config("qwen2-0.5b")
        job = pkg.codesign.JobSpec
        mesh, shape = dp_mesh(pkg, 8), train_4k(pkg)
        dpp = pkg.core.demand_builder.DemandParams(zero1=False)
        jobs = {
            "empty": [],
            "duplicate": [job("x", cfg, shape, mesh, dp_params=dpp),
                          job("x", cfg, shape, mesh, dp_params=dpp)],
            "overlap": [job("a", cfg, shape, mesh, devices=tuple(range(8))),
                        job("b", cfg, shape, mesh,
                            devices=tuple(range(4, 12)))],
            "small": [job(n, cfg, shape, mesh) for n in "abc"],
            "count": [job("a", cfg, shape, mesh, devices=tuple(range(4)))],
        }[case]
        return pkg.codesign.plan_cluster(jobs, topo)
    codesign_twin.raises(build, "ValueError")


# ---------------------------------------------------------------------------
# tests/test_serving.py
# ---------------------------------------------------------------------------


def _tiny(pkg):
    return pkg.core.types.ModelConfig(
        name="tiny", family="dense", source="[test]", num_layers=4,
        d_model=256, num_heads=8, num_kv_heads=4, d_ff=1024,
        vocab_size=1000)


def _spec(pkg, **kw):
    cs = pkg.codesign
    base = dict(name="svc", cfg=_tiny(pkg), prefill_devices=2,
                decode_devices=2,
                arrivals=pkg.sched.arrivals.PoissonArrivals(
                    rate_rps=25.0, prompt_tokens=128, decode_tokens=8,
                    seed=3),
                slo=cs.ServingSLO(ttft_s=0.5, tpot_s=0.05), horizon_s=1.0)
    base.update(kw)
    return cs.ServingSpec(**base)


def _serving_plan(pkg, **kw):
    return pkg.codesign.plan(pkg.codesign.serving_problem(
        _spec(pkg, **kw), pkg.net.topology.fat_tree(16)))


def test_plan_serving_reports(codesign_twin):
    """The report of test_metric_value_wrong_report_kind,
    _constraints_feasibility_both_directions,
    test_plan_serving_deterministic_and_goodput_bounded,
    test_serving_report_json_round_trip and
    test_tpot_percentiles_monotone_in_report; its metric values and the
    objective's verdicts."""
    def build(pkg):
        rep = _serving_plan(pkg)
        obj = pkg.codesign.Objective
        metric_value = pkg.codesign.report.metric_value
        return [rep, _serving_plan(pkg),
                metric_value(rep, "ttft_p99"),
                obj(minimize="ttft_p99",
                    constraints={"ttft_p99": rep.ttft_p99 + 1.0,
                                 "slo_attainment": 0.0}).feasible(rep),
                obj(minimize="ttft_p99", constraints={
                    "ttft_p99": rep.ttft_p99 / 2}).infeasible_reason(rep),
                obj(minimize="ttft_p99", constraints={
                    "goodput": rep.goodput + 1.0}).infeasible_reason(rep),
                pkg.codesign.kv_bytes_per_token(_tiny(pkg))]
    ref, port = codesign_twin.same(build)
    rep = port[0]
    assert rep.goodput <= rep.offered_rps + 1e-9 and rep.requests
    assert len([c for c in rep.prefill.choices
                if c.primitive == "p2p"]) == 2
    cross_load(ref[0], rep, "ServingReport", "serving")
    codesign_twin.raises(lambda pkg: pkg.codesign.report.metric_value(
        _serving_plan(pkg), "wire_bytes_saved"), "ValueError")


def test_serving_trace_valid(codesign_twin):
    """test_serving_trace_valid_and_kind_detected: every request violates
    its SLO; the exported traces are the reference's."""
    def build(pkg):
        rep = _serving_plan(pkg, slo=pkg.codesign.ServingSLO(
            ttft_s=1e-5, tpot_s=1e-6))
        d = rep.to_dict()
        return [rep, rep.slo_violations(),
                pkg.obs.export.detect_kind(d),
                json.dumps(pkg.obs.export.build_trace(d).to_chrome())]
    _, port = codesign_twin.same(build)
    assert port[1] and port[2] == "serving"
    assert PORT.obs.validate_chrome(json.loads(port[3])) == []


@pytest.mark.parametrize("cost_model", ["alphabeta", "flowsim"])
def test_stagger_search_beats_naive_cotenant(codesign_twin, cost_model):
    def build(pkg):
        prob = serving_cotenant_problem(pkg, cost_model)
        sp = dataclasses.replace(prob.space, stagger=pkg.codesign.Search())
        return [pkg.codesign.plan(prob), pkg.codesign.search(
            dataclasses.replace(prob, space=sp), budget=16)]
    ref, (naive, res) = codesign_twin.same(build)
    assert res.best.stagger_s != 0.0
    assert res.best.ttft_p99 < naive.ttft_p99 - 1e-9
    # SearchResult.from_dict reads a training plan: neither package loads
    # a serving search back
    cross_load(ref[0], naive, "ServingReport", "serving")


def test_mixed_cluster_cotenancy(codesign_twin):
    def build(pkg):
        jobs, topo = mixed_serving_cluster(pkg)
        return [pkg.codesign.plan_cluster(jobs, topo, grid=6)
                for _ in range(2)]
    ref, port = codesign_twin.same(build)
    assert port[0].serving["svc"]["staggered_ttft_p99"] > 0.0
    cross_load(ref[0], port[0], "ClusterReport", "cluster",
               _specs(lambda pkg: mixed_serving_cluster(pkg)[0]))


def test_serving_objective_errors(codesign_twin):
    codesign_twin.raises(lambda pkg: pkg.codesign.Objective(
        minimize="ttft_p42"), "ValueError")
    codesign_twin.raises(lambda pkg: pkg.codesign.Objective(
        minimize="jct", constraints={"nope": 1.0}), "ValueError")
    r, p = (pkg.codesign.report.OBJECTIVE_METRICS for pkg in (REF, PORT))
    assert list(p.items()) == list(r.items())
