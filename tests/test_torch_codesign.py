"""Twin tests of the port's co-design engine, training side:
``repro_torch.codesign`` (``plan_iteration``, ``plan``, ``search``,
placement and placement search, seeds) against ``repro.codesign``.

Every case of ``tests/test_codesign.py`` and ``tests/test_codesign_api.py``
that builds a report is built here through both packages by one function
of a package root, under the ``codesign_twin`` fixture (the port's peak
pinned to the reference's, fresh synthesis caches, one fake clock), and
the reports must be ``to_dict()`` JSON-equal in key order; reports cross-
load both ways.  A separate case keeps the H100's peak and holds the
compute-only quantities to the reference's scaled by the ratio of peaks.
"""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import dataclasses
import json
import os
import sys

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from torch_codesign_cases import (codesign_twin, cross_load, dp2_tp8,  # noqa: F401
                                  dp_mesh, pinned_twin,
                                  placement_search_problem, train_4k)
from torch_twin import PORT, REF, canon

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _cfg(pkg, arch="qwen2-0.5b"):
    return pkg.configs.get_config(arch)


def _dgx(pkg, hosts=2):
    return pkg.net.topology.dgx_cluster(hosts)


def _fat8(pkg):
    return pkg.net.topology.fat_tree(num_hosts=8, gpus_per_host=1,
                                     oversub=4.0)


def _dpp(pkg, **kw):
    return pkg.core.demand_builder.DemandParams(**kw)


def test_scenarios_are_the_references():
    """The scenario copied from ``benchmarks/paper_claims.py`` is the
    reference's own, field for field."""
    from benchmarks.paper_claims import _placement_search_problem
    assert canon(placement_search_problem(REF)) == \
        canon(_placement_search_problem())


# ---------------------------------------------------------------------------
# tests/test_codesign.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-3-8b", "dbrx-132b", "mamba2-130m"])
@pytest.mark.parametrize("topo", ["dgx_cluster", "fat_tree"])
def test_plan_iteration_end_to_end(codesign_twin, arch, topo):
    ref, port = codesign_twin.same(lambda pkg: pkg.codesign.plan_iteration(
        _cfg(pkg, arch), train_4k(pkg), dp2_tp8(pkg),
        getattr(pkg.net.topology, topo)(2), policy="priority",
        hotspot_k=64))
    assert port.jct >= port.compute_time - 1e-9 and port.link_hotspots
    cross_load(ref, port, "CodesignReport", "report")


def test_hierarchical_wins_for_large_gradient_all_reduce_on_dgx(
        codesign_twin):
    _, (auto, ring) = codesign_twin.same(lambda pkg: [
        pkg.codesign.plan_iteration(
            _cfg(pkg, "granite-3-8b"), train_4k(pkg), dp_mesh(pkg, 16),
            _dgx(pkg), policy="serial", dp_params=_dpp(pkg, zero1=False),
            **kw)
        for kw in ({}, {"force": {"all_reduce": "ring"}})])
    assert auto.jct < ring.jct


def test_alphabeta_rejects_hierarchical_on_uneven_host_partition(
        codesign_twin):
    _, port = codesign_twin.same(lambda pkg: pkg.codesign.plan_iteration(
        _cfg(pkg), train_4k(pkg), dp_mesh(pkg, 16), _dgx(pkg, 3),
        placement="strided", cost_model="alphabeta",
        dp_params=_dpp(pkg, zero1=False)))
    assert "hierarchical" not in port.algorithms_by_primitive()["all_reduce"]


def test_plan_iteration_selection_is_the_references(codesign_twin):
    """test_plan_iteration_selection_stays_fast's 40-layer plan."""
    codesign_twin.same(lambda pkg: pkg.codesign.plan_iteration(
        _cfg(pkg, "granite-3-8b"), train_4k(pkg), dp_mesh(pkg, 16),
        _dgx(pkg), policy="priority", dp_params=_dpp(pkg, zero1=False)))


def test_placement_and_plan_iteration_are_deterministic(codesign_twin):
    codesign_twin.same(lambda pkg: [
        pkg.codesign.place_mesh(dp2_tp8(pkg), _dgx(pkg), s).devices
        for s in ("packed", "strided")] + [
        pkg.codesign.plan_iteration(_cfg(pkg), train_4k(pkg), dp2_tp8(pkg),
                                    _dgx(pkg), policy="priority")
        for _ in range(2)])


def test_placement_views_equal_reference(codesign_twin):
    """Placement: packed / strided groups and the placed demand."""
    def build(pkg):
        topo, mesh = _dgx(pkg), dp2_tp8(pkg)
        pl = pkg.codesign.place_mesh(mesh, topo, "packed")
        dem = pkg.core.demand_builder.build_demand(
            _cfg(pkg, "granite-3-8b"), train_4k(pkg), mesh)
        strided = pkg.codesign.place_mesh(mesh, topo, "strided")
        torus = pkg.codesign.place_mesh(
            mesh, pkg.net.topology.torus2d(4, 4), "strided")
        return [pl, pl.model_groups(), pl.data_groups(),
                pl.place_demand(dem), strided, strided.model_groups(),
                torus]
    codesign_twin.same(build)


def test_flowsim_second_plan_hits_cache(codesign_twin):
    def build(pkg):
        topo = _dgx(pkg)
        fsim = pkg.ccl.select.FlowSim(topo)
        reps = [pkg.codesign.plan_iteration(
            _cfg(pkg), train_4k(pkg), dp_mesh(pkg, 16), topo,
            cost_model=fsim, dp_params=_dpp(pkg, zero1=False))
            for _ in range(2)]
        return reps + [len(fsim._cost_memo), fsim.cache_stats()]
    codesign_twin.same(build)


def test_atp_selected_end_to_end_for_chunked_gradients(codesign_twin):
    _, (rep, capped) = codesign_twin.same(lambda pkg: [
        pkg.codesign.plan_iteration(
            _cfg(pkg), train_4k(pkg), dp_mesh(pkg, 8), _fat8(pkg),
            dp_params=_dpp(pkg, zero1=False, grad_chunks=16), **kw)
        for kw in ({}, {"switch_capacity": 4})])
    assert "atp" in rep.algorithms_by_primitive()["all_reduce"]
    assert "atp" not in capped.algorithms_by_primitive()["all_reduce"]


def test_switch_capacity_rejected_for_unconfigured_instance_model(
        codesign_twin):
    def common(pkg):
        return (_cfg(pkg), train_4k(pkg), dp_mesh(pkg, 8), _fat8(pkg))

    def dpp(pkg):
        return _dpp(pkg, zero1=False, grad_chunks=16)

    codesign_twin.raises(lambda pkg: pkg.codesign.plan_iteration(
        *common(pkg), dp_params=dpp(pkg),
        cost_model=pkg.ccl.select.FlowSim(common(pkg)[3]),
        switch_capacity=4), "ValueError")

    def build(pkg):
        cfg, shape, mesh, topo = common(pkg)
        select = pkg.ccl.select
        ab = select.AlphaBeta.from_topology(topo)
        ab4 = dataclasses.replace(
            ab, params=dataclasses.replace(ab.params, atp_capacity=4))
        return [pkg.codesign.plan_iteration(
            cfg, shape, mesh, topo, dp_params=dpp(pkg), cost_model=model,
            switch_capacity=4)
            for model in (select.FlowSim(topo, switch_capacity=4),
                          "flowsim", ab4)]
    codesign_twin.same(build)


def test_packed_beats_strided_placement_for_tp(codesign_twin):
    _, (packed, strided) = codesign_twin.same(lambda pkg: [
        pkg.codesign.plan_iteration(
            _cfg(pkg, "granite-3-8b"), train_4k(pkg), dp2_tp8(pkg),
            _dgx(pkg), policy="serial", placement=p)
        for p in ("packed", "strided")])
    assert packed.comm_time < strided.comm_time


# ---------------------------------------------------------------------------
# tests/test_codesign_api.py
# ---------------------------------------------------------------------------


def _problem(pkg, mesh=None, **kw):
    return pkg.codesign.CodesignProblem(
        _cfg(pkg), train_4k(pkg), mesh or dp2_tp8(pkg), _dgx(pkg), **kw)


def test_plan_requires_every_scalar_knob_fixed(codesign_twin):
    codesign_twin.raises(lambda pkg: pkg.codesign.plan(_problem(
        pkg, space=pkg.codesign.PlanSpace(
            policy=pkg.codesign.Choice("serial", "priority")))),
        "ValueError")


def test_objective_validation_and_key(codesign_twin):
    def build(pkg):
        rep = pkg.codesign.plan(_problem(pkg))
        obj = pkg.codesign.Objective
        saver = obj(minimize="jct", tie_break=("wire_bytes_saved",))
        return [rep, obj().key(rep), obj().feasible(rep),
                obj(max_worst_link_bytes=1.0).feasible(rep), saver.key(rep)]
    codesign_twin.same(build)
    codesign_twin.raises(
        lambda pkg: pkg.codesign.Objective(minimize="latency"), "ValueError")


def _adapter_kwargs(pkg, policy, placement, cost_model, error_budget,
                    force_ring, zero1):
    return dict(policy=policy, placement=placement, cost_model=cost_model,
                dp_params=_dpp(pkg, zero1=zero1),
                force={"all_reduce": "ring"} if force_ring else None,
                error_budget=error_budget)


@settings(max_examples=10, deadline=None)
@given(policy=st.sampled_from(["serial", "priority"]),
       placement=st.sampled_from(["packed", "strided"]),
       cost_model=st.sampled_from(["flowsim", "alphabeta"]),
       error_budget=st.sampled_from([0.0, 0.01]),
       force_ring=st.booleans(),
       zero1=st.booleans())
def test_plan_iteration_is_an_exact_adapter(policy, placement, cost_model,
                                            error_budget, force_ring, zero1):
    """The port's copy of the reference's property test (its deadline
    lifted: the reference's 200 ms flakes on a loaded runner): the legacy
    entry point and the declarative problem give the same report, and
    both the reference's."""
    def build(pkg):
        kw = _adapter_kwargs(pkg, policy, placement, cost_model,
                             error_budget, force_ring, zero1)
        args = (_cfg(pkg), train_4k(pkg), dp2_tp8(pkg), _dgx(pkg))
        return [pkg.codesign.plan_iteration(*args, **kw),
                pkg.codesign.plan(pkg.codesign.CodesignProblem.from_kwargs(
                    *args, **kw))]
    with pytest.MonkeyPatch.context() as mp:
        ref, port = pinned_twin(mp).build(build)
    dicts = [json.dumps(r.to_dict()) for r in ref + port]
    assert len(set(dicts)) == 1


def test_from_kwargs_allow_maps_to_wildcard_knob(codesign_twin):
    def build(pkg):
        out = []
        for allow in (("ring", "tree"), ("ring",)):
            args = (_cfg(pkg), train_4k(pkg), dp_mesh(pkg, 16), _dgx(pkg))
            kw = dict(allow=allow, dp_params=_dpp(pkg, zero1=False))
            prob = pkg.codesign.CodesignProblem.from_kwargs(*args, **kw)
            out += [pkg.codesign.plan_iteration(*args, **kw),
                    prob.space.algorithm["*"], pkg.codesign.plan(prob)]
        return out
    codesign_twin.same(build)


def test_empty_allow_and_mutable_default(codesign_twin):
    """test_empty_allow_still_means_full_registry and
    test_plan_iteration_mutable_default_fixed."""
    def build(pkg):
        args = (_cfg(pkg), train_4k(pkg), dp2_tp8(pkg), _dgx(pkg))
        pi = pkg.codesign.plan_iteration
        return [pi(*args, allow=()), pi(*args),
                pi(*args, dp_params=_dpp(pkg)),
                "*" in pkg.codesign.CodesignProblem.from_kwargs(
                    *args, allow=()).space.algorithm]
    ref, port = codesign_twin.same(build)
    assert json.dumps(port[0].to_dict()) == json.dumps(port[1].to_dict())


def test_placement_generators_equal_reference(codesign_twin):
    """balanced_placement (model-inner and model-outer meshes, uneven
    hosts), heuristic_placements, axis_permuted_placement and the swap
    neighbourhood, in their order."""
    def build(pkg):
        ps = pkg.codesign.placement_search
        problem = placement_search_problem(pkg)
        base = pkg.net.topology.fat_tree(num_hosts=2, gpus_per_host=8)
        uneven = dataclasses.replace(
            base, accelerators=base.accelerators[:12],
            hosts=(base.hosts[0], base.hosts[1][:4]))
        types = pkg.core.types
        pl = pkg.codesign.Placement(mesh=dp2_tp8(pkg),
                                    devices=tuple(range(16)),
                                    strategy="packed",
                                    topology=_dgx(pkg).name)
        return [
            ps.balanced_placement(problem.mesh, problem.topo),
            ps.balanced_placement(types.MeshConfig(
                shape=(12, 2), axis_names=("model", "data")), problem.topo),
            ps.balanced_placement(types.MeshConfig(
                shape=(1, 12), axis_names=("data", "model")), uneven),
            ps.balanced_placement(dp_mesh(pkg, 16), _dgx(pkg)),
            ps.heuristic_placements(problem.mesh, problem.topo),
            ps.axis_permuted_placement(dp2_tp8(pkg), _dgx(pkg), (1, 0)),
            [p for _, p in zip(range(20), ps.swap_neighbors(pl, _dgx(pkg)))]]
    codesign_twin.same(build)


def test_search_placement_beats_packed(codesign_twin):
    """test_search_placement_beats_packed_on_oversubscribed_fat_tree."""
    ref, port = codesign_twin.same(lambda pkg: [
        pkg.codesign.search(placement_search_problem(pkg), budget=12),
        pkg.codesign.plan(placement_search_problem(pkg).pinned(
            placement="packed"))])
    res, packed = port
    assert res.best.jct < packed.jct - 1e-9
    assert res.best.placement.strategy == "balanced"
    assert res.telemetry["counters"]
    cross_load(ref[0], res, "SearchResult", "api")


def test_search_is_deterministic(codesign_twin):
    _, (r1, r2) = codesign_twin.same(lambda pkg: [
        pkg.codesign.search(placement_search_problem(pkg), budget=10)
        for _ in range(2)])
    assert json.dumps(r1.to_dict()) == json.dumps(r2.to_dict())


def test_search_budget_caps_evaluations(codesign_twin):
    def build(pkg):
        problem = placement_search_problem(pkg)
        n = len(pkg.codesign.heuristic_placements(problem.mesh,
                                                  problem.topo))
        one = pkg.codesign.search(problem, budget=1)
        exact = pkg.codesign.search(problem, budget=n)
        return [one, exact, n, exact.frontier[0].report is exact.best]
    codesign_twin.same(build)
    codesign_twin.raises(lambda pkg: pkg.codesign.search(
        placement_search_problem(pkg), budget=0), "ValueError")


def test_search_enumerates_choice_knobs_with_attribution(codesign_twin):
    def build(pkg):
        cs = pkg.codesign
        problem = _problem(pkg, space=cs.PlanSpace(
            placement=cs.Choice("strided", "packed"),
            policy=cs.Choice("serial", "priority")))
        res = cs.search(problem, budget=8)
        reverted = cs.plan(problem.pinned(
            placement="strided", policy=res.best_assignment["policy"]))
        return [res, reverted]
    codesign_twin.same(build)


def test_search_without_free_knobs_prices_single_point(codesign_twin):
    codesign_twin.same(lambda pkg: [
        pkg.codesign.search(_problem(pkg), budget=4),
        pkg.codesign.plan(_problem(pkg))])


def test_search_rejects_infeasible_and_open_knobs(codesign_twin):
    """test_search_infeasible_objective_raises and
    test_search_rejects_open_non_placement_knobs: the same errors."""
    codesign_twin.raises(lambda pkg: pkg.codesign.search(_problem(
        pkg, space=pkg.codesign.PlanSpace(
            placement=pkg.codesign.Choice("packed", "strided")),
        objective=pkg.codesign.Objective(max_worst_link_bytes=1.0)),
        budget=4), "ValueError")
    codesign_twin.raises(lambda pkg: pkg.codesign.search(_problem(
        pkg, space=pkg.codesign.PlanSpace(policy=pkg.codesign.Search())),
        budget=4), "ValueError")


def test_codesign_report_round_trips_and_cross_loads(codesign_twin):
    ref, port = codesign_twin.same(lambda pkg: pkg.codesign.plan_iteration(
        _cfg(pkg), train_4k(pkg), dp2_tp8(pkg), _dgx(pkg),
        error_budget={"all_reduce": 0.01}))
    assert port.codecs_by_primitive()
    cross_load(ref, port, "CodesignReport", "report")


def test_search_result_round_trips_and_cross_loads(codesign_twin):
    ref, port = codesign_twin.same(lambda pkg: pkg.codesign.search(
        placement_search_problem(pkg), budget=6))
    cross_load(ref, port, "SearchResult", "api")


def test_seed_saved_by_the_reference_loads_in_the_port(codesign_twin,
                                                       tmp_path):
    """A search winner persisted by ``repro.codesign.seeds`` is found
    under the same key by the port and loads as the same assignment; the
    port's warm-started search is the reference's."""
    ref_seeds = pytest.importorskip("repro.codesign.seeds")
    port_seeds = PORT.codesign.seeds
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    res = codesign_twin.same(lambda pkg: pkg.codesign.search(
        placement_search_problem(pkg), budget=6,
        seeds_dir=str(ref_dir if pkg is REF else port_dir)))
    for name in sorted(os.listdir(ref_dir)):
        with open(ref_dir / name) as f, open(port_dir / name) as g:
            assert f.read() == g.read()
    ref_problem = placement_search_problem(REF)
    port_problem = placement_search_problem(PORT)
    assert port_seeds.seed_key(port_problem) == \
        ref_seeds.seed_key(ref_problem)
    assert port_seeds.seed_path(str(ref_dir), port_problem) == \
        ref_seeds.seed_path(str(ref_dir), ref_problem)
    loaded = port_seeds.load_seed(str(ref_dir), port_problem)
    want = ref_seeds.load_seed(str(ref_dir), ref_problem)
    assert loaded is not None and canon(loaded) == canon(want)
    assert canon(loaded["placement"].devices) == \
        canon(res[0].best_assignment["placement"].devices)
    codesign_twin.same(lambda pkg: pkg.codesign.search(
        placement_search_problem(pkg), budget=6, seeds_dir=str(ref_dir)))


def test_jobspec_problem_equivalent_to_flat_fields(codesign_twin):
    def build(pkg):
        cs = pkg.codesign
        topo = pkg.net.topology.fat_tree(
            num_hosts=4, gpus_per_host=2, hosts_per_rack=2, nic_bw=2e9,
            agg_bw=8e9, oversub=4.0, pcie_bw=4e9)
        mesh, dpp = dp_mesh(pkg, 4), _dpp(pkg, zero1=False)
        devs = (topo.hosts[0] + topo.hosts[2], topo.hosts[1] + topo.hosts[3])
        flat = [cs.JobSpec(n, _cfg(pkg), train_4k(pkg), mesh, devices=d,
                           dp_params=dpp) for n, d in zip("AB", devs)]
        carried = [cs.JobSpec(n, devices=d, problem=cs.CodesignProblem(
            _cfg(pkg), train_4k(pkg), mesh, topo, dp_params=dpp))
            for n, d in zip("AB", devs)]
        return [cs.plan_cluster(flat, topo, grid=4),
                cs.plan_cluster(carried, topo, grid=4)]
    codesign_twin.same(build)


def test_h100_peak_scales_compute_only(monkeypatch):
    """With the port's own peak (the H100's), a plan's compute time is the
    reference's scaled by the ratio of peaks; the priced collectives do
    not depend on the peak."""
    import repro.core.hw as ref_hw
    import repro_torch.core.hw as port_hw
    ratio = ref_hw.PEAK_FLOPS_BF16 / port_hw.PEAK_FLOPS_BF16
    assert ratio != 1.0

    def build(pkg):
        return pkg.codesign.plan_iteration(
            _cfg(pkg), train_4k(pkg), dp_mesh(pkg, 16), _dgx(pkg),
            policy="serial", dp_params=_dpp(pkg, zero1=False))
    ref, port = build(REF), build(PORT)
    assert port.compute_time == pytest.approx(ref.compute_time * ratio,
                                              rel=1e-12)
    assert [(c.task_id, c.algorithm, c.cost_s) for c in port.choices] == \
        [(c.task_id, c.algorithm, c.cost_s) for c in ref.choices]
    assert port.comm_time == pytest.approx(ref.comm_time, rel=1e-12)
