"""Twin of the model half of tests/test_ccl.py: the port's flow
generators (``repro_torch.ccl.algorithms``), alpha-beta cost models
(``ccl.cost``) and NCCL-style selection (``ccl.select``) against the JAX
package's on the same calls, exactly: every flow of every registered and
composed algorithm, every closed form and cost term, every selection
under ``AlphaBeta`` and ``FlowSim`` (costs, exclusions, cache counters),
with error budgets and ``Fixed`` / ``Choice`` / ``Search`` knobs.  Each
model test of tests/test_ccl.py also runs on the port."""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import math

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.ccl.algorithms import ALGORITHMS, generate_flows
from repro_torch.ccl.cost import CostParams, algo_cost
from repro_torch.ccl.select import select_algorithm
from repro_torch.core.demand import CommTask
from repro_torch.net.simulate import simulate_flowset
from repro_torch.net.topology import full_mesh, ring, torus2d
from torch_twin import same, same_raises, twin


def _task(prim, size, p):
    return CommTask("t", prim, size, tuple(range(p)))


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

NAMES = [(prim, algo) for prim, algos in ALGORITHMS.items() for algo in algos]
# composed "<base>+<codec>" names beyond the canonical registry
NAMES += [("all_reduce", a) for a in ("tree+q4", "halving_doubling+topk",
                                      "bidir_ring+lowrank", "torus2d+q8")]


def test_registries_equal_reference():
    r, p = twin(lambda pkg: (
        {prim: list(algos) for prim, algos in
         pkg.ccl.algorithms.ALGORITHMS.items()},
        pkg.ccl.algorithms.COMPRESSED_CANDIDATES))
    assert p == r


@pytest.mark.parametrize("prim,algo", NAMES, ids=lambda v: str(v))
def test_generate_flows_equal_reference(prim, algo):
    """Every flow (endpoints, bytes, step, job) in the reference's order,
    for group sizes that meet and miss each algorithm's structural guards
    (a miss raises the same error on both sides)."""
    for p in (2, 3, 4, 8, 9, 16):
        for size in (1, 1000, 3 << 20):
            def flows(pkg):
                task = pkg.core.demand.CommTask(
                    "t", prim, size, tuple(range(p)), job_id="j")
                kwargs = {}
                if algo.split("+")[0] == "hierarchical":
                    if p % 2:
                        return None
                    kwargs["hosts"] = (tuple(range(p // 2)),
                                       tuple(range(p // 2, p)))
                try:
                    return pkg.ccl.algorithms.generate_flows(task, algo,
                                                             **kwargs)
                except Exception as e:  # noqa: BLE001 - compared below
                    return ("raised", type(e).__name__, str(e))
            same(flows)


def test_generate_flows_unknown_algorithm_raises_as_reference():
    same_raises(lambda pkg: pkg.ccl.algorithms.generate_flows(
        pkg.core.demand.CommTask("t", "all_gather", 64, (0, 1)), "tree"),
        "KeyError")


PARAMS = {
    "default": {},
    "fast": {"alpha": 1e-6, "link_bw": 50e9},
    "hier": {"alpha": 2e-6, "link_bw": 150e9, "inter_bw": 25e9,
             "gpus_per_host": 4},
    "atp": {"inter_bw": 25e9, "atp_capacity": 4, "reduce_flops_bw": 1e12},
}


@pytest.mark.parametrize("params", sorted(PARAMS))
def test_algo_cost_and_terms_equal_reference(params):
    """``algo_cost`` and ``cost_terms`` of every registered name, for every
    group size and payload of the grid, bit for bit."""
    def costs(pkg):
        cp = pkg.ccl.cost.CostParams(**PARAMS[params])
        out = []
        for prim, algo in NAMES:
            for p in (1, 2, 4, 8, 16, 64):
                for size in (1, 4096, 3 << 20, 1 << 30):
                    for fn in (pkg.ccl.cost.algo_cost,
                               pkg.ccl.cost.cost_terms):
                        try:
                            c = fn(prim, algo, size, p, cp)
                        except Exception as e:  # noqa: BLE001
                            c = ("raised", type(e).__name__, str(e))
                        out.append(c)
        return out
    same(costs)


@pytest.mark.parametrize("allow", [None, ("ring", "tree"), ("ring",),
                                   ("ring+q8", "tree")])
def test_select_algorithm_equal_reference(allow):
    def select(pkg):
        return [pkg.ccl.select.select_algorithm(
                    prim, size, p, pkg.ccl.cost.CostParams(), allow=allow)
                for prim in ("all_reduce", "all_to_all")
                for p in (2, 4, 8, 16)
                for size in (1 << 10, 1 << 20, 1 << 30)
                if prim == "all_reduce" or allow is None]
    same(select)


def test_guards_equal_reference():
    r, p = twin(lambda pkg: (
        [pkg.ccl.select.is_square(n) for n in range(300)],
        [pkg.ccl.select.structurally_eligible(a, n)
         for _, a in NAMES for n in range(1, 20)],
        [repr(pkg.ccl.select.constraint_from_allow(a))
         for a in (None, (), ("ring",), ("ring", "tree"))]))
    assert p == r


TOPOS = {
    "dgx2": lambda t: t.dgx_cluster(2),
    "dgx2x4": lambda t: t.dgx_cluster(2, 4),
    "fattree": lambda t: t.fat_tree(2, 4),
    "ring8": lambda t: t.ring(8),
    "mesh8": lambda t: t.full_mesh(8),
    "torus": lambda t: t.torus2d(4, 4),
}

CONSTRAINTS = {
    "none": lambda k: None,
    "search": lambda k: k.Search(),
    "fixed_ring": lambda k: k.Fixed("ring"),
    "fixed_q8": lambda k: k.Fixed("ring+q8"),
    "choice": lambda k: k.Choice("ring", "tree", "ring+q8", "hierarchical"),
}


@pytest.mark.parametrize("model", ["alphabeta", "flowsim", "flowsim_cap4"])
@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_select_for_task_equal_reference(topo, model):
    """``select_for_task`` on every primitive the demand emits, at
    latency- and bandwidth-bound sizes, under each error budget and knob:
    the same ``Selection`` (costs in the same order, exclusions), the
    same ``AlphaBeta.from_topology`` parameters and the same FlowSim
    cache counters."""
    def select(pkg):
        t = TOPOS[topo](pkg.net.topology)
        if model == "alphabeta":
            m = pkg.ccl.select.AlphaBeta.from_topology(t)
        else:
            m = pkg.ccl.select.FlowSim(
                t, switch_capacity=4 if model.endswith("cap4") else None)
        out = [m.params if model == "alphabeta" else None]
        group = tuple(t.accelerators)
        for prim in ("all_reduce", "reduce_scatter", "all_gather",
                     "all_to_all", "broadcast"):
            for size in (4096, 1 << 20, 64 << 20):
                task = pkg.core.demand.CommTask("g", prim, size, group)
                for budget in (0.0, 0.01, 1.0):
                    for name, knob in CONSTRAINTS.items():
                        if prim != "all_reduce" and name not in ("none",
                                                                 "search"):
                            continue
                        try:
                            sel = pkg.ccl.select.select_for_task(
                                task, m, error_budget=budget,
                                constraint=knob(pkg.core.knobs))
                        except ValueError as e:
                            sel = ("raised", str(e))
                        out.append(sel)
        if model != "alphabeta":
            out.append(m.cache_stats())
        return out
    same(select)


def test_select_for_task_errors_equal_reference():
    def both(pkg):
        t = pkg.net.topology.ring(4)
        task = pkg.core.demand.CommTask("g", "all_reduce", 1 << 20,
                                        tuple(t.accelerators))
        return pkg.ccl.select.select_for_task(
            task, pkg.ccl.select.FlowSim(t), allow=("ring",),
            constraint=pkg.core.knobs.Fixed("ring"))
    same_raises(both, "ValueError")

    def bad_knob(pkg):
        t = pkg.net.topology.ring(4)
        task = pkg.core.demand.CommTask("g", "all_reduce", 1 << 20,
                                        tuple(t.accelerators))
        return pkg.ccl.select.select_for_task(
            task, pkg.ccl.select.FlowSim(t), constraint="ring")
    same_raises(bad_knob, "TypeError")

    def ineligible(pkg):
        return pkg.ccl.select.select_algorithm(
            "all_reduce", 1 << 20, 6, pkg.ccl.cost.CostParams(),
            allow=("halving_doubling",))
    same_raises(ineligible, "ValueError")


# ---------------------------------------------------------------------------
# the model tests of tests/test_ccl.py on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", [2, 4, 8, 16])
def test_ring_all_reduce_wire_bytes(p):
    n = 1024 * p
    fs = generate_flows(_task("all_reduce", n, p), "ring")
    per_node = sum(f.size_bytes for f in fs.flows) / p
    assert per_node == 2 * n * (p - 1) / p


@pytest.mark.parametrize("p", [2, 4, 8, 16, 32])
def test_halving_doubling_step_count(p):
    fs = generate_flows(_task("all_reduce", 1024 * p, p), "halving_doubling")
    assert fs.num_steps == 2 * int(math.log2(p))


@pytest.mark.parametrize("algo", ["ring", "bidir_ring", "halving_doubling",
                                  "tree"])
def test_cost_model_matches_simulation_on_mesh(algo):
    p, n = 8, 64 * 2 ** 20
    cp = CostParams(alpha=1e-6, link_bw=50e9)
    task = _task("all_reduce", n, p)
    fs = generate_flows(task, algo)
    topo = full_mesh(p, bw=cp.link_bw, lat=cp.alpha)
    sim = simulate_flowset(topo, fs)
    model = algo_cost("all_reduce", algo, n, p, cp)
    assert sim == pytest.approx(model, rel=0.15), (algo, sim, model)


def test_ring_beats_tree_for_large_tree_beats_ring_for_small():
    cp = CostParams(alpha=5e-6, link_bw=50e9)
    big = select_algorithm("all_reduce", 2 ** 30, 16, cp,
                           allow=("ring", "tree"))[0]
    small = select_algorithm("all_reduce", 2 ** 10, 16, cp,
                             allow=("ring", "tree"))[0]
    assert big == "ring" and small == "tree"


@given(size=st.integers(2 ** 10, 2 ** 32), p=st.sampled_from([2, 4, 8, 16]))
@settings(max_examples=50, deadline=None)
def test_cost_monotone_in_size(size, p):
    cp = CostParams()
    for algo in ("ring", "tree"):
        c1 = algo_cost("all_reduce", algo, size, p, cp)
        c2 = algo_cost("all_reduce", algo, size * 2, p, cp)
        assert c2 >= c1


@given(p=st.sampled_from([2, 4, 8, 16]),
       size=st.integers(2 ** 12, 2 ** 28))
@settings(max_examples=30, deadline=None)
def test_selection_is_argmin(p, size):
    cp = CostParams()
    best, cost, costs = select_algorithm("all_reduce", size, p, cp)
    assert cost == min(costs.values())
    assert costs[best] == cost
    r, q = twin(lambda pkg: pkg.ccl.select.select_algorithm(
        "all_reduce", size, p, pkg.ccl.cost.CostParams()))
    assert q == r


def test_torus2d_all_reduce():
    p = 256
    n = 256 * p
    t = _task("all_reduce", n, p)
    fs = generate_flows(t, "torus2d")
    ring_fs = generate_flows(t, "ring")
    per_node_2d = sum(f.size_bytes for f in fs.flows) / p
    per_node_1d = sum(f.size_bytes for f in ring_fs.flows) / p
    assert per_node_2d == pytest.approx(per_node_1d, rel=0.01)
    assert fs.num_steps == 2 * 15 + 2 * 15
    assert ring_fs.num_steps == 2 * 255
    topo = torus2d(16, 16)
    small = _task("all_reduce", 64 * 2 ** 10 * p // p * p, p)
    t2d = simulate_flowset(topo, generate_flows(small, "torus2d"))
    t1d = simulate_flowset(topo, generate_flows(small, "ring"))
    assert t2d < t1d
    cp = CostParams(alpha=1e-6, link_bw=50e9)
    model = algo_cost("all_reduce", "torus2d", n, p, cp)
    sim = simulate_flowset(full_mesh(p, bw=cp.link_bw, lat=cp.alpha),
                           generate_flows(t, "torus2d"))
    assert sim == pytest.approx(model, rel=0.2)


def test_ring_algorithm_prefers_ring_topology():
    p, n = 16, 64 * 2 ** 20
    t = _task("all_reduce", n, p)
    ring_topo, mesh_topo = ring(p), full_mesh(p)
    ring_on_ring = simulate_flowset(ring_topo, generate_flows(t, "ring"))
    ring_on_mesh = simulate_flowset(mesh_topo, generate_flows(t, "ring"))
    hd_on_ring = simulate_flowset(ring_topo,
                                  generate_flows(t, "halving_doubling"))
    assert ring_on_ring == pytest.approx(ring_on_mesh, rel=0.01)
    assert hd_on_ring > 2 * ring_on_ring


def test_cost_terms_sum_to_algo_cost():
    from repro_torch.ccl.cost import cost_terms
    cp = CostParams(alpha=1e-6, link_bw=50e9)
    for algo in ("ring", "bidir_ring", "halving_doubling", "ring+q8"):
        terms = cost_terms("all_reduce", algo, 1 << 24, 8, cp)
        total = algo_cost("all_reduce", algo, 1 << 24, 8, cp)
        assert terms["total_s"] == pytest.approx(total)
        assert terms["latency_s"] + terms["bandwidth_s"] + \
            terms["codec_s"] == pytest.approx(total)
        assert terms["latency_s"] >= 0 and terms["bandwidth_s"] >= 0
    assert cost_terms("all_reduce", "ring+q8", 1 << 24, 8,
                      cp)["codec_s"] > 0
    assert cost_terms("all_reduce", "ring", 1 << 24, 1, cp) == {
        "latency_s": 0.0, "bandwidth_s": 0.0, "codec_s": 0.0,
        "total_s": 0.0}


def test_flowsim_cache_stats():
    from repro_torch.ccl.select import FlowSim
    from repro_torch.net.topology import dgx_cluster
    topo = dgx_cluster(2)
    model = FlowSim(topo)
    task = CommTask("g", "all_reduce", 1 << 20, tuple(topo.accelerators))
    model.cost(task, "ring")
    model.cost(task, "ring")
    model.cost(task, "bidir_ring")
    stats = model.cache_stats()
    assert stats["flowsim[cap=None].cost.miss"] == 2.0
    assert stats["flowsim[cap=None].cost.hit"] == 1.0
    assert stats["flowsim[cap=None].cost.hit_rate"] == pytest.approx(1 / 3)
    assert stats["flowsim[cap=None].cost.entries"] == 2.0
    capped = FlowSim(topo, switch_capacity=4)
    capped.cost(task, "ring")
    assert "flowsim[cap=4].cost.miss" in capped.cache_stats()
