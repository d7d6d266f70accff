"""Twin of tests/test_net.py: the port's network layer
(``repro_torch.net.topology``, ``repro_torch.net.simulate``,
``repro_torch.sched.atp``) against the JAX package's on the same builder
calls, exactly: every topology node for node and link for link (the
insertion order is what breaks ``nx.shortest_path`` ties), every routed
path, per-link byte map, simulated time and ATP comparison.  Each test of
tests/test_net.py also runs on the port's objects."""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import itertools

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core.demand import CommTask, Flow
from repro_torch.net.simulate import _route_bytes
from repro_torch.net.topology import (dgx_cluster, fat_tree, full_mesh, ring,
                                      torus2d, torus3d, tpu_pod)
from repro_torch.sched.atp import atp_traffic
from torch_twin import same, same_raises, twin

# builder name -> calls of it (args, kwargs) that the tests build
BUILDS = {
    "ring": [((8,), {}), ((5,), {"bw": 25e9, "lat": 3e-6})],
    "full_mesh": [((8,), {}), ((4,), {"bw": 1e9})],
    "torus2d": [((4, 4), {}), ((16, 16), {})],
    "torus3d": [((2, 2, 2), {}), ((4, 4, 4), {})],
    "fat_tree": [((8,), {}), ((2, 4), {}),
                 ((2, 8), {"oversub": 8.0, "hosts_per_rack": 1}),
                 ((4,), {"gpus_per_host": 1, "hosts_per_rack": 1,
                         "racks_per_pod": 1, "agg_redundancy": 2,
                         "nic_bw": 2e9, "agg_bw": 8e9, "oversub": 4.0,
                         "pcie_bw": 4e9})],
    "dgx_cluster": [((2,), {}), ((2, 4), {}), ((1, 4), {}),
                    ((2,), {"nvlink_bw": 64e9})],
    "tpu_pod": [((False,), {}), ((True,), {})],
}
CASES = [(name, i) for name, calls in BUILDS.items()
         for i in range(len(calls))]


def _build(pkg, name, i):
    args, kwargs = BUILDS[name][i]
    return getattr(pkg.net.topology, name)(*args, **kwargs)


def _case_id(case):
    return f"{case[0]}{case[1]}"


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_topology_builders_equal_reference(case):
    """Nodes, links (with rates and latencies), accelerators and hosts in
    the reference's insertion order; the fingerprint the synthesizer's
    cache keys on is the same digest."""
    ref, port = same(lambda pkg: _build(pkg, *case))
    assert (port.switch_nodes() == ref.switch_nodes()
            and port.num_accelerators == ref.num_accelerators)
    r, p = twin(lambda pkg: pkg.ccl.synth.topology_fingerprint(
        _build(pkg, *case)))
    assert p == r


@pytest.mark.parametrize("case", [c for c in CASES
                                  if c not in (("torus2d", 1),
                                               ("torus3d", 1),
                                               ("tpu_pod", 0),
                                               ("tpu_pod", 1))],
                         ids=_case_id)
def test_paths_and_bisection_equal_reference(case):
    """Every accelerator pair routes along the reference's path (ties
    included), and the max-flow bisection is the same number."""
    ref, port = twin(lambda pkg: _build(pkg, *case))
    for s, d in itertools.permutations(ref.accelerators, 2):
        assert port.path(s, d) == ref.path(s, d), (s, d)
        assert port.path_links(s, d) == ref.path_links(s, d)
    assert port.bisection_bw() == ref.bisection_bw()
    assert port.host_groups(port.accelerators[::-1]) == \
        ref.host_groups(ref.accelerators[::-1])


@pytest.mark.parametrize("case", [("torus2d", 1), ("torus3d", 1),
                                  ("tpu_pod", 1)], ids=_case_id)
def test_large_fabric_paths_equal_reference(case):
    """The large fabrics, on a fixed sample of pairs (all pairs of a
    512-chip fabric would take minutes)."""
    ref, port = twin(lambda pkg: _build(pkg, *case))
    acc = ref.accelerators
    pairs = [(acc[i], acc[(i * 37 + 11) % len(acc)])
             for i in range(0, len(acc), 7)]
    for s, d in pairs:
        if s != d:
            assert port.path(s, d) == ref.path(s, d), (s, d)


@pytest.mark.parametrize("builder,args", [
    (ring, (8,)), (full_mesh, (8,)), (torus2d, (4, 4)),
    (torus3d, (2, 2, 2)), (fat_tree, (8,)), (dgx_cluster, (2,)),
])
def test_topology_connectivity(builder, args):
    topo = builder(*args)
    accel = topo.accelerators
    assert len(accel) >= 8
    p = topo.path(accel[0], accel[-1])
    assert p[0] == accel[0] and p[-1] == accel[-1]
    assert topo.bisection_bw() > 0


def test_torus_degree():
    topo = torus2d(16, 16)
    for n in topo.accelerators:
        assert topo.graph.out_degree(n) == 4


def test_tpu_pod_shapes():
    single = tpu_pod(False)
    assert single.num_accelerators == 256
    multi = tpu_pod(True)
    assert multi.num_accelerators == 512
    path = multi.path(0, 256)
    assert any(isinstance(n, str) and n.startswith("dcn") for n in path)


@given(st.integers(2, 5))
@settings(max_examples=8, deadline=None)
def test_dgx_intra_faster_than_inter(num_hosts):
    topo = dgx_cluster(num_hosts)
    intra = topo.path_links(0, 1)
    inter = topo.path_links(0, 8)
    min_bw_intra = min(topo.graph[u][v]["bw"] for u, v in intra)
    min_bw_inter = min(topo.graph[u][v]["bw"] for u, v in inter)
    assert min_bw_intra > 2 * min_bw_inter


def test_degradation_views_equal_reference():
    """``without_link``, ``without_host`` and ``scaled_bw`` (scalar and per
    link) build the reference's views, names included."""
    def views(pkg):
        topo = pkg.net.topology.fat_tree(
            4, gpus_per_host=2, hosts_per_rack=2, racks_per_pod=1,
            agg_redundancy=2)
        return [topo.without_link("tor0", "agg0.0"),
                topo.without_link("tor0", "agg0.1", symmetric=False),
                topo.without_host(1),
                topo.scaled_bw(0.5),
                topo.scaled_bw({("tor1", "agg0.0"): 0.25}),
                topo.without_link(0, "host0").without_link(0, "host0")]
    ref, port = same(views)
    for r, p in zip(ref, port):
        assert p.path(p.accelerators[1], p.accelerators[-1]) == \
            r.path(r.accelerators[1], r.accelerators[-1])


def test_degradation_view_errors_equal_reference():
    for bad in (lambda pkg: pkg.net.topology.dgx_cluster(2).without_host(2),
                lambda pkg: pkg.net.topology.ring(4).scaled_bw(0.0),
                lambda pkg: pkg.net.topology.fat_tree(
                    2, agg_redundancy=0)):
        same_raises(bad, "ValueError")


def _fan_in_out(pkg):
    topo = pkg.net.topology.fat_tree(4, gpus_per_host=1)
    f = pkg.core.demand.Flow
    flows = [f(0, 2, 100, "t", 0), f(0, 3, 100, "t", 0),
             f(1, 2, 100, "t", 0)]
    return pkg.net.simulate._route_bytes(topo, flows,
                                         set(topo.switch_nodes()))


def test_same_step_fanin_and_fanout_counted_once():
    topo = fat_tree(4, gpus_per_host=1)
    flows = [Flow(0, 2, 100, "t", 0), Flow(0, 3, 100, "t", 0),
             Flow(1, 2, 100, "t", 0)]
    link_bytes = _route_bytes(topo, flows, set(topo.switch_nodes()))
    assert link_bytes[("host2", 2)] == 100
    same(_fan_in_out)


def test_multicast_discount_gated_on_capable_switches():
    topo = fat_tree(8, gpus_per_host=1)
    flows = [Flow(0, d, 100, "t", 0) for d in (1, 2, 4, 5)]
    full = _route_bytes(topo, flows, set(topo.switch_nodes()))
    assert full[("tor0", "agg0")] == 100
    partial = _route_bytes(topo, flows, {"tor0"})
    assert partial[("tor0", "agg0")] == 200
    assert partial[(0, "host0")] == 100

    def route(pkg, capable):
        t = pkg.net.topology.fat_tree(8, gpus_per_host=1)
        fl = [pkg.core.demand.Flow(0, d, 100, "t", 0) for d in (1, 2, 4, 5)]
        return pkg.net.simulate._route_bytes(
            t, fl, set(t.switch_nodes()) if capable else {"tor0"})
    same(lambda pkg: route(pkg, True))
    same(lambda pkg: route(pkg, False))


def test_atp_reduces_traffic():
    topo = fat_tree(8)
    workers = tuple(topo.accelerators[:16])
    task = CommTask("grad", "all_reduce", 64 * 2 ** 20, workers)
    ps = topo.accelerators[-1]
    res = atp_traffic(topo, task, ps)
    assert res["traffic_reduction"] > 1.3
    assert res["speedup"] >= 1.0
    degraded = atp_traffic(topo, task, ps, switch_capacity=4)
    assert degraded["traffic_reduction"] == pytest.approx(1.0)


@pytest.mark.parametrize("capacity", [None, 4, 64])
def test_atp_traffic_equals_reference(capacity):
    def atp(pkg):
        topo = pkg.net.topology.fat_tree(8)
        task = pkg.core.demand.CommTask("grad", "all_reduce", 64 * 2 ** 20,
                                        tuple(topo.accelerators[:16]))
        return (pkg.sched.atp.atp_traffic(topo, task, topo.accelerators[-1],
                                          switch_capacity=capacity),
                pkg.sched.atp.aggregation_switches(topo, task.group,
                                                   capacity),
                pkg.sched.atp.host_aggregation_flows(task, 3))
    same(atp)


@pytest.mark.parametrize("algo", ["ring", "bidir_ring", "halving_doubling",
                                  "tree", "hierarchical", "atp"])
@pytest.mark.parametrize("topo_case", [("dgx_cluster", 0), ("fat_tree", 1),
                                       ("ring", 0), ("torus2d", 0)],
                         ids=_case_id)
def test_simulation_equals_reference(topo_case, algo):
    """``simulate_flowset`` (with and without in-network aggregation),
    ``simulate_schedule`` serial and concurrent, ``link_utilization``,
    ``link_rate_series`` and ``shared_link_load`` on the flows of one
    algorithm, all exact."""
    def sim(pkg):
        topo = _build(pkg, *topo_case)
        group = tuple(topo.accelerators)
        task = pkg.core.demand.CommTask("g", "all_reduce", 3 << 20, group)
        other = pkg.core.demand.CommTask("h", "all_reduce", 1 << 16, group,
                                         job_id="job1")
        try:
            fs = pkg.ccl.select.flows_on_topology(topo, task, algo)
        except (ValueError, KeyError) as e:
            return ("unsupported", type(e).__name__, str(e))
        fs2 = pkg.ccl.select.flows_on_topology(topo, other, "ring")
        simu = pkg.net.simulate
        agg = set(topo.switch_nodes())
        util = simu.link_utilization(topo, fs)
        return (simu.simulate_flowset(topo, fs),
                simu.simulate_flowset(topo, fs, aggregate_at=agg),
                simu.simulate_schedule(topo, [fs, fs2]),
                simu.simulate_schedule(topo, [fs, fs2], concurrent=True),
                util, simu.link_utilization(topo, fs, agg),
                simu.link_rate_series(topo, [(fs, 0.0, 2e-3),
                                             (fs2, 1e-3, 4e-3)]),
                simu.shared_link_load(
                    {"a": util, "b": simu.link_utilization(topo, fs2)}))
    same(sim)
