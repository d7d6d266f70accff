"""Helpers of the twin tests of the port's co-design engine
(``tests/test_torch_codesign*.py``): the fixture that puts both packages
in one state, the comparison of reports, and the JAX package's scenarios
(``benchmarks/paper_claims.py``) as functions of a package root.

A twin case builds its reports with one function ``build(pkg)`` through
``repro`` and through ``repro_torch`` (``torch_twin.REF`` / ``PORT``) and
asks for ``to_dict()`` JSON-equal, in key order.  Before each build the
``codesign_twin`` fixture gives that package a fresh synthesis cache, in
``ccl.synth`` and in ``codesign.api`` (which imports it by name), so the
search telemetry does not depend on the test files a worker ran before;
it pins the port's peak to the reference's (``build_demand`` turns FLOPs
into seconds at the target's peak, and the port's target is the H100);
and it hands each build the same fake clock (``clock()``), which is the
only wall clock the engine reads (``ClusterDynamics``' re-plan times).
"""
import importlib
import json

import pytest

from torch_ccl_ranks import FakeClock
from torch_twin import PORT, REF, canon


def _report_form(x):
    """``x`` with every report replaced by the JSON of its ``to_dict()``
    (key order kept) and, for a training plan, the ``canon`` of its live
    simulation, which ``to_dict`` leaves out."""
    if hasattr(x, "to_dict") and not isinstance(x, type):
        form = ("to_dict", json.dumps(x.to_dict()))
        sim = getattr(x, "sim", None)
        return form + (canon(sim),) if sim is not None else form
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_report_form(v) for v in x)
    if isinstance(x, dict):
        return ("dict",) + tuple((canon(k), _report_form(v))
                                 for k, v in x.items())
    return canon(x)


class Twin:
    """See the module doc; made by the ``codesign_twin`` fixture."""

    def __init__(self, monkeypatch):
        self._mp = monkeypatch
        self.clocks = []

    def fresh(self, pkg) -> None:
        synth = importlib.import_module(pkg._dotted + ".ccl.synth")
        api = importlib.import_module(pkg._dotted + ".codesign.api")
        cache = synth.SynthCache()
        self._mp.setattr(synth, "DEFAULT_SYNTH_CACHE", cache)
        self._mp.setattr(api, "DEFAULT_SYNTH_CACHE", cache)

    def clock(self) -> FakeClock:
        """The build's clock: a fresh one a build, so both packages read
        the same sequence."""
        return self.clocks[-1]

    def build(self, fn):
        out = []
        for pkg in (REF, PORT):
            self.fresh(pkg)
            self.clocks.append(FakeClock())
            out.append(fn(pkg))
        return tuple(out)

    def same(self, fn):
        """Build through both packages; every report in the result (and
        everything else in it) must be equal.  Returns (ref, port)."""
        ref, port = self.build(fn)
        assert _report_form(port) == _report_form(ref)
        return ref, port

    def raises(self, fn, exc_name: str) -> None:
        """Both packages raise an exception of class ``exc_name`` with the
        same message."""
        msgs = []
        for pkg in (REF, PORT):
            self.fresh(pkg)
            self.clocks.append(FakeClock())
            with pytest.raises(Exception) as ei:
                fn(pkg)
            assert type(ei.value).__name__ == exc_name, repr(ei.value)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]


def pinned_twin(monkeypatch) -> Twin:
    """The port's peak pinned to the reference's, through ``monkeypatch``;
    the ``Twin`` that builds under it."""
    import repro.core.hw as ref_hw
    import repro_torch.core.hw as port_hw
    monkeypatch.setattr(port_hw, "PEAK_FLOPS_BF16", ref_hw.PEAK_FLOPS_BF16)
    return Twin(monkeypatch)


@pytest.fixture
def codesign_twin(monkeypatch):
    return pinned_twin(monkeypatch)


def cross_load(ref, port, cls_name: str, module: str, *extra) -> None:
    """Each report's JSON through the other package's ``from_dict`` and
    back is the same JSON.  ``extra(pkg)`` gives ``from_dict``'s further
    arguments in that package (the job specs of a cluster report)."""
    for src, dst in ((ref, PORT), (port, REF)):
        wire = json.loads(json.dumps(src.to_dict()))
        cls = getattr(importlib.import_module(
            f"{dst._dotted}.codesign.{module}"), cls_name)
        back = cls.from_dict(wire, *[e(dst) for e in extra])
        assert json.dumps(back.to_dict()) == json.dumps(src.to_dict())


# ---------------------------------------------------------------------------
# the JAX package's scenarios (benchmarks/paper_claims.py, tests/test_*.py)
# ---------------------------------------------------------------------------


def train_4k(pkg):
    return pkg.core.types.SHAPES_BY_NAME["train_4k"]


def dp_mesh(pkg, n: int):
    return pkg.core.types.MeshConfig(shape=(n,), axis_names=("data",),
                                     data_axes=("data",), model_axes=())


def dp2_tp8(pkg):
    return pkg.core.types.MeshConfig(shape=(2, 8),
                                     axis_names=("data", "model"))


def placement_search_problem(pkg):
    """``paper_claims._placement_search_problem``: TP-12 over 8-GPU hosts
    on an 8x oversubscribed fat-tree."""
    topo = pkg.net.topology.fat_tree(num_hosts=4, gpus_per_host=8,
                                     hosts_per_rack=1, oversub=8.0,
                                     pcie_bw=128e9)
    mesh = pkg.core.types.MeshConfig(shape=(2, 12),
                                     axis_names=("data", "model"))
    return pkg.codesign.CodesignProblem(
        pkg.configs.get_config("qwen2-0.5b"), train_4k(pkg), mesh, topo,
        space=pkg.codesign.PlanSpace(placement=pkg.codesign.Search()))


def cluster_topo(pkg):
    """The slow two-rack fat-tree of the contended tenants."""
    return pkg.net.topology.fat_tree(num_hosts=4, gpus_per_host=2,
                                     hosts_per_rack=2, nic_bw=2e9,
                                     agg_bw=8e9, oversub=4.0, pcie_bw=4e9)


def contended_cluster(pkg):
    """``paper_claims._contended_cluster``: two DP-4 tenants straddling
    both racks."""
    topo = cluster_topo(pkg)
    cfg = pkg.configs.get_config("qwen2-0.5b")
    dpp = pkg.core.demand_builder.DemandParams(zero1=False)
    job = pkg.codesign.JobSpec
    jobs = [job("jobA", cfg, train_4k(pkg), dp_mesh(pkg, 4),
                policy="serial", devices=topo.hosts[0] + topo.hosts[2],
                dp_params=dpp),
            job("jobB", cfg, train_4k(pkg), dp_mesh(pkg, 4),
                policy="serial", devices=topo.hosts[1] + topo.hosts[3],
                dp_params=dpp)]
    return jobs, topo


def dynamic_cluster(pkg):
    """``paper_claims._dynamic_cluster``: four DP-2 tenants on a 4-pod
    redundant fat-tree and the 8-event trace."""
    topo = pkg.net.topology.fat_tree(num_hosts=8, gpus_per_host=2,
                                     hosts_per_rack=2, racks_per_pod=1,
                                     agg_redundancy=2, nic_bw=2e9,
                                     agg_bw=8e9, oversub=4.0, pcie_bw=4e9)
    cfg = pkg.configs.get_config("qwen2-0.5b")
    dpp = pkg.core.demand_builder.DemandParams(zero1=False)
    Event = pkg.codesign.Event

    def job(name, devices):
        return pkg.codesign.JobSpec(name, cfg, train_4k(pkg),
                                    dp_mesh(pkg, 2), policy="serial",
                                    devices=devices, dp_params=dpp)

    jobs = [job("jobA", (0, 4)), job("jobB", (2, 6)),
            job("jobC", (8, 12)), job("jobD", (10, 14))]
    events = [
        Event("job_arrive", time=1.0, job=job("jobE", (1, 5))),
        Event("straggler", time=2.0, name="jobC", factor=1.4),
        Event("link_degrade", time=3.0, link=("tor0", "agg0.0"),
              factor=0.5),
        Event("straggler", time=4.0, name="jobA", factor=1.3),
        Event("link_fail", time=5.0, link=("tor2", "agg2.0")),
        Event("job_depart", time=6.0, name="jobB"),
        Event("straggler", time=7.0, name="jobD", factor=1.2),
        Event("host_fail", time=8.0, host=2),
    ]
    return jobs, topo, events


def serving_cotenant_problem(pkg, cost_model: str = "alphabeta"):
    """``paper_claims._serving_cotenant_problem``: a serving tenant whose
    requests arrive in lockstep with a training pulse."""
    cs = pkg.codesign
    arrivals = pkg.sched.arrivals
    cfg = pkg.core.types.ModelConfig(
        name="m", family="dense", source="[bench]", num_layers=8,
        d_model=1024, num_heads=16, num_kv_heads=8, d_ff=4096,
        vocab_size=32000)
    topo = pkg.net.topology.fat_tree(4, gpus_per_host=4, oversub=8.0)
    period = 0.01
    arr = arrivals.TraceArrivals(tuple(
        arrivals.Arrival(f"r{k:02d}", k * period, 1024, 32)
        for k in range(20)))
    pulse = cs.CotenantPulse("train0", period_s=period, comm_s=0.004,
                             demand={(u, v): 1.0
                                     for u, v in topo.graph.edges})
    spec = cs.ServingSpec(name="svc", cfg=cfg, prefill_devices=4,
                          decode_devices=4, arrivals=arr,
                          slo=cs.ServingSLO(ttft_s=0.01, tpot_s=0.002),
                          prefill_batch=1, decode_slots=8, horizon_s=0.25,
                          cotenants=(pulse,))
    return cs.serving_problem(spec, topo, cost_model=cost_model)


def mixed_serving_cluster(pkg):
    """``paper_claims._mixed_serving_cluster``: a DP-4 training tenant
    beside a disaggregated serving tenant on the shared uplinks."""
    cs = pkg.codesign
    arrivals = pkg.sched.arrivals
    topo = cluster_topo(pkg)
    cfg = pkg.configs.get_config("qwen2-0.5b")
    train = cs.JobSpec("train", cfg, train_4k(pkg), dp_mesh(pkg, 4),
                       policy="serial",
                       devices=topo.hosts[0] + topo.hosts[2],
                       dp_params=pkg.core.demand_builder.DemandParams(
                           zero1=False))
    arr = arrivals.TraceArrivals(tuple(
        arrivals.Arrival(f"r{k:02d}", k * 0.4, 1024, 32)
        for k in range(20)))
    svc = cs.ServingSpec(name="svc", cfg=cfg, prefill_devices=2,
                         decode_devices=2, arrivals=arr,
                         slo=cs.ServingSLO(ttft_s=0.05, tpot_s=0.01),
                         prefill_batch=1, decode_slots=8, horizon_s=8.0)
    serve = cs.JobSpec("svc", serving=svc,
                       devices=topo.hosts[1] + topo.hosts[3])
    return [train, serve], topo
