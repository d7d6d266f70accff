"""Twin tests of the port's demand layer: ``repro_torch.core.types``'
workload shapes and meshes, ``core.hw``, ``core.demand``, ``core.knobs``
and ``core.demand_builder`` against the JAX package's.

``build_demand`` turns FLOPs into seconds with the target's peak, and the
two packages target different chips (``repro.core.hw``: the JAX package's
TPU; ``repro_torch.core.hw``: the H100).  So the parity tests pin the
port's peak to the value they read from ``repro.core.hw`` and then ask
for equal demands, field by field; a second test keeps the H100's peak
and asks for the reference's times scaled by the ratio of the peaks."""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import dataclasses
import math

import pytest

from repro_torch.configs import ARCHS
from torch_twin import REF, canon, same, twin

MIB = 2 ** 20
MESHES = {
    "single_pod": lambda t: t.SINGLE_POD_MESH,
    "multi_pod": lambda t: t.MULTI_POD_MESH,
    "dp4": lambda t: t.MeshConfig(shape=(4, 1)),
    "dp2_tp8": lambda t: t.MeshConfig(shape=(2, 8),
                                      axis_names=("data", "model")),
}
KINDS = ("train", "prefill", "decode")


@pytest.fixture
def pinned_peak(monkeypatch):
    """The port's peak set to the reference's, read from its module."""
    import repro.core.hw as ref_hw
    import repro_torch.core.hw as port_hw
    monkeypatch.setattr(port_hw, "PEAK_FLOPS_BF16", ref_hw.PEAK_FLOPS_BF16)


def test_shapes_and_meshes_equal_reference():
    r, p = twin(lambda pkg: [
        pkg.core.types.INPUT_SHAPES, pkg.core.types.SHAPES_BY_NAME,
        pkg.core.types.TRAIN_4K, pkg.core.types.PREFILL_32K,
        pkg.core.types.DECODE_32K, pkg.core.types.LONG_500K,
        pkg.core.types.SINGLE_POD_MESH, pkg.core.types.MULTI_POD_MESH,
        [(m.num_devices, m.dp, m.tp) for m in (
            pkg.core.types.SINGLE_POD_MESH, pkg.core.types.MULTI_POD_MESH)]])
    assert canon(p) == canon(r)
    r, p = twin(lambda pkg: [getattr(pkg.core, n).__module__ for n in (
        "ShapeConfig", "CommTask", "FlowSet", "MeshConfig")])
    assert p == [m.replace("repro.", "repro_torch.", 1) for m in r]


def _build_all(pkg, arch, shape_name):
    types = pkg.core.types
    cfg = pkg.configs.get_config(arch)
    base = types.SHAPES_BY_NAME[shape_name]
    db = pkg.core.demand_builder
    out = []
    for kind in KINDS:
        shape = dataclasses.replace(base, kind=kind)
        for mesh_name, mesh in MESHES.items():
            for params in (None, db.DemandParams(zero1=False,
                                                 grad_chunks=3)):
                for bucket in (None, 64 * MIB):
                    dem = db.build_demand(cfg, shape, mesh(types),
                                          dp_params=params,
                                          bucket_bytes=bucket)
                    out.append(dem)
                    out.append((dem.total_bytes(), dem.by_primitive()))
                    if mesh_name == "dp2_tp8" and bucket is None:
                        out.append(db.decompose_demand(dem))
                        out.append(db.decompose_demand(dem, axis=None))
        out.append(db.janus_traffic_ratio(cfg, shape, types.SINGLE_POD_MESH))
    return out


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_build_demand_equals_reference(pinned_peak, arch, shape_name):
    """Every arch x every named shape, each as a train, prefill and
    decode step, on four meshes, with and without fused 64 MiB gradient
    buckets, ZeRO-1 on and off (with Lina-split gradients): the same
    ``CommDemand``, task for task and field for field, its byte totals,
    its collective-matmul rewrites, and the Janus ratio."""
    same(lambda pkg: _build_all(pkg, arch, shape_name))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "dbrx-132b",
                                  "jamba-1.5-large-398b", "deepseek-v2-236b"])
def test_build_demand_on_h100_scales_by_the_peak_ratio(arch):
    """Under the port's own peak (the H100's), every compute duration is
    the reference's scaled by (reference peak / H100 peak) to within one
    ulp; FLOPs, sizes, groups and edges are the reference's.  A gradient
    task's ``slack`` is the backward compute still to run, in seconds, so
    it scales by the same ratio; every other comm field is unchanged."""
    import repro.core.hw as ref_hw
    import repro_torch.core.hw as port_hw
    ratio = ref_hw.PEAK_FLOPS_BF16 / port_hw.PEAK_FLOPS_BF16
    assert ratio < 1.0  # the H100 is the faster target
    for mesh in ("dp4", "dp2_tp8"):
        ref, port = twin(lambda pkg: pkg.core.demand_builder.build_demand(
            pkg.configs.get_config(arch), pkg.core.types.TRAIN_4K,
            MESHES[mesh](pkg.core.types), bucket_bytes=64 * MIB))
        assert len(port.compute_tasks) == len(ref.compute_tasks)
        for r, p in zip(ref.compute_tasks, port.compute_tasks):
            assert (p.task_id, p.flops, p.job_id) == \
                (r.task_id, r.flops, r.job_id)
            want = r.duration * ratio
            assert abs(p.duration - want) <= math.ulp(want), (r, p)
        assert len(port.comm_tasks) == len(ref.comm_tasks)
        for r, p in zip(ref.comm_tasks, port.comm_tasks):
            want = r.slack * ratio
            assert abs(p.slack - want) <= 2 * math.ulp(want), (r, p)
            assert canon(dataclasses.replace(p, slack=0.0)) == \
                canon(dataclasses.replace(r, slack=0.0))


def test_hw_states_the_h100_datasheet():
    """The port's constants are the card's (no TPU figure), and
    ``roofline_seconds`` is the reference's formula over them."""
    import repro.core.hw as ref_hw
    from repro_torch.core import hw
    assert hw.PEAK_FLOPS_BF16 == 989e12 and hw.HBM_BW == 3.35e12
    assert hw.HBM_BYTES == 80 * 2 ** 30 and hw.NVLINK_BW == 450e9
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "HBM_BYTES"):
        assert getattr(hw, name) != getattr(ref_hw, name)
    got = hw.roofline_seconds(2e15, 6e12, 9e11, 2)
    assert got == {"compute_s": 2e15 / (2 * hw.PEAK_FLOPS_BF16),
                   "memory_s": 6e12 / (2 * hw.HBM_BW),
                   "collective_s": 9e11 / (2 * hw.NVLINK_BW)}


def test_decompose_demand_edge_cases_equal_reference():
    """Collective-matmul rewrites on a hand-built graph: an all-reduce
    with producer and consumer, an all-gather and a reduce-scatter on the
    model axis, a task whose anchors conflict, a data-axis task left bulk
    and a primitive subset."""
    def build(pkg):
        d = pkg.core.demand
        dem = d.CommDemand(job_id="j")
        dem.compute_tasks = [d.ComputeTask(f"c{i}", 1e9, 1e-3, "j")
                             for i in range(5)]
        g4, g2 = (0, 1, 2, 3), (0, 1)
        dem.comm_tasks = [
            d.CommTask("ar", "all_reduce", 4096, g4, ("c0",), "c1",
                       job_id="j", axis="model"),
            d.CommTask("ag", "all_gather", 4096, g4, ("c1",), "c2",
                       job_id="j", axis="model"),
            d.CommTask("rs", "reduce_scatter", 999, g2, ("c2",), "c3",
                       job_id="j", axis="model"),
            d.CommTask("dp", "all_reduce", 4096, g4, ("c3",), "c4",
                       slack=0.5, job_id="j", axis="data"),
            d.CommTask("x", "all_to_all", 64, g4, ("c0",), None,
                       job_id="j", axis="model")]
        db = pkg.core.demand_builder
        return [db.decompose_demand(dem), db.decompose_demand(dem, axis=None),
                db.decompose_demand(dem, primitives=("all_gather",)),
                db.decompose_demand(dem, primitives=()),
                db.DECOMPOSABLE_PRIMITIVES]
    same(build)


def test_knobs_equal_reference():
    """Knob values, equality, hashing, coercion and freedom, as the
    reference defines them."""
    def knobs(pkg):
        k = pkg.core.knobs
        vals = [k.Fixed("ring"), k.Fixed(3), k.Choice("ring", "tree"),
                k.Search(), k.Search(seeds=("a",)), k.as_knob("tree"),
                k.as_knob(k.Choice(1, 2))]
        return ([repr(v) for v in vals], [k.is_free(v) for v in vals],
                [[a == b for b in vals] for a in vals],
                len({v for v in vals}),
                [isinstance(v, k.Knob) for v in vals])
    r, p = twin(knobs)
    assert p == r
    from repro_torch.core.knobs import Fixed
    with pytest.raises(AttributeError):
        Fixed(1).value = 2


def test_demand_containers_equal_reference():
    def build(pkg):
        d = pkg.core.demand
        dem = d.CommDemand(
            comm_tasks=[d.CommTask("a", "all_reduce", 10, (0, 1)),
                        d.CommTask("b", "all_gather", 7, (0, 1)),
                        d.CommTask("c", "all_reduce", 5, (0, 1),
                                   phase="decode")])
        fs = d.FlowSet("a", "ring", [d.Flow(0, 1, 5, "a", 0),
                                     d.Flow(1, 0, 5, "a", 1)], 2)
        return (dem, dem.total_bytes(), dem.by_primitive(), fs,
                fs.bytes_on_wire())
    same(build)


def test_port_types_compare_with_reference_configs():
    """The configs the demand builder reads: the port's registry gives the
    reference's ``ModelConfig`` for every arch, param counts included."""
    for arch in ARCHS:
        r, p = twin(lambda pkg: pkg.configs.get_config(arch))
        assert canon(p) == canon(r)
        assert p.param_counts() == r.param_counts()
        assert [canon(s) for s in p.layer_specs()] == \
            [canon(s) for s in r.layer_specs()]
    assert REF.core.types.ShapeConfig.__module__ == "repro.core.types"
