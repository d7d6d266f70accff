"""The paper-specific walkthrough on the PyTorch port: one training job
through all five layers of the communication-optimization paradigm (Fig.
5a), wired together by the ``repro_torch.codesign`` engine behind its
declarative ``CodesignProblem`` API.  The port's copy of
``examples/comm_codesign.py``, section for section; it prints what the JAX
package's walkthrough prints, but for the line that names the executor of
the synthesized winner (``ccl.primitives.synthesized_collective`` on the
ranks of a process group, where the JAX package names ``make_synthesized``
on a mesh).  Demand seconds come from ``repro_torch.core.hw``'s peak (the
H100's), so the times are the reference's only where that peak is pinned
to the reference's, as ``tests/test_torch_comm_codesign.py`` does.

  1. Para.   — pick an architecture + mesh; emit its CommDemand
  2. Codesign (vertical) — a ``CodesignProblem`` pinned knob by knob:
     placement onto a physical topology + per-task algorithm selection
     priced on that topology + JCT scheduling, via ``codesign.plan``
  3. Plan-space search — ``placement=Search()``: the optimizer walks
     packed/balanced/strided/permuted candidates + swap refinement and
     attributes the JCT win per knob
  3b. Overlap search — the demand-DAG knobs walked jointly
     (``bucket_bytes`` x ``decompose`` x policy): gradient buckets
     chained off backward layers and collective-matmul TP decomposition,
     priced through true compute-comm dependency edges
  3c. Synthesis knob — ``synthesize=Search()``: TACCL-style schedules
     synthesized for the plan's hottest collectives, priced against the
     registry under both cost models, lowered to the executable
     ``synthesized_collective``
  4. CCL     — the selection crossover in detail: closed-form AlphaBeta vs
     topology-priced FlowSim, + TACCL-style synthesis
  5. Flow sched. (horizontal) — two jobs sharing links, CASSINI staggering
  6. Net.    — the same collective on torus vs oversubscribed fat-tree

    PYTHONPATH=src python examples/torch_comm_codesign.py --arch dbrx-132b
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.ccl.select import AlphaBeta, FlowSim, select_for_task
from repro_torch.ccl.synth import Sketch, synthesize
from repro_torch.codesign import (Choice, CodesignProblem, JobSpec,
                                  PlanSpace, Search, plan, plan_cluster,
                                  plan_iteration, search)
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.demand import CommTask
from repro_torch.core.demand_builder import (DemandParams, build_demand,
                                             janus_traffic_ratio)
from repro_torch.core.types import (MeshConfig, SHAPES_BY_NAME,
                                    SINGLE_POD_MESH)
from repro_torch.net.simulate import simulate_flowset
from repro_torch.net.topology import dgx_cluster, fat_tree, torus2d
from repro_torch.ccl.algorithms import generate_flows
from repro_torch.sched.flows import JobProfile, stagger_jobs

DP2_TP8 = MeshConfig(shape=(2, 8), axis_names=("data", "model"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dbrx-132b", choices=ARCHS)
    args = ap.parse_args()
    cfg = get_config(args.arch)
    shape = SHAPES_BY_NAME["train_4k"]

    print("=" * 72)
    print(f"[1] Parallelization strategy -> CommDemand   ({cfg.name})")
    dem = build_demand(cfg, shape, SINGLE_POD_MESH, DemandParams())
    by_prim = dem.by_primitive()
    for prim, nbytes in sorted(by_prim.items()):
        print(f"    {prim:15s} {nbytes/2**30:8.2f} GiB per iteration")
    if cfg.is_moe:
        jr = janus_traffic_ratio(cfg, shape, SINGLE_POD_MESH)
        print(f"    (Janus check: expert-centric/data-centric traffic = "
              f"{jr['ratio']:.1f}x)")

    print("=" * 72)
    print("[2] Codesign engine: demand -> placement -> selection -> JCT")
    topo = dgx_cluster(2)
    print(f"    mesh {DP2_TP8.shape} (data x model) on {topo.name}")
    # the declarative surface: one problem, knobs pinned per variant
    problem = CodesignProblem(cfg, shape, DP2_TP8, topo)
    for pol in ("serial", "fifo", "priority", "preempt"):
        r = plan(problem.pinned(policy=pol))
        print(f"    {pol:9s} JCT={r.jct:7.3f}s exposed={r.exposed_comm:6.3f}s"
              f" ({100*r.comm_fraction:4.1f}%)")
    rep = plan(problem.pinned(policy="priority"))
    print("    per-primitive algorithm choices (FlowSim on the topology):")
    for prim, hist in sorted(rep.algorithms_by_primitive().items()):
        pick = ", ".join(f"{a} x{k}" for a, k in sorted(hist.items()))
        print(f"      {prim:15s} {pick}")
    print("    hottest links (bytes over one iteration):")
    for (u, v), nbytes in rep.link_hotspots[:4]:
        print(f"      {u!s:>7s} -> {v!s:<7s} {nbytes/2**30:8.2f} GiB")
    strided = plan(problem.pinned(policy="serial", placement="strided"))
    packed = plan(problem.pinned(policy="serial"))
    print(f"    placement: packed comm {packed.comm_time:.3f}s vs strided "
          f"{strided.comm_time:.3f}s "
          f"({strided.comm_time/max(packed.comm_time, 1e-12):.2f}x worse)")
    dp16 = MeshConfig(shape=(16,), axis_names=("data",),
                      data_axes=("data",), model_axes=())
    dpp = DemandParams(zero1=False)
    # plan_iteration is now a thin kwarg adapter over the same engine
    auto = plan_iteration(cfg, shape, dp16, topo, policy="serial",
                          dp_params=dpp)
    ring = plan_iteration(cfg, shape, dp16, topo, policy="serial",
                          dp_params=dpp, force={"all_reduce": "ring"})
    print(f"    gradient AR (pure DP): auto=hierarchical comm "
          f"{auto.comm_time:.3f}s vs forced flat ring {ring.comm_time:.3f}s "
          f"({ring.comm_time/max(auto.comm_time, 1e-12):.2f}x)")

    print("=" * 72)
    print("[2b] Compression (repro.compress): error budget admits lossy "
          "candidates")
    # one worker per host on an oversubscribed fat-tree: gradient syncs are
    # bandwidth-bound, the compression sweet spot (canonical copy:
    # benchmarks.paper_claims.bench_compression_candidate, asserted in CI)
    ctopo = fat_tree(num_hosts=8, gpus_per_host=1, oversub=8.0)
    dp8 = MeshConfig(shape=(8,), axis_names=("data",), data_axes=("data",),
                     model_axes=())
    small_cfg = get_config("qwen2-0.5b")
    cdpp = DemandParams(zero1=False)
    base = plan_iteration(small_cfg, shape, dp8, ctopo, policy="serial",
                          dp_params=cdpp)
    for budget in (0.01, 0.5):
        comp = plan_iteration(small_cfg, shape, dp8, ctopo, policy="serial",
                              dp_params=cdpp, error_budget=budget)
        hist = comp.algorithms_by_primitive().get("all_reduce", {})
        picks = ", ".join(f"{a} x{k}" for a, k in sorted(hist.items()))
        print(f"    budget {budget:4.2f}: JCT {base.jct:.3f}s -> "
              f"{comp.jct:.3f}s ({base.jct / comp.jct:.2f}x), wire bytes "
              f"saved {comp.wire_bytes_saved / 2 ** 30:6.2f} GiB  [{picks}]")
    print(f"    budget 0   : baseline keeps every collective exact "
          f"({', '.join(sorted(base.algorithms_by_primitive().get('all_reduce', {})))})")

    print("=" * 72)
    print("[3] Plan-space search: placement=Search() on an oversubscribed "
          "fat-tree")
    # TP-12 over 8-GPU hosts: packed straddles a host boundary 8+4, an
    # uneven partition the hierarchical all-reduce cannot use (canonical
    # copy: benchmarks.paper_claims.bench_placement_search, asserted in CI)
    stopo = fat_tree(num_hosts=4, gpus_per_host=8, hosts_per_rack=1,
                     oversub=8.0, pcie_bw=128e9)
    smesh = MeshConfig(shape=(2, 12), axis_names=("data", "model"))
    sproblem = CodesignProblem(get_config("qwen2-0.5b"), shape, smesh, stopo,
                               space=PlanSpace(placement=Search()))
    sres = search(sproblem, budget=12)
    spacked = plan(sproblem.pinned(placement="packed"))
    print(f"    explored {sres.evaluated} candidates "
          f"(budget {sres.budget}); frontier:")
    for cand in sres.frontier[:4]:
        p = cand.assignment["placement"]
        label = p.strategy if hasattr(p, "strategy") else p
        print(f"      {label:16s} JCT {cand.jct:7.3f}s")
    print(f"    best {sres.best.placement.strategy!r} "
          f"JCT {sres.best.jct:.3f}s vs packed {spacked.jct:.3f}s "
          f"({spacked.jct / sres.best.jct:.2f}x): balanced 6+6 host split "
          f"re-enables hierarchical where packed's 8+4 straddle cannot")
    print("    per-knob attribution of the win:")
    for knob, saved in sres.attribution.items():
        print(f"      {knob:12s} saves {saved:7.3f}s of JCT vs its baseline")
    blob = json.dumps(sres.best.to_dict())
    print(f"    winning plan serializes to JSON "
          f"({len(blob)} bytes via CodesignReport.to_dict)")

    print("=" * 72)
    print("[3b] Overlap search: bucket_bytes x decompose x policy "
          "(demand-DAG knobs)")
    # PCIe-class 8-GPU hosts (64 GB/s intra-host): TP collectives expose
    # real time, gradient buckets compete for the wire (canonical copy:
    # benchmarks.paper_claims.bench_overlap_search, asserted in CI)
    otopo = dgx_cluster(2, nvlink_bw=64e9)
    ocfg = get_config("h2o-danube-1.8b")
    oproblem = CodesignProblem(
        ocfg, shape, DP2_TP8, otopo,
        space=PlanSpace(bucket_bytes=Search(), decompose=Search(),
                        policy=Choice("fifo", "priority")))
    total = sum(t.size_bytes
                for t in build_demand(ocfg, shape, DP2_TP8).comm_tasks
                if t.axis == "data" and t.before_compute == "opt")
    print("    bucket-size ladder vs JCT (fifo, bulk TP collectives):")
    for bb in (None, total, total // 4, total // 16, total // 64):
        r = plan(oproblem.pinned(policy="fifo", bucket_bytes=bb,
                                 decompose=False))
        label = "per-layer" if bb is None else f"{bb / 2 ** 20:.0f} MiB"
        print(f"      bucket {label:>10s}: JCT {r.jct:.3f}s "
              f"exposed {r.exposed_comm:.3f}s")
    onaive = plan(oproblem.pinned(policy="fifo", bucket_bytes=None,
                                  decompose=False))
    ores = search(oproblem, budget=40)
    ba = ores.best_assignment
    print(f"    searched best (of {ores.evaluated}): policy={ba['policy']!r} "
          f"bucket_bytes={ba['bucket_bytes']} decompose={ba['decompose']}")
    print(f"    JCT {onaive.jct:.3f}s -> {ores.best.jct:.3f}s "
          f"({onaive.jct / ores.best.jct:.2f}x vs naive overlap)")
    print("    per-knob attribution of the win:")
    for knob, saved in ores.attribution.items():
        print(f"      {knob:12s} saves {saved:7.3f}s of JCT vs its baseline")
    print("    hottest remaining exposure (task_exposed_s):")
    for tid, s in ores.best.top_exposed_tasks(4):
        print(f"      {tid:18s} {s:7.4f}s")

    print("=" * 72)
    print("[3c] Synthesis as a knob: synthesize=Search() on a flat "
          "8-GPU mesh")
    # latency-regime TP all-reduces: the registry's best (6 serialized
    # halving-doubling steps) pays 3x the synthesized 2-step mesh
    # schedule's alphas; the knob finds and attributes that, per model
    from repro_torch.ccl.primitives import synthesized_collective
    from repro_torch.ccl.synth import synthesize_schedule
    from repro_torch.core.types import ShapeConfig
    smesh = MeshConfig(shape=(8,), axis_names=("model",), data_axes=(),
                       model_axes=("model",))
    from repro_torch.net.topology import full_mesh
    stopo = full_mesh(8)
    sproblem = CodesignProblem(
        get_config("qwen2-0.5b"), ShapeConfig("tiny", 64, 1, "train"),
        smesh, stopo, space=PlanSpace(synthesize=Search()))
    for cm in ("alphabeta", "flowsim"):
        import dataclasses as _dc
        sres = search(_dc.replace(sproblem, cost_model=cm), budget=8)
        soff = plan(_dc.replace(sproblem, cost_model=cm).pinned(
            synthesize=False))
        nsyn = len(sres.best.synthesized_choices)
        print(f"    {cm:9s} JCT {soff.jct * 1e3:.3f}ms -> "
              f"{sres.best.jct * 1e3:.3f}ms "
              f"({nsyn} tasks synthesized, knob buys "
              f"{sres.attribution.get('synthesize', 0.0) * 1e3:.3f}ms, "
              f"solver cache {sres.telemetry.get('synth_hit_rate', 0.0):.0%}"
              f" hits)")
    # the winning schedule is executable: every rank of a process group
    # runs its move list through the port's permutes
    c = sres.best.synthesized_choices[0]
    sched = synthesize_schedule(
        stopo, CommTask(c.task_id, c.primitive, c.size_bytes, c.group))
    assert callable(synthesized_collective)
    print(f"    winner ({c.primitive}, {c.size_bytes / 2 ** 10:.0f} KiB): "
          f"{sched.num_steps} ppermute steps, {len(sched.moves)} moves, "
          f"ring-equal wire bytes ({sched.wire_bytes() / 2 ** 10:.0f} KiB); "
          f"synthesized_collective(x, sched, group) executes it on each "
          f"rank")

    print("=" * 72)
    print("[4] CCL: algorithm selection per payload, AlphaBeta vs FlowSim")
    ab = AlphaBeta.from_topology(topo)
    fsim = FlowSim(topo)
    group = tuple(topo.accelerators)
    for size in (2 ** 12, 2 ** 20, 2 ** 28):
        task = CommTask("ar", "all_reduce", size, group)
        sa = select_for_task(task, ab)
        sf = select_for_task(task, fsim)
        print(f"    all_reduce {size:>12,d} B -> closed-form "
              f"{sa.algorithm:14s} ({sa.cost*1e6:9.1f} us) | topology-sim "
              f"{sf.algorithm:14s} ({sf.cost*1e6:9.1f} us)")
    task = CommTask("ag", "all_gather", 2 ** 22, group)
    ring_t = simulate_flowset(topo, generate_flows(task, "ring"))
    syn = synthesize(topo, task, Sketch(max_hops=4))
    print(f"    TACCL-style synthesis on DGXx2 all-gather: ring "
          f"{ring_t*1e3:.2f} ms -> synthesized {syn.makespan*1e3:.2f} ms "
          f"({ring_t/syn.makespan:.2f}x)")

    print("=" * 72)
    print("[5] Flow scheduler (horizontal): two jobs on one link (CASSINI)")
    jobs = [JobProfile("jobA", 0.012, 0.008), JobProfile("jobB", 0.010, 0.010)]
    phases, base, best = stagger_jobs(jobs, grid=6)
    for j in jobs:
        print(f"    {j.name}: unstaggered {base[j.name]*1e3:6.2f} ms/iter"
              f" -> staggered {best[j.name]*1e3:6.2f} ms/iter "
              f"(period {j.period*1e3:.0f} ms)")

    print("    --- plan_cluster: the same idea on real CodesignReports ---")
    # (spelled out for the walkthrough; the canonical copy of this scenario
    # is benchmarks.paper_claims._contended_cluster, asserted in CI)
    small = get_config("qwen2-0.5b")
    ctopo = fat_tree(num_hosts=4, gpus_per_host=2, hosts_per_rack=2,
                     nic_bw=2e9, agg_bw=8e9, oversub=4.0, pcie_bw=4e9)
    dp4 = MeshConfig(shape=(4,), axis_names=("data",), data_axes=("data",),
                     model_axes=())
    dpp = DemandParams(zero1=False)
    crep = plan_cluster(
        [JobSpec("tenantA", small, shape, dp4,
                 devices=ctopo.hosts[0] + ctopo.hosts[2], dp_params=dpp),
         # a JobSpec can carry a full CodesignProblem instead of flat knobs
         JobSpec("tenantB", devices=ctopo.hosts[1] + ctopo.hosts[3],
                 problem=CodesignProblem(small, shape, dp4, ctopo,
                                         dp_params=dpp))],
        ctopo, grid=6)
    print(f"    two DP-4 tenants straddling both racks of {ctopo.name}: "
          f"{len(crep.contended)} contended links")
    for (u, v), users in list(crep.contended.items())[:2]:
        share = ", ".join(f"{j} {b/2**30:.2f} GiB" for j, b in users.items())
        print(f"      {u!s:>6s} -> {v!s:<6s} {share}")
    for name in crep.solo_jct:
        print(f"    {name}: solo {crep.solo_jct[name]:6.3f}s | naive "
              f"{crep.naive_jct[name]:6.3f}s | staggered "
              f"{crep.staggered_jct[name]:6.3f}s "
              f"(phase +{crep.phases[name]*1e3:.0f} ms)")
    print(f"    worst-case stretch {crep.naive_worst_stretch:.4f} -> "
          f"{crep.staggered_worst_stretch:.4f} "
          f"({crep.stagger_speedup:.3f}x recovered)")

    print("=" * 72)
    print("[6] Network: same ring all-reduce, different fabrics")
    n = 256
    t = CommTask("ar", "all_reduce", 256 * 2 ** 20, tuple(range(n)))
    fs = generate_flows(t, "ring")
    for name, topo2 in (("torus 16x16 (TPU pod)", torus2d(16, 16)),
                        ("fat-tree 8x oversub",
                         fat_tree(n // 8, oversub=8.0))):
        print(f"    {name:24s} {simulate_flowset(topo2, fs)*1e3:8.2f} ms")
    print("=" * 72)


if __name__ == "__main__":
    main()
