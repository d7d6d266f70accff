"""Twin of tests/test_synth.py and of the synthesis half of
tests/test_ccl.py: the port's TACCL-style synthesizer
(``repro_torch.ccl.synth``) against the JAX package's, move for move, on
``ring(8)``, ``full_mesh(8)``, ``fat_tree(2, 4)`` and
``dgx_cluster(2, 4)`` (and the JAX tests' own fabrics), for every
primitive it synthesizes, with sketches, hot-spot penalties, the solver
cache's counters and the selection of synthesized candidates under both
cost models.  The schedule invariants of tests/test_synth.py run on the
port's schedules.

The link to the executables: on 4 gloo CPU ranks the port's
``synthesized_collective`` runs the port's schedule and the reference's
(copied field by field) for each topology, and the two results are
bit-equal, ``bits=8`` included; each rank's wire bytes are its moves out.

The plan/search cases of tests/test_synth.py drive ``codesign`` (not
ported yet) and have no twin here."""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.ccl.select import AlphaBeta, FlowSim, select_for_task
from repro_torch.ccl.synth import (Move, Sketch, SynthCache, SynthSchedule,
                                   atp_schedule, sketch_from_hotspots,
                                   synthesize, synthesize_schedule,
                                   synthesized_time, topology_fingerprint)
from repro_torch.core.demand import CommTask
from repro_torch.core.knobs import Fixed
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.net.simulate import link_utilization
from repro_torch.net.topology import dgx_cluster, fat_tree, full_mesh, ring
from torch_ccl_ranks import synth_sent_bytes
from torch_twin import REF, canon, same, twin

TOPOS = {
    "ring8": lambda t: t.ring(8),
    "mesh8": lambda t: t.full_mesh(8),
    "fattree": lambda t: t.fat_tree(2, 8, oversub=8.0, hosts_per_rack=1),
    "dgx2": lambda t: t.dgx_cluster(2),
}
# the fabrics the executables run the port's schedules on
LOWERED = {
    "ring8": lambda t: t.ring(8),
    "mesh8": lambda t: t.full_mesh(8),
    "fattree2x4": lambda t: t.fat_tree(2, 4),
    "dgx2x4": lambda t: t.dgx_cluster(2, 4),
}
PRIMS = ["all_reduce", "all_gather", "broadcast", "all_to_all"]


def _topo(name):
    import repro_torch.net.topology as t
    return {**TOPOS, **LOWERED}[name](t)


def _task(topo, primitive, size):
    return CommTask("t", primitive, size, tuple(topo.accelerators))


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prim", PRIMS)
@pytest.mark.parametrize("topo", sorted({**TOPOS, **LOWERED}))
def test_synthesize_schedule_equals_reference(topo, prim):
    """The same move list, step for step, at three payload sizes and on
    the whole fabric and a strided half of it; the FlowSet view
    (``synthesize``, ``to_flowset`` with a wire ratio) and the
    ``rescaled`` copy are equal too."""
    def build(pkg):
        t = {**TOPOS, **LOWERED}[topo](pkg.net.topology)
        out = []
        for group in (tuple(t.accelerators), tuple(t.accelerators[::2])):
            for size in (1, 3000, 5 << 20):
                task = pkg.core.demand.CommTask("t", prim, size, group,
                                                job_id="j")
                s = pkg.ccl.synth.synthesize_schedule(t, task)
                out += [s, s.wire_bytes(), s.rescaled(size * 3 + 1),
                        s.to_flowset(wire_ratio=0.25,
                                     algorithm="synthesized+q8"),
                        pkg.ccl.synth.synthesize(t, task)]
        return out
    same(build)


@pytest.mark.parametrize("topo", sorted(LOWERED))
def test_sketches_equal_reference(topo):
    """Sketch constraints (allowed links in one orientation, hop bounds,
    no rotational symmetry) and hot-spot penalties from a placement's
    link map change the routes in the same way on both sides; so do the
    predicted time and the fingerprints."""
    def build(pkg):
        t = LOWERED[topo](pkg.net.topology)
        sy = pkg.ccl.synth
        g = tuple(t.accelerators)
        ar = pkg.core.demand.CommTask("t", "all_reduce", 1 << 20, g)
        bc = pkg.core.demand.CommTask("b", "broadcast", 1 << 18, g)
        busy = pkg.net.simulate.link_utilization(
            t, pkg.ccl.algorithms.generate_flows(ar, "ring"))
        one_way = {(u, v) for u, v, _ in t.links() if str(u) < str(v)}
        sketches = [sy.Sketch(), sy.Sketch(rotational_symmetry=False),
                    sy.Sketch(max_hops=2),
                    sy.Sketch(allowed_links=one_way),
                    sy.sketch_from_hotspots(t, busy),
                    sy.sketch_from_hotspots(t, busy, scale=3.0, max_hops=4)]
        out = [sketches[4], sy.topology_fingerprint(t)]
        for sk in sketches:
            for task in (ar, bc):
                out.append(sy.synthesize_schedule(t, task, sk))
                out.append(sy._sketch_key(sk))
            out.append(sy.synthesized_time(t, bc, sk))
        return out
    same(build)


def test_synth_cache_counters_equal_reference():
    """The cache's keys, hits, misses, rescaled hits and ``cache_stats``
    over the same request stream."""
    def run(pkg):
        cache = pkg.ccl.synth.SynthCache()
        out = []
        for name in ("mesh8", "ring8", "mesh8"):
            t = TOPOS[name](pkg.net.topology)
            g = tuple(t.accelerators)
            for i, size in enumerate((1 << 20, (1 << 20) + (1 << 19),
                                      1 << 22)):
                for prim in ("all_reduce", "broadcast"):
                    task = pkg.core.demand.CommTask(f"t{i}", prim, size, g)
                    out.append(cache.schedule(t, task))
            out.append(cache.schedule(t, task,
                                      pkg.ccl.synth.Sketch(max_hops=2)))
        out.append(cache.cache_stats())
        return out
    same(run)


@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_synthesized_selection_equals_reference(topo):
    """Synthesized and synthesized+q8 extras priced beside the registry
    under ``AlphaBeta`` and ``FlowSim``, with and without an error budget
    and under a ``Fixed`` force."""
    def run(pkg):
        t = TOPOS[topo](pkg.net.topology)
        sel = pkg.ccl.select
        out = []
        for size in (112 << 10, 8 << 20):
            task = pkg.core.demand.CommTask("t", "all_reduce", size,
                                            tuple(t.accelerators))
            s = pkg.ccl.synth.synthesize_schedule(t, task)
            extras = {"synthesized": s.to_flowset(job_id=task.job_id),
                      "synthesized+q8": s.to_flowset(
                          job_id=task.job_id, wire_ratio=0.25,
                          algorithm="synthesized+q8")}
            for m in (sel.AlphaBeta.from_topology(t), sel.FlowSim(t)):
                out.append(sel.select_for_task(task, m,
                                               extra_flowsets=extras))
                out.append(sel.select_for_task(task, m, error_budget=0.01,
                                               extra_flowsets=extras))
                out.append(sel.select_for_task(
                    task, m, constraint=pkg.core.knobs.Fixed("synthesized"),
                    extra_flowsets=extras))
        return out
    same(run)


def test_atp_schedule_and_defaults_equal_reference():
    def build(pkg):
        task = pkg.core.demand.CommTask("t", "all_reduce", 4096,
                                        tuple(range(8)))
        sy = pkg.ccl.synth
        return ([sy.atp_schedule(task), sy.atp_schedule(task, 5)],
                sy.SYNTHESIZABLE, sy.Sketch(), sy._size_bucket(3 << 20),
                sorted(sy.DEFAULT_SYNTH_CACHE.cache_stats()))
    same(build)


# ---------------------------------------------------------------------------
# the schedule invariants of tests/test_synth.py on the port
# ---------------------------------------------------------------------------


@given(st.sampled_from(sorted(TOPOS)), st.integers(10, 24))
@settings(max_examples=16, deadline=None)
def test_all_reduce_wire_bytes_are_ring_equal(topo_name, log_size):
    topo = _topo(topo_name)
    task = _task(topo, "all_reduce", 1 << log_size)
    p = len(task.group)
    s = synthesize_schedule(topo, task)
    assert s.chunk_bytes == max(task.size_bytes // p, 1)
    assert len(s.moves) == 2 * p * (p - 1)
    assert s.wire_bytes() == 2 * p * (p - 1) * s.chunk_bytes


@given(st.sampled_from(sorted(TOPOS)),
       st.sampled_from(["broadcast", "all_gather"]), st.integers(10, 24))
@settings(max_examples=16, deadline=None)
def test_gather_like_wire_bytes_match_bulk(topo_name, primitive, log_size):
    topo = _topo(topo_name)
    task = _task(topo, primitive, 1 << log_size)
    p = len(task.group)
    s = synthesize_schedule(topo, task)
    n_demands = (p - 1) if primitive == "broadcast" else p * (p - 1)
    assert len(s.moves) == n_demands
    assert s.wire_bytes() == n_demands * s.chunk_bytes


def _replay(schedule):
    """tests/test_synth.py's strict-step replay: rank -> chunk -> the set
    of contributions it holds."""
    group = schedule.group
    state = {r: {} for r in group}
    if schedule.primitive == "all_reduce":
        for r in group:
            for c in range(schedule.num_chunks):
                state[r][c] = frozenset([r])
    elif schedule.primitive == "broadcast":
        state[group[0]][0] = frozenset([group[0]])
    else:
        for c, r in enumerate(group):
            state[r][c] = frozenset([r])
    by_step = {}
    for m in schedule.moves:
        by_step.setdefault(m.step, []).append(m)
    for step in sorted(by_step):
        pre = {r: dict(cs) for r, cs in state.items()}
        for m in by_step[step]:
            src_val = pre[m.src].get(m.chunk)
            assert src_val is not None, \
                f"step {step}: {m.src} forwards chunk {m.chunk} it does " \
                f"not hold (same-step forwarding?)"
            if m.reduce:
                state[m.dst][m.chunk] = \
                    state[m.dst].get(m.chunk, frozenset()) | src_val
            else:
                state[m.dst][m.chunk] = src_val
    return state


@given(st.sampled_from(sorted({**TOPOS, **LOWERED})),
       st.sampled_from(["all_reduce", "broadcast", "all_gather"]))
@settings(max_examples=16, deadline=None)
def test_replay_delivers_everything(topo_name, primitive):
    topo = _topo(topo_name)
    s = synthesize_schedule(topo, _task(topo, primitive, 1 << 18))
    state = _replay(s)
    everyone = frozenset(s.group)
    for r in s.group:
        for c in range(s.num_chunks):
            assert c in state[r], f"rank {r} missing chunk {c}"
            if primitive == "all_reduce":
                assert state[r][c] == everyone


@given(st.sampled_from(sorted({**TOPOS, **LOWERED})),
       st.sampled_from(["all_reduce", "broadcast", "all_gather"]))
@settings(max_examples=16, deadline=None)
def test_per_step_moves_use_disjoint_directed_links(topo_name, primitive):
    topo = _topo(topo_name)
    s = synthesize_schedule(topo, _task(topo, primitive, 1 << 18))
    by_step = {}
    for m in s.moves:
        by_step.setdefault(m.step, []).append(m)
    for step, moves in by_step.items():
        seen = set()
        for m in moves:
            if m.reduce:
                path = [(b, a) for a, b in
                        reversed(list(topo.path_links(m.dst, m.src)))]
            else:
                path = list(topo.path_links(m.src, m.dst))
            for link in path:
                assert link not in seen, \
                    f"step {step}: directed link {link} carries two moves"
                seen.add(link)


def test_all_reduce_reduce_phase_mirrors_fanout():
    topo = _topo("fattree")
    s = synthesize_schedule(topo, _task(topo, "all_reduce", 1 << 18))
    span = s.num_steps // 2
    fanout = {(m.chunk, m.src, m.dst, m.step - span)
              for m in s.moves if not m.reduce}
    mirrored = {(m.chunk, m.dst, m.src, span - 1 - m.step)
                for m in s.moves if m.reduce}
    assert fanout == mirrored
    assert all(m.step < span for m in s.moves if m.reduce)


def test_atp_schedule_replays_exactly():
    topo = full_mesh(8)
    task = _task(topo, "all_reduce", 1 << 16)
    s = atp_schedule(task)
    assert s.num_steps == 2 and s.num_chunks == 1
    assert s.wire_bytes() == 2 * (len(task.group) - 1) * task.size_bytes
    state = _replay(s)
    everyone = frozenset(task.group)
    assert all(state[r][0] == everyone for r in task.group)


def test_synth_cache_hits_within_size_bucket_and_rescales():
    cache = SynthCache()
    topo = full_mesh(8)
    s1 = cache.schedule(topo, _task(topo, "all_reduce", 1 << 20))
    stats = cache.cache_stats()
    assert stats["synth.miss"] == 1 and "synth.hit" not in stats
    assert stats["synth.entries"] == 1
    t2 = CommTask("t2", "all_reduce", (1 << 20) + (1 << 19),
                  tuple(topo.accelerators))
    s2 = cache.schedule(topo, t2)
    stats = cache.cache_stats()
    assert stats["synth.hit"] == 1 and stats["synth.entries"] == 1
    assert stats["synth.hit_rate"] == 0.5
    assert s2.task_id == "t2" and s2.size_bytes == t2.size_bytes
    assert [(m.chunk, m.src, m.dst, m.step) for m in s2.moves] == \
        [(m.chunk, m.src, m.dst, m.step) for m in s1.moves]
    assert s2.wire_bytes() == len(s2.moves) * s2.chunk_bytes
    cache.schedule(topo, _task(topo, "all_reduce", 1 << 20),
                   Sketch(max_hops=2))
    assert cache.cache_stats()["synth.entries"] == 2


def test_topology_fingerprint_is_wiring_identity():
    assert topology_fingerprint(ring(8)) == topology_fingerprint(ring(8))
    assert topology_fingerprint(ring(8)) != topology_fingerprint(ring(6))
    topo = fat_tree(2, 8, oversub=8.0, hosts_per_rack=1)
    u, v, _ = next(iter(topo.links()))
    assert topology_fingerprint(topo.without_link(u, v)) != \
        topology_fingerprint(topo)
    cache = SynthCache()
    cache.schedule(ring(8), _task(ring(8), "broadcast", 1 << 16))
    cache.schedule(ring(8), _task(ring(8), "broadcast", 1 << 16))
    assert cache.cache_stats()["synth.hit"] == 1


def _extras(topo, task, wire_ratio=None):
    s = synthesize_schedule(topo, task)
    out = {"synthesized": s.to_flowset(job_id=task.job_id)}
    if wire_ratio is not None:
        out["synthesized+q8"] = s.to_flowset(
            job_id=task.job_id, wire_ratio=wire_ratio,
            algorithm="synthesized+q8")
    return out


def test_synthesized_priced_under_both_models_and_wins_latency_regime():
    topo = full_mesh(8)
    task = _task(topo, "all_reduce", 112 << 10)
    for model in (AlphaBeta.from_topology(topo), FlowSim(topo)):
        sel = select_for_task(task, model, extra_flowsets=_extras(topo, task))
        assert sel.algorithm == "synthesized", type(model).__name__
        reg = min(v for k, v in sel.costs.items() if k != "synthesized")
        assert sel.costs["synthesized"] < reg


def test_synthesized_never_selected_where_registry_matches_fabric():
    topo = ring(8)
    task = _task(topo, "all_reduce", 8 << 20)
    for model in (AlphaBeta.from_topology(topo), FlowSim(topo)):
        sel = select_for_task(task, model, extra_flowsets=_extras(topo, task))
        assert sel.algorithm != "synthesized", type(model).__name__
        assert "synthesized" in sel.costs


def test_synthesized_q8_faces_error_budget_and_whitelists():
    topo = fat_tree(2, 8, oversub=8.0, hosts_per_rack=1)
    task = _task(topo, "all_reduce", 8 << 20)
    model = FlowSim(topo)
    extras = _extras(topo, task, wire_ratio=0.25)
    zero = select_for_task(task, model, extra_flowsets=extras)
    assert "synthesized+q8" in zero.excluded
    budget = select_for_task(task, model, error_budget=0.01,
                             extra_flowsets=extras)
    assert "synthesized+q8" in budget.costs
    assert budget.costs["synthesized+q8"] < budget.costs["synthesized"]
    forced = select_for_task(task, model, constraint=Fixed("synthesized"),
                             extra_flowsets=extras)
    assert forced.algorithm == "synthesized"
    assert list(forced.costs) == ["synthesized"]


# ---------------------------------------------------------------------------
# the synthesis tests of tests/test_ccl.py on the port
# ---------------------------------------------------------------------------


def _delivered(task, fs):
    if task.primitive == "all_gather":
        chunks = {ci: {task.group[ci]} for ci in range(len(task.group))}
    elif task.primitive == "broadcast":
        chunks = {0: {task.group[0]}}
    else:
        return True
    for f in fs.flows:
        for ci, holders in chunks.items():
            if f.src in holders:
                holders.add(f.dst)
    need_all = set(task.group)
    return all(holders >= need_all for holders in chunks.values())


@pytest.mark.parametrize("prim", ["all_gather", "broadcast"])
def test_synthesis_delivers_on_dgx(prim):
    topo = dgx_cluster(2)
    task = CommTask("syn", prim, 2 ** 20, tuple(topo.accelerators))
    fs = synthesize(topo, task)
    assert fs.flows and _delivered(task, fs)


def test_synthesis_respects_sketch_links():
    topo = ring(8)
    allowed = {(u, v) for u, v, _ in topo.links()}
    task = CommTask("syn", "broadcast", 2 ** 20, tuple(range(8)))
    fs = synthesize(topo, task, Sketch(allowed_links=allowed, max_hops=3))
    assert fs.flows and _delivered(task, fs)
    for f in fs.flows:
        assert len(topo.path_links(f.src, f.dst)) <= 3


def test_synthesis_steps_encode_concurrency():
    p = 8
    topo = ring(p)
    task = CommTask("syn", "broadcast", 2 ** 20, tuple(range(p)))
    fs = synthesize(topo, task)
    assert _delivered(task, fs)
    assert len(fs.flows) == p - 1
    assert fs.num_steps < len(fs.flows)
    per_step = {}
    for f in fs.flows:
        per_step[f.step] = per_step.get(f.step, 0) + 1
    assert max(per_step.values()) > 1
    have_step = {task.group[0]: -1}
    for f in sorted(fs.flows, key=lambda f: f.step):
        assert f.src in have_step and have_step[f.src] < f.step
        have_step[f.dst] = min(have_step.get(f.dst, f.step), f.step)


def test_synthesis_asymmetric_sketch_reverse_edge():
    p = 6
    topo = ring(p)
    allowed = {(u, v) for u, v, _ in topo.links() if u < v}
    task = CommTask("syn", "broadcast", 2 ** 18, tuple(range(p)))
    fs = synthesize(topo, task, Sketch(allowed_links=allowed))
    assert fs.flows and _delivered(task, fs)
    util = link_utilization(topo, fs)
    assert any(u > v and b > 0 for (u, v), b in util.items())


def test_sketch_from_hotspots_penalises_busy_links():
    topo = full_mesh(4)
    sk = sketch_from_hotspots(topo, {(0, 1): 50e9, (1, 0): 0.0,
                                     ("x", 0): 1.0})
    assert sk.link_penalty == {(0, 1): 1.0}
    assert synthesized_time(topo, _task(topo, "broadcast", 1 << 20)) > 0


# ---------------------------------------------------------------------------
# the executables: 4 gloo CPU ranks, the port's schedules vs the reference's
# ---------------------------------------------------------------------------

RANKS = 4
LOWER_CASES = [(topo, kind) for topo in sorted(LOWERED)
               for kind in ("synth", "synth_q8", "gather", "bcast")]


def _lower_task(pkg, topo_name, kind, nbytes):
    t = LOWERED[topo_name](pkg.net.topology)
    prim = {"gather": "all_gather", "bcast": "broadcast"}.get(kind,
                                                               "all_reduce")
    size = nbytes // RANKS if prim == "broadcast" else nbytes
    task = pkg.core.demand.CommTask("t", prim, size,
                                    tuple(t.accelerators[::2]))
    return pkg.ccl.synth.synthesize_schedule(t, task)


def _port_copy(s) -> SynthSchedule:
    d = dataclasses.asdict(s)
    d["moves"] = [Move(**m) for m in d["moves"]]
    return SynthSchedule(**d)


@pytest.fixture(scope="module")
def lowered(tmp_path_factory):
    """Each case once on 4 gloo ranks, with the port's schedule and with
    the reference's: ``{(topo, kind, side): [(result, sent) per rank]}``,
    plus the inputs and the two packages' schedules."""
    tmp = tmp_path_factory.mktemp("synth")
    # integer-valued floats: f32 sums are exact
    x = np.arange(RANKS * 48, dtype=np.float32).reshape(RANKS, 48) - 70.0
    nbytes = x[0].nbytes * RANKS
    data, scheds, both = {}, {}, {}
    for topo, kind in LOWER_CASES:
        ref, port = twin(lambda pkg: _lower_task(pkg, topo, kind, nbytes))
        both[(topo, kind)] = (ref, port)
        for side, s in (("port", port), ("ref", _port_copy(ref))):
            label = f"{side}-{topo}-{kind}"
            scheds[label] = s
            lowered_kind = "synth" if kind == "bcast" else kind
            data[f"{lowered_kind}|{label}|float32"] = x
    np.savez(tmp / "inputs.npz", **data)
    ranks = spawn_ranks(synth_sent_bytes, RANKS, str(tmp / "inputs.npz"),
                        scheds, timeout_s=300)
    out = {}
    for key in data:
        side, topo, kind = key.split("|")[1].split("-")
        out[(topo, kind, side)] = [r[key] for r in ranks]
    return x, out, both


@pytest.mark.parametrize("topo,kind", LOWER_CASES, ids=lambda v: str(v))
def test_port_schedule_lowers_bit_equal_to_reference(lowered, topo, kind):
    """The port's schedule equals the reference's move for move, and the
    port's executable gives the same bits on both (``synth_q8``: K2a/K2b's
    plain versions in the send loop); lossless cases are the exact
    collective; every rank sent exactly its moves out (the q8 wire: one
    int8 code a value and one f32 scale a move)."""
    x, out, both = lowered
    ref_sched, port_sched = both[(topo, kind)]
    assert canon(port_sched) == canon(ref_sched)
    got, want = out[(topo, kind, "port")], out[(topo, kind, "ref")]
    for r in range(RANKS):
        np.testing.assert_array_equal(got[r][0], want[r][0])
        assert got[r][1] == want[r][1]
    exact = {"synth": np.broadcast_to(x.sum(0), x.shape),
             "bcast": np.broadcast_to(x[0], x.shape),
             "gather": np.broadcast_to(x[None], (RANKS,) + x.shape)}
    results = np.stack([g[0] for g in got])
    if kind in exact:
        np.testing.assert_array_equal(results, exact[kind])
    else:
        tol = 2 * RANKS * float(np.abs(x.sum(0)).max()) / 127
        assert np.abs(results - x.sum(0)).max() <= tol
    clen = x[0].size // port_sched.num_chunks \
        if kind in ("synth", "synth_q8") else x[0].size
    per_move = clen + 4 if kind == "synth_q8" else 4 * clen
    for r in range(RANKS):
        dev = port_sched.group[r]
        moves_out = sum(1 for m in port_sched.moves if m.src == dev)
        assert got[r][1] == moves_out * per_move, (r, got[r][1])


def test_reference_schedules_are_plain_data():
    """What crosses to the ranks is plain data: the reference's schedule
    copied into the port's types equals the port's own."""
    t_ref, t_port = twin(lambda pkg: pkg.net.topology.dgx_cluster(2, 4))
    s = REF.ccl.synth.synthesize_schedule(
        t_ref, REF.core.demand.CommTask("t", "all_reduce", 4096,
                                        (0, 2, 4, 6)))
    mine = synthesize_schedule(t_port, CommTask("t", "all_reduce", 4096,
                                                (0, 2, 4, 6)))
    assert _port_copy(s) == mine
