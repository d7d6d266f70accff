"""TACCL-style sketch-guided collective synthesis (paper Sec. III-B, [5]).

Full synthesis is an NP-hard MILP (SCCL); TACCL's insight is that human
*communication sketches* (logical topology, switch hyper-edges, symmetry)
shrink the search to tractable size.  We reproduce that structure with a
greedy earliest-finish list scheduler over chunk-transfer moves:

  * the collective is a demand set: (chunk, src, dst) triples — plus, for
    All-Reduce, a reduce phase where every rank's *contribution* to a
    chunk must reach the chunk's owner before the reduced chunk fans out;
  * a ``Sketch`` restricts which links may carry chunks, how data routes
    through intermediate hops (e.g. "enter a host through GPU 0"), and —
    the plan-space hook — carries per-link *penalties* derived from a
    placement's hot-spot map, biasing chunk routes off contended uplinks;
  * chunks are scheduled along sketch-allowed shortest paths, tracking
    each link's busy time; ties broken by symmetry (rotated chunk order).

Output is a :class:`SynthSchedule` — an explicit move list that (a)
flattens to a step-indexed ``FlowSet`` both cost models price against the
registered ring/tree algorithms (``ccl.select``), and (b) lowers to an
executable ``torch.distributed`` program
(``ccl.primitives.synthesized_collective``).
:class:`SynthCache` memoizes solver runs per (topology fingerprint,
primitive, group, size bucket, sketch) so repeated ``search()`` candidates
and ``ClusterDynamics`` re-plans re-use schedules, with ``cache_stats()``
telemetry like ``FlowSim``'s.

The port's copy of ``repro.ccl.synth``, kept line for line: importing any
``repro`` module runs the JAX package's ``__init__``, which imports jax, so
the port keeps its own.
"""
from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

import networkx as nx

from repro_torch.core.demand import CommTask, Flow, FlowSet
from repro_torch.net.topology import Topology
from repro_torch.obs.meters import Meters

# primitives the synthesizer can produce schedules for
SYNTHESIZABLE = ("all_reduce", "all_gather", "broadcast", "all_to_all")


@dataclass(frozen=True)
class Sketch:
    """Designer hints that constrain the synthesis search space.

    ``allowed_links`` names *physical* links: permission is
    orientation-free, so listing ``(u, v)`` also admits ``(v, u)`` when
    the topology has the reverse edge (an asymmetric sketch used to
    KeyError when a shortest path traversed a link against its listed
    orientation).

    ``link_penalty`` maps a directed link to extra seconds charged per
    traversal *when choosing routes* (actual link occupancy stays
    physical): the TACCL-style soft constraint ``sketch_from_hotspots``
    builds from a placement's hot-spot map, steering chunks off links
    other traffic already contends on."""

    allowed_links: Optional[Set[Tuple]] = None   # None = all
    entry_nodes: Optional[Dict[str, int]] = None  # host tag -> preferred gpu
    rotational_symmetry: bool = True
    max_hops: int = 6
    link_penalty: Optional[Mapping[Tuple, float]] = None


def sketch_from_hotspots(topo: Topology,
                         util: Mapping[Tuple, float],
                         scale: float = 1.0,
                         max_hops: int = 6) -> Sketch:
    """A sketch whose link penalties are the seconds each link is already
    busy with *other* traffic (``bytes / bw``, scaled) — the codesign
    layer hands its per-link byte map here so synthesis routes the hot
    task's chunks around the links the rest of the plan contends on."""
    penalty: Dict[Tuple, float] = {}
    for (u, v), nbytes in util.items():
        if nbytes > 0 and topo.graph.has_edge(u, v):
            penalty[(u, v)] = scale * nbytes / topo.graph[u][v]["bw"]
    return Sketch(max_hops=max_hops, link_penalty=penalty or None)


@dataclass(frozen=True)
class Move:
    """One chunk transfer of a synthesized schedule: endpoint-level
    (``src`` holds the chunk, the fabric routes it), step-indexed for
    concurrency.  ``reduce`` marks a contribution being accumulated into
    the destination's chunk slot (All-Reduce reduce phase / in-switch
    aggregation analogue); gather moves overwrite."""

    chunk: int
    src: int
    dst: int
    step: int
    size_bytes: int
    reduce: bool = False


@dataclass
class SynthSchedule:
    """A synthesized collective as an explicit move list.

    ``num_chunks`` is the number of buffer slots the executable lowering
    needs per rank (= chunks the payload is split into).  ``moves`` are in
    list-scheduler emission order; within a step, earlier moves may feed
    later sub-batches of the same step only through *reduce*
    accumulation (never forwarding — the wave assignment guarantees a
    chunk received at step ``s`` is forwarded at step ``> s``)."""

    task_id: str
    primitive: str
    group: Tuple[int, ...]
    size_bytes: int
    chunk_bytes: int
    num_chunks: int
    moves: List[Move] = field(default_factory=list)
    num_steps: int = 0
    makespan: float = 0.0
    algorithm: str = "synthesized"

    def to_flowset(self, task_id: Optional[str] = None,
                   job_id: str = "job0", wire_ratio: float = 1.0,
                   algorithm: Optional[str] = None) -> FlowSet:
        """The move list as the step-indexed FlowSet the cost models
        price.  ``wire_ratio`` scales each flow's wire bytes for
        compressed variants (``synthesized+q8``)."""
        tid = task_id if task_id is not None else self.task_id
        fs = FlowSet(task_id=tid, algorithm=algorithm or self.algorithm)
        for m in self.moves:
            nbytes = max(int(m.size_bytes * wire_ratio), 1)
            fs.flows.append(Flow(m.src, m.dst, nbytes, tid, m.step, job_id))
        fs.num_steps = self.num_steps
        fs.makespan = self.makespan
        return fs

    def rescaled(self, size_bytes: int) -> "SynthSchedule":
        """The same routing structure at a different payload size (the
        cache's size-bucket hit path).  Move bytes scale exactly; the
        recorded makespan scales linearly — an approximation (latency
        terms don't scale), fine because pricing re-simulates the
        flowset and never reads ``makespan``."""
        if size_bytes == self.size_bytes:
            return self
        ratio = size_bytes / max(self.size_bytes, 1)
        chunk = max(int(round(self.chunk_bytes * ratio)), 1)
        moves = [dataclasses.replace(
                     m, size_bytes=max(int(round(m.size_bytes * ratio)), 1))
                 for m in self.moves]
        return dataclasses.replace(
            self, size_bytes=size_bytes, chunk_bytes=chunk, moves=moves,
            makespan=self.makespan * ratio)

    def wire_bytes(self) -> int:
        return sum(m.size_bytes for m in self.moves)


@dataclass(order=True)
class _Move:  # retained for backward import compatibility
    ready: float
    chunk: int = field(compare=False)
    at: int = field(compare=False)


def _demands_for(task: CommTask) -> List[Tuple[int, int, int]]:
    """(chunk_id, src, dst) triples for the collective."""
    g = list(task.group)
    p = len(g)
    out = []
    if task.primitive == "all_gather":
        for ci, src in enumerate(g):
            for dst in g:
                if dst != src:
                    out.append((ci, src, dst))
    elif task.primitive == "broadcast":
        for dst in g[1:]:
            out.append((0, g[0], dst))
    elif task.primitive == "all_to_all":
        cid = 0
        for src in g:
            for dst in g:
                if dst != src:
                    out.append((cid, src, dst))
                    cid += 1
    else:
        raise KeyError(f"synthesis supports AR/AG/bcast/A2A, not "
                       f"{task.primitive}")
    return out


def _sketch_graph(topo: Topology, sketch: Sketch):
    graph = topo.graph
    if sketch.allowed_links is not None:
        # sketches name physical links; admit both orientations that
        # exist so paths may traverse a listed link in reverse
        allowed = set()
        for u, v in sketch.allowed_links:
            for a, b in ((u, v), (v, u)):
                if topo.graph.has_edge(a, b):
                    allowed.add((a, b))
        graph = graph.edge_subgraph(allowed).copy()
    return graph


class _Router:
    """Greedy earliest-finish chunk router: shared link-occupancy clock,
    concurrency-wave step assignment, hot-link penalties for route
    *choice* (physical times stay unpenalized)."""

    def __init__(self, graph, chunk_bytes: int, sketch: Sketch):
        self.graph = graph
        self.sketch = sketch
        self.chunk_bytes = chunk_bytes
        self.tx = {(u, v): chunk_bytes / d["bw"] + d["lat"]
                   for u, v, d in graph.edges(data=True)}
        self.penalty = dict(sketch.link_penalty or {})
        self.link_free: Dict[Tuple, float] = {}
        # concurrency waves: transfers that share no link and whose chunk
        # is already in place run in the same step, so FlowSim prices the
        # greedy list schedule's real overlap, not a serialized chain.
        # Each link tracks the exact set of waves it is busy in, so a move
        # takes the *smallest* causally-valid wave free on every link of
        # its path (bumping a single max counter wasted waves badly on
        # star-shaped host fabrics, where a GPU's one ingress link is the
        # p-1 lower bound every schedule shares).
        self.link_used: Dict[Tuple, Set[int]] = {}
        self.chunk_wave: Dict[Tuple[int, int], int] = {}
        self.moves: List[Move] = []
        if self.penalty:
            pen = self.penalty

            def weight(u, v, d):
                return d["lat"] + pen.get((u, v), 0.0)

            self._weight = weight
        else:
            self._weight = "lat"

    def best_route(self, have: Mapping[int, float], dst):
        """Cheapest (finish time + penalty) source/path for reaching
        ``dst`` from any current holder; None when unreachable.

        Ties prefer the *newest* copy: freshly-delivered holders have idle
        egress links, so equal-finish choices spread sends across holders
        — a doubling tree (log-depth fan-out) instead of a star chained on
        the root's one egress link."""
        best = None
        holders = sorted(have.items(), key=lambda kv: kv[1], reverse=True)
        for holder, t_avail in holders:
            try:
                path = nx.shortest_path(self.graph, holder, dst,
                                        weight=self._weight)
            except nx.NetworkXNoPath:
                continue
            if len(path) - 1 > self.sketch.max_hops:
                continue
            # simulate link occupancy along the path
            t = t_avail
            pen = 0.0
            for u, v in zip(path[:-1], path[1:]):
                start = max(t, self.link_free.get((u, v), 0.0))
                t = start + self.tx[(u, v)]
                pen += self.penalty.get((u, v), 0.0)
            if best is None or t + pen < best[0]:
                best = (t + pen, t, holder, path)
        return best

    def commit(self, chunk: int, holder, dst, path, t_avail: float,
               reduce: bool = False, min_step: int = 0) -> Tuple[float, int]:
        """Occupy the path's links, assign the move's concurrency wave,
        and record the move.  Returns (arrival time, step)."""
        path_links = list(zip(path[:-1], path[1:]))
        # the move's wave: after the chunk reached the holder, in the
        # first wave no link of its path already carries another move
        step = max(self.chunk_wave.get((chunk, holder), 0), min_step)
        used = [self.link_used.setdefault(link, set())
                for link in path_links]
        while any(step in u for u in used):
            step += 1
        t = t_avail
        for (u, v), waves in zip(path_links, used):
            start = max(t, self.link_free.get((u, v), 0.0))
            t = start + self.tx[(u, v)]
            self.link_free[(u, v)] = t
            waves.add(step)
        self.chunk_wave[(chunk, dst)] = step + 1
        self.moves.append(Move(chunk, holder, dst, step, self.chunk_bytes,
                               reduce))
        return t, step

    @property
    def makespan(self) -> float:
        return max(self.link_free.values(), default=0.0)

    @property
    def num_steps(self) -> int:
        return max((m.step for m in self.moves), default=-1) + 1


def _route_pending(router: _Router, demands, have, max_hops_guard=None):
    """The list-scheduler loop: repeatedly route every still-unsatisfied
    (chunk, src, dst) demand from its earliest-available holder, letting
    delivered copies become forwarding sources."""
    pending = list(demands)
    max_rounds = len(pending) * 4
    rounds = 0
    while pending and rounds < max_rounds:
        rounds += 1
        progressed = []
        for (ci, src, dst) in pending:
            if dst in have[ci]:
                progressed.append((ci, src, dst))
                continue
            best = router.best_route(have[ci], dst)
            if best is None:
                continue
            _, _, holder, path = best
            t, _ = router.commit(ci, holder, dst, path, have[ci][holder])
            have[ci][dst] = t
            progressed.append((ci, src, dst))
        pending = [d for d in pending if d not in progressed]
        if not progressed:
            break


def _synthesize_gather_like(topo: Topology, task: CommTask,
                            sketch: Sketch) -> SynthSchedule:
    g = list(task.group)
    p = len(g)
    # size_bytes = TOTAL payload; one chunk = one node's contribution
    chunk_bytes = (task.size_bytes // max(p, 1)
                   if task.primitive in ("all_gather", "all_to_all")
                   else task.size_bytes)
    chunk_bytes = max(chunk_bytes, 1)
    demands = _demands_for(task)
    graph = _sketch_graph(topo, sketch)
    router = _Router(graph, chunk_bytes, sketch)
    have: Dict[int, Dict[int, float]] = {}
    for ci, src, _ in demands:
        have.setdefault(ci, {})[src] = 0.0
    # order demands for symmetry: rotate through sources round-robin
    if sketch.rotational_symmetry:
        demands = sorted(demands, key=lambda d: (d[0] % p, d[0], d[1]))
    _route_pending(router, demands, have)
    num_chunks = len(have)
    return SynthSchedule(
        task_id=task.task_id, primitive=task.primitive, group=tuple(g),
        size_bytes=task.size_bytes, chunk_bytes=chunk_bytes,
        num_chunks=num_chunks, moves=router.moves,
        num_steps=router.num_steps, makespan=router.makespan)


def _synthesize_all_reduce(topo: Topology, task: CommTask,
                           sketch: Sketch) -> SynthSchedule:
    """Mirrored-tree synthesis: chunk ``c`` is owned by rank ``group[c]``.
    The router synthesizes a fan-*out* forwarding tree per chunk (owner ->
    everyone, the all-gather structure); the reduce phase is that tree
    *reversed* — leaves push partial sums toward the owner, interior
    ranks accumulate before forwarding (``Move.reduce``), so each
    contribution crosses every tree edge exactly once.  Wire bytes are
    ``2 n (p-1)/p`` per rank on average — exactly the ring's — but the
    routes follow the topology (and the sketch's hot-link penalties)
    instead of a fixed neighbor order.

    Causality of the reversal: a fan-out edge delivered at wave ``w``
    becomes a reduce edge at wave ``S-1-w``; every child edge has
    ``w_child > w_parent`` in the fan-out, so in reverse each rank sends
    its partial sum strictly after all its children's arrive — the
    ordering the executable lowering (and the replay property test)
    relies on."""
    g = list(task.group)
    p = len(g)
    chunk_bytes = max(task.size_bytes // max(p, 1), 1)
    graph = _sketch_graph(topo, sketch)
    router = _Router(graph, chunk_bytes, sketch)

    # --- synthesize the fan-out trees (the gather phase) ----------------
    have: Dict[int, Dict[int, float]] = {c: {g[c]: 0.0} for c in range(p)}
    demands = [(c, g[c], dst) for c in range(p) for dst in g if dst != g[c]]
    if sketch.rotational_symmetry:
        demands = sorted(demands, key=lambda d: (d[0] % p, d[0], d[1]))
    _route_pending(router, demands, have)
    gather = router.moves
    span = max((m.step for m in gather), default=-1) + 1

    # --- reduce phase = the same trees, reversed ------------------------
    reduce_moves = [
        dataclasses.replace(m, src=m.dst, dst=m.src,
                            step=span - 1 - m.step, reduce=True)
        for m in gather]
    reduce_moves.sort(key=lambda m: m.step)
    moves = reduce_moves + [dataclasses.replace(m, step=m.step + span)
                            for m in gather]
    return SynthSchedule(
        task_id=task.task_id, primitive="all_reduce", group=tuple(g),
        size_bytes=task.size_bytes, chunk_bytes=chunk_bytes, num_chunks=p,
        moves=moves, num_steps=2 * span,
        makespan=2 * router.makespan)


def synthesize_schedule(topo: Topology, task: CommTask,
                        sketch: Optional[Sketch] = None) -> SynthSchedule:
    """Greedy earliest-finish chunk routing under sketch constraints,
    returning the full move-list schedule (price it, lower it, or
    flatten it with ``to_flowset``)."""
    sketch = sketch or Sketch()
    if task.primitive == "all_reduce":
        return _synthesize_all_reduce(topo, task, sketch)
    return _synthesize_gather_like(topo, task, sketch)


def synthesize(topo: Topology, task: CommTask,
               sketch: Optional[Sketch] = None) -> FlowSet:
    """Greedy earliest-finish chunk routing under sketch constraints
    (the FlowSet view of :func:`synthesize_schedule`)."""
    return synthesize_schedule(topo, task, sketch).to_flowset(
        job_id=task.job_id)


def atp_schedule(task: CommTask, ps: Optional[int] = None) -> SynthSchedule:
    """The priced ``atp`` candidate as a synthesizable schedule: every
    worker's full payload converges on the aggregation point (reduce
    moves — in-network the switches merge them; as an executable program
    the aggregation point accumulates), then the sum multicasts back.
    One chunk slot, two steps: the executable analogue of
    ``ccl.algorithms.atp_all_reduce``, lowered by
    ``ccl.primitives.synthesized_collective``."""
    g = list(task.group)
    if ps is None:
        ps = g[0]
    n = max(task.size_bytes, 1)
    moves = [Move(0, w, ps, 0, n, reduce=True) for w in g if w != ps]
    moves += [Move(0, ps, w, 1, n) for w in g if w != ps]
    return SynthSchedule(
        task_id=task.task_id, primitive="all_reduce", group=tuple(g),
        size_bytes=task.size_bytes, chunk_bytes=n, num_chunks=1,
        moves=moves, num_steps=2, makespan=0.0, algorithm="synthesized_atp")


# ---------------------------------------------------------------------------
# Memoization: (topology, primitive, group, size bucket, sketch) -> schedule
# ---------------------------------------------------------------------------


def topology_fingerprint(topo: Topology) -> str:
    """Stable (cross-process) identity of a topology's wiring: name,
    hosts, and every directed link with its bandwidth/latency.  Memoized
    on the instance — degradation views (``without_link`` / ``scaled_bw``)
    are fresh objects and fingerprint differently, exactly as re-planning
    needs."""
    cached = topo.__dict__.get("_fingerprint")
    if cached is None:
        edges = sorted((str(u), str(v), f"{d['bw']:.6e}", f"{d['lat']:.6e}")
                       for u, v, d in topo.graph.edges(data=True))
        payload = repr((topo.name, tuple(topo.accelerators),
                        tuple(topo.hosts), edges))
        cached = hashlib.sha1(payload.encode()).hexdigest()[:16]
        topo.__dict__["_fingerprint"] = cached
    return cached


def _sketch_key(sketch: Optional[Sketch]) -> Tuple:
    if sketch is None:
        return ()
    links = tuple(sorted(map(str, sketch.allowed_links))) \
        if sketch.allowed_links is not None else None
    entries = tuple(sorted(sketch.entry_nodes.items())) \
        if sketch.entry_nodes else None
    penalty = tuple(sorted((str(k), round(v, 12))
                           for k, v in sketch.link_penalty.items())) \
        if sketch.link_penalty else None
    return (links, entries, sketch.rotational_symmetry, sketch.max_hops,
            penalty)


def _size_bucket(size_bytes: int) -> int:
    """Power-of-two size bucket: schedules for 3 MiB and 3.9 MiB share
    routing structure, so the cache re-serves one rescaled schedule."""
    return int(size_bytes).bit_length()


class SynthCache:
    """Memoizes :func:`synthesize_schedule` per (topology fingerprint,
    primitive, group, size bucket, sketch key).  Hits at a different
    exact size inside the same power-of-two bucket are rescaled (same
    routes, proportional bytes).  ``cache_stats()`` mirrors
    ``FlowSim.cache_stats()`` so ``search()`` telemetry merges both."""

    def __init__(self, meters: Optional[Meters] = None):
        self._memo: Dict[Tuple, SynthSchedule] = {}
        self.meters = meters if meters is not None else Meters()

    def schedule(self, topo: Topology, task: CommTask,
                 sketch: Optional[Sketch] = None) -> SynthSchedule:
        key = (topology_fingerprint(topo), task.primitive, task.group,
               _size_bucket(task.size_bytes), _sketch_key(sketch))
        sched = self._memo.get(key)
        if sched is None:
            self.meters.incr("synth.miss")
            sched = synthesize_schedule(topo, task, sketch)
            self._memo[key] = sched
        else:
            self.meters.incr("synth.hit")
        if sched.size_bytes != task.size_bytes:
            sched = sched.rescaled(task.size_bytes)
        if sched.task_id != task.task_id:
            sched = dataclasses.replace(sched, task_id=task.task_id)
        return sched

    def cache_stats(self) -> Dict[str, float]:
        out = self.meters.snapshot()
        rate = self.meters.ratio("synth.hit", "synth.miss")
        if rate is not None:
            out["synth.hit_rate"] = rate
        out["synth.entries"] = float(len(self._memo))
        return out


#: the process-wide solver cache ``codesign.plan`` routes through, so a
#: search's candidates and an event-driven re-plan share synthesized
#: schedules across calls
DEFAULT_SYNTH_CACHE = SynthCache()


def synthesized_time(topo: Topology, task: CommTask,
                     sketch: Optional[Sketch] = None) -> float:
    """Predicted completion time of the synthesized schedule (the link-
    occupancy makespan computed during synthesis)."""
    sketch = sketch or Sketch()
    # re-run synthesis, tracking makespan
    fs = synthesize(topo, task, sketch)
    # makespan proxy: serial per-link occupancy — recompute via simulate
    from repro_torch.net.simulate import link_utilization
    util = link_utilization(topo, fs)
    t = 0.0
    for (u, v), nbytes in util.items():
        if topo.graph.has_edge(u, v):
            t = max(t, nbytes / topo.graph[u][v]["bw"])
    return t
