"""Flow-level network simulator.

Simulates a FlowSet (the CCL layer's traffic) on a Topology: flows of the
same step run concurrently and share links; a step's duration is the max
over links of (bytes on link / link bw) plus one latency hop (synchronous
bulk model — the same abstraction SCCL/TACCL cost their schedules with).
Supports in-network aggregation (ATP-style): flows of the same task that
meet at a programmable switch are merged (summed payload -> single flow),
and the symmetric multicast case — flows of the same task fanning out from
one source (the aggregated result returning to the workers) carry the
payload once on every shared path prefix.

The port's copy of ``repro.net.simulate``, kept line for line: importing any
``repro`` module runs the JAX package's ``__init__``, which imports jax, so
the port keeps its own.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.core.demand import Flow, FlowSet
from repro_torch.net.topology import Topology


def _route_bytes(topo: Topology, flows: Iterable[Flow],
                 aggregate_at: Optional[Set] = None
                 ) -> Dict[Tuple, float]:
    """Per-link byte loads for one concurrent step."""
    link_bytes: Dict[Tuple, float] = defaultdict(float)
    if not aggregate_at:
        for f in flows:
            for link in topo.path_links(f.src, f.dst):
                link_bytes[link] += f.size_bytes
        return link_bytes

    # ATP-style: flows with identical (task, dst) merge at the first shared
    # aggregation-capable switch on their paths; downstream of the merge
    # point only one payload continues.  The symmetric case — one source
    # fanning the aggregated result back out (task, src) — is a multicast:
    # every link on the shared path tree carries the payload once.
    by_dst: Dict[Tuple, List[Flow]] = defaultdict(list)
    for f in flows:
        by_dst[(f.task_id, f.dst)].append(f)
    remaining: List[Flow] = []  # not merged; multicast candidates
    for (task, dst), fl in by_dst.items():
        if len(fl) == 1:
            remaining.append(fl[0])
            continue
        seen_downstream: Set[Tuple] = set()
        for f in fl:
            links = topo.path_links(f.src, f.dst)
            merged = False
            for u, v in links:
                if merged:
                    # downstream of merge point: count once per group
                    if (u, v) not in seen_downstream:
                        link_bytes[(u, v)] += f.size_bytes
                        seen_downstream.add((u, v))
                else:
                    link_bytes[(u, v)] += f.size_bytes
                if not merged and (u in aggregate_at or v in aggregate_at):
                    merged = True
        # (approximation: payload sizes equal within a group)
    by_src: Dict[Tuple, List[Flow]] = defaultdict(list)
    for f in remaining:
        by_src[(f.task_id, f.src)].append(f)
    for (task, src), fl in by_src.items():
        if len(fl) == 1:
            f = fl[0]
            for link in topo.path_links(f.src, f.dst):
                link_bytes[link] += f.size_bytes
            continue
        # multicast fan-out: one shared copy travels as far as the LAST
        # aggregation-capable switch on each receiver's path (which
        # replicates it); links beyond that carry per-receiver copies.
        # Shared links are counted once across the group.
        seen_shared: Set[Tuple] = set()
        for f in fl:
            links = topo.path_links(f.src, f.dst)
            last_cap = -1
            for i, (u, v) in enumerate(links):
                if v in aggregate_at:
                    last_cap = i
            for i, link in enumerate(links):
                if i <= last_cap:
                    if link not in seen_shared:
                        link_bytes[link] += f.size_bytes
                        seen_shared.add(link)
                else:
                    link_bytes[link] += f.size_bytes
    return link_bytes


def simulate_step(topo: Topology, flows: Sequence[Flow],
                  aggregate_at: Optional[Set] = None) -> float:
    if not flows:
        return 0.0
    link_bytes = _route_bytes(topo, flows, aggregate_at)
    t = 0.0
    for (u, v), nbytes in link_bytes.items():
        t = max(t, nbytes / topo.graph[u][v]["bw"])
    # one latency charge per step (max path latency)
    lat = max(sum(topo.graph[u][v]["lat"]
                  for u, v in topo.path_links(f.src, f.dst))
              for f in flows)
    return t + lat


def simulate_flowset(topo: Topology, fs: FlowSet,
                     aggregate_at: Optional[Set] = None) -> float:
    """Total completion time of one collective's schedule (steps serialize)."""
    by_step: Dict[int, List[Flow]] = defaultdict(list)
    for f in fs.flows:
        by_step[f.step].append(f)
    return sum(simulate_step(topo, by_step[s], aggregate_at)
               for s in sorted(by_step))


def simulate_schedule(topo: Topology, flowsets: Sequence[FlowSet],
                      concurrent: bool = False,
                      aggregate_at: Optional[Set] = None) -> float:
    """Multiple collectives: serialized, or naively concurrent (all steps of
    all tasks overlap — the resource-competition case of Fig. 5(b))."""
    if not concurrent:
        return sum(simulate_flowset(topo, fs, aggregate_at)
                   for fs in flowsets)
    # concurrent: align step k of every task
    max_steps = max((fs.num_steps for fs in flowsets), default=0)
    total = 0.0
    for s in range(max_steps):
        flows = [f for fs in flowsets for f in fs.flows if f.step == s]
        total += simulate_step(topo, flows, aggregate_at)
    return total


def link_utilization(topo: Topology, fs: FlowSet,
                     aggregate_at: Optional[Set] = None) -> Dict[Tuple, float]:
    """Aggregate bytes per link across the whole schedule (hot-spot map).

    ``aggregate_at``: switches that merge/multicast same-task flows
    (in-network aggregation) — pass for ATP-style schedules so the map
    reflects the reduced on-wire traffic."""
    out: Dict[Tuple, float] = defaultdict(float)
    if aggregate_at:
        by_step: Dict[int, List[Flow]] = defaultdict(list)
        for f in fs.flows:
            by_step[f.step].append(f)
        for step_flows in by_step.values():
            for link, nbytes in _route_bytes(topo, step_flows,
                                             aggregate_at).items():
                out[link] += nbytes
        return dict(out)
    for f in fs.flows:
        for link in topo.path_links(f.src, f.dst):
            out[link] += f.size_bytes
    return dict(out)


def link_rate_series(topo: Topology,
                     placed: Sequence[Tuple[FlowSet, float, float]],
                     aggregate_at: Optional[Set] = None
                     ) -> Dict[Tuple, List[Tuple[float, float]]]:
    """Per-link byte-rate step functions for a scheduled set of collectives.

    ``placed`` pairs each FlowSet with the wall-clock window it occupied
    (``(fs, start_s, end_s)``, e.g. a ``SimResult.timeline`` comm span);
    the schedule's per-link bytes (:func:`link_utilization`, so
    ``aggregate_at`` applies) are spread uniformly over the window.
    Returns ``link -> [(t, bytes_per_s), ...]`` breakpoints — a
    piecewise-constant utilization profile, sorted by time and closed
    with a final zero-rate sample — ready to plot or to emit as trace
    counter tracks (``repro_torch.obs.trace``)."""
    deltas: Dict[Tuple, Dict[float, float]] = defaultdict(
        lambda: defaultdict(float))
    for fs, start, end in placed:
        dur = max(end - start, 1e-12)
        for link, nbytes in link_utilization(topo, fs, aggregate_at).items():
            rate = nbytes / dur
            deltas[link][start] += rate
            deltas[link][start + dur] -= rate
    series: Dict[Tuple, List[Tuple[float, float]]] = {}
    for link, dd in deltas.items():
        rate = 0.0
        points: List[Tuple[float, float]] = []
        for t in sorted(dd):
            rate += dd[t]
            points.append((t, max(rate, 0.0)))
        series[link] = points
    return series


def shared_link_load(per_job: Dict[str, Dict[Tuple, float]],
                     min_jobs: int = 2) -> Dict[Tuple, Dict[str, float]]:
    """Link-share query for the horizontal planner: given per-job link-byte
    maps (e.g. each job's ``CodesignReport`` hot-spot map), return the links
    carrying traffic from at least ``min_jobs`` distinct jobs, as
    link -> {job: bytes}."""
    users: Dict[Tuple, Dict[str, float]] = defaultdict(dict)
    for job, link_bytes in per_job.items():
        for link, nbytes in link_bytes.items():
            if nbytes > 0:
                users[link][job] = nbytes
    return {link: jobs for link, jobs in users.items()
            if len(jobs) >= min_jobs}
