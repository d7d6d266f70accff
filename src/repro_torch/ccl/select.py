"""NCCL-style algorithm auto-selection behind a CostModel protocol.

NCCL "dynamically selects established algorithms based on different
situations" (paper Sec. III-B): small payloads favour latency-optimal
algorithms (tree / halving-doubling), large payloads favour bandwidth-
optimal rings.  The seed reproduced that with flat alpha-beta closed forms;
this module generalizes pricing behind a :class:`CostModel` protocol so the
CCL layer can consult the network layer (the paper's Sec. II-E co-design
gap):

  * :class:`AlphaBeta` — the original closed forms (`repro_torch.ccl.cost`),
    kept exact, optionally hierarchy-aware via ``CostParams.gpus_per_host``;
  * :class:`FlowSim`  — generates the candidate algorithm's actual flow
    schedule (`repro_torch.ccl.algorithms`) and prices it on a real
    ``net.Topology`` with ``net.simulate.simulate_flowset``, memoized on
    ``(primitive, algorithm, size, group)`` so selection over a 40-layer
    demand stays sub-second.

``select_algorithm`` keeps the seed's signature (AlphaBeta under the hood);
``select_for_task`` is the topology-aware entry point the codesign driver
uses.

The "Host-Net" arrow (paper Sec. IV-B) runs through here too: the ``atp``
in-network-aggregation all-reduce competes like any other candidate on
switched topologies, with ``sched.atp.aggregation_switches`` supplying the
aggregation capability and the multi-tenant switch-memory fallback.

So does the compression lever (``repro_torch.compress``): ``"<base>+<codec>"``
candidates such as ``ring+q8`` compete on wire-scaled schedules plus
encode/decode overhead, gated by ``select_for_task``'s ``error_budget``
(default 0 = lossless only).

Decomposed TP collectives (``core.demand_builder.decompose_demand``)
arrive here as ``permute`` tasks — one ring neighbor-exchange step each.
They price through the same path (closed form ``alpha + n/beta``, or the
one-step flowset on the real topology), and both models' memoization
collapses the 2(p-1) identical steps per layer to a single evaluation.

The port's copy of ``repro.ccl.select``, kept line for line: importing any
``repro`` module runs the JAX package's ``__init__``, which imports jax, so
the port keeps its own.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Protocol, Tuple

from repro_torch.ccl.algorithms import ALGORITHMS, generate_flows
from repro_torch.ccl.cost import CostParams, algo_cost
from repro_torch.compress.codec import (SPECS, base_algorithm, codec_spec,
                                        split_algorithm)
from repro_torch.core.demand import CommTask, FlowSet
from repro_torch.core.knobs import Choice, Fixed, Knob, Search
from repro_torch.obs.meters import Meters
from repro_torch.net.simulate import simulate_flowset
from repro_torch.net.topology import Topology
from repro_torch.sched.atp import aggregation_switches


# ---------------------------------------------------------------------------
# Eligibility guards (structural: independent of the cost model)
# ---------------------------------------------------------------------------


def is_square(p: int) -> bool:
    """Exact perfect-square test.  ``int(p ** 0.5)`` mis-rounds for large
    perfect squares (float sqrt of a non-representable int); ``math.isqrt``
    is exact."""
    return p >= 0 and math.isqrt(p) ** 2 == p


def structurally_eligible(algorithm: str, p: int) -> bool:
    """Group-shape guards that hold regardless of how costs are computed.
    Compressed candidates (``ring+q8``) inherit their base's guards."""
    base = base_algorithm(algorithm)
    if base == "halving_doubling" and p & (p - 1):
        return False  # needs power-of-two
    if base == "torus2d" and not is_square(p):
        return False  # needs a square grid layout
    return True


# ---------------------------------------------------------------------------
# CostModel protocol + implementations
# ---------------------------------------------------------------------------


class CostModel(Protocol):
    """What the selection layer needs from a pricing backend."""

    def supports(self, task: CommTask, algorithm: str) -> bool:
        """Model-specific eligibility (beyond the structural guards)."""
        ...

    def cost(self, task: CommTask, algorithm: str) -> float:
        """Predicted completion time (seconds) of ``algorithm`` on ``task``."""
        ...


# When a flat algorithm's group spans hosts on a hierarchical fabric, its
# crossing traffic is bottlenecked by the per-host NIC, shared by this many
# concurrent crossing flows per step (None = one per host GPU, i.e.
# gpus_per_host): a bidirectional ring crosses each NIC twice; recursive
# halving/doubling and direct all-to-all cross with every host member at
# once, and a 2D torus's parallel sub-rings each cross on the column phase.
# Algorithms not listed cross once per step (plain rings, trees).
_NIC_SHARING = {"bidir_ring": 2.0, "halving_doubling": None, "direct": None,
                "torus2d": None}


def _hierarchical_partition_ok(topo: Topology, group: Tuple[int, ...]
                               ) -> bool:
    """The hierarchical decomposition needs the (placed) group to split
    into >=2 equal-size hosts of >=2 members each."""
    hosts = topo.host_groups(group)
    sizes = {len(h) for h in hosts}
    return len(hosts) > 1 and len(sizes) == 1 and sizes != {1}


@dataclass(frozen=True)
class AlphaBeta:
    """Closed-form alpha-beta pricing.  For flat ``CostParams`` this is the
    seed's behaviour, kept exact.  With hierarchy params set
    (``gpus_per_host``/``inter_bw``), flat algorithms whose group spans
    hosts are priced at the NIC-tier bottleneck (divided by the
    algorithm's NIC-sharing factor) instead of the intra-host bandwidth —
    otherwise the closed forms would never let ``hierarchical`` win."""

    params: CostParams = CostParams()
    # set by from_topology: enables the physical host-partition eligibility
    # check for groups that are already placed onto real devices (the
    # divisibility heuristic alone would accept e.g. a 16-rank group strided
    # over 3 hosts, which the flow generator then rejects)
    topo: Optional[Topology] = None

    def supports(self, task: CommTask, algorithm: str) -> bool:
        base = base_algorithm(algorithm)  # compressed names inherit base's
        if base == "hierarchical":
            if self.topo is not None:
                return _hierarchical_partition_ok(self.topo, task.group)
            m = self.params.gpus_per_host
            p = len(task.group)
            return m > 1 and p > m and p % m == 0
        if base == "atp":
            # in-network aggregation needs programmable switches on the
            # fabric; with only closed-form params, a switched inter-host
            # tier (inter_bw) is the eligibility proxy
            if self.topo is not None:
                return bool(self.topo.switch_nodes())
            return self.params.inter_bw > 0
        return True

    def cost(self, task: CommTask, algorithm: str) -> float:
        cp = self.params
        p = len(task.group)
        base = base_algorithm(algorithm)
        if task.primitive == "p2p" and p == 2:
            # a point-to-point transfer runs at its actual path bottleneck
            # (a KV-cache shard hop may cross the NIC tier even though
            # p=2 never trips the group-spans-hosts heuristic below)
            u, v = task.group
            if self.topo is not None and u != v:
                bw = min(self.topo.link_bw(a, b)
                         for a, b in self.topo.path_links(u, v))
                cp = dataclasses.replace(cp, link_bw=bw)
            elif cp.inter_bw and cp.gpus_per_host > 1 \
                    and u // cp.gpus_per_host != v // cp.gpus_per_host:
                cp = dataclasses.replace(cp, link_bw=cp.inter_bw)
            return algo_cost(task.primitive, algorithm, task.size_bytes, p,
                             cp)
        if base == "atp" and not cp.inter_bw:
            # switched but non-hierarchical fabric (e.g. one NIC per host):
            # the aggregation tier runs at the bottleneck link bandwidth
            cp = dataclasses.replace(cp, inter_bw=cp.link_bw)
        if base == "hierarchical" and self.topo is not None:
            # the placed group's actual per-host size, not the nominal one
            m = len(self.topo.host_groups(task.group)[0])
            if m != cp.gpus_per_host:
                cp = dataclasses.replace(cp, gpus_per_host=m)
        elif (base not in ("hierarchical", "atp")
                and cp.gpus_per_host > 1
                and p > cp.gpus_per_host and cp.inter_bw):
            share = _NIC_SHARING.get(base, 1.0) or cp.gpus_per_host
            cp = dataclasses.replace(cp, link_bw=cp.inter_bw / share)
        return algo_cost(task.primitive, algorithm, task.size_bytes, p, cp)

    def cost_flowset(self, task: CommTask, fs: FlowSet,
                     algorithm: Optional[str] = None) -> float:
        """Closed-form pricing of an *explicit* flow schedule (a synthesized
        move list, not a registered name): per step, one alpha plus the
        busiest endpoint's serialized bytes over the tier bandwidth it
        talks across (``inter_bw`` when the flow crosses hosts — resolved
        through the topology when attached, else the
        ``gpus_per_host``-contiguous heuristic).  This is the step-count
        alpha-beta analogue of the ring/tree closed forms, so synthesized
        candidates compete under *both* cost models, not just FlowSim.

        Compressed variants (``synthesized+q8``) hand in wire-scaled
        flowsets; the codec's encode/decode overhead is charged here from
        the algorithm name, mirroring :func:`repro_torch.ccl.cost.algo_cost`."""
        cp = self.params
        if len(task.group) <= 1 or not fs.flows:
            return 0.0
        if self.topo is not None:
            host_of = self.topo.host_of

            def crossing(u, v):
                return host_of(u) != host_of(v)
        elif cp.gpus_per_host > 1:
            m = cp.gpus_per_host

            def crossing(u, v):
                return u // m != v // m
        else:
            def crossing(u, v):
                return False
        inter_bw = cp.inter_bw or cp.link_bw
        by_step: Dict[int, List] = {}
        for f in fs.flows:
            by_step.setdefault(f.step, []).append(f)
        total = 0.0
        for flows in by_step.values():
            # serialization point: a node's egress (or ingress) NIC sends
            # (receives) its step bytes back-to-back on each tier
            load: Dict[Tuple, float] = {}
            for f in flows:
                bw = inter_bw if crossing(f.src, f.dst) else cp.link_bw
                for end in ((f.src, "tx"), (f.dst, "rx")):
                    load[end] = load.get(end, 0.0) + f.size_bytes / bw
            total += cp.alpha + max(load.values(), default=0.0)
        name = algorithm or fs.algorithm
        _, codec = split_algorithm(name)
        if codec is not None:
            spec = codec_spec(codec)
            total += len(by_step) * cp.codec_alpha \
                + spec.passes * task.size_bytes / cp.codec_bw
        return total

    @classmethod
    def from_topology(cls, topo: Topology, alpha: float = None) -> "AlphaBeta":
        """Derive flat-or-hierarchical CostParams from a Topology: intra
        bandwidth = bottleneck link between two co-hosted accelerators,
        inter bandwidth = bottleneck across hosts.  Topologies without host
        structure get the bottleneck bandwidth of an adjacent pair."""
        accel = topo.accelerators
        if len(accel) < 2:
            return cls(CostParams())

        def bottleneck(u, v) -> float:
            return min(topo.link_bw(a, b) for a, b in topo.path_links(u, v))

        def lat(u, v) -> float:
            return sum(topo.graph[a][b]["lat"]
                       for a, b in topo.path_links(u, v))

        sizes = {len(h) for h in topo.hosts}
        if topo.hosts and sizes == {len(topo.hosts[0])} \
                and len(topo.hosts) > 1 and len(topo.hosts[0]) > 1:
            h0, h1 = topo.hosts[0], topo.hosts[1]
            intra_bw = bottleneck(h0[0], h0[1])
            inter_bw = bottleneck(h0[0], h1[0])
            a = alpha if alpha is not None else max(lat(h0[0], h1[0]), 1e-7)
            return cls(CostParams(alpha=a, link_bw=intra_bw,
                                  inter_bw=inter_bw,
                                  gpus_per_host=len(h0)), topo=topo)
        a = alpha if alpha is not None else max(lat(accel[0], accel[1]), 1e-7)
        return cls(CostParams(alpha=a,
                              link_bw=bottleneck(accel[0], accel[1])),
                   topo=topo)


class FlowSim:
    """Prices a candidate algorithm by generating its FlowSet and simulating
    it on the actual topology — the CCL layer asking the network layer
    instead of assuming a flat link (the paper's vertical co-design arrow).

    Both the generated flowsets and the simulated costs are memoized on
    ``(primitive, algorithm, size_bytes, group)``: a 40-layer demand repeats
    a handful of unique (size, group) keys, so end-to-end selection stays
    sub-second.

    ``switch_capacity`` is the per-switch in-network aggregation budget
    (ATP's multi-tenant constraint, forwarded to
    ``sched.atp.aggregation_switches``): groups larger than it lose the
    aggregation discount and the ``atp`` candidate is priced as degraded
    host PS aggregation.

    Compressed candidates (``ring+q8``, ``ps+topk``, ...) are simulated on
    their wire-scaled flowsets plus encode/decode overhead:
    ``codec_alpha`` per schedule step and ``spec.passes`` full-payload
    passes at ``codec_bw`` bytes/s (same model as ``CostParams``)."""

    def __init__(self, topo: Topology, switch_capacity: Optional[int] = None,
                 codec_bw: float = 200e9, codec_alpha: float = 2e-6,
                 meters: Optional[Meters] = None):
        self.topo = topo
        self.switch_capacity = switch_capacity
        self.codec_bw = codec_bw
        self.codec_alpha = codec_alpha
        self._cost_memo: Dict[Tuple, float] = {}
        self._flow_memo: Dict[Tuple, FlowSet] = {}
        # memoization telemetry (repro_torch.obs): counter names carry the
        # switch-capacity bucket since one FlowSim exists per aggregation
        # budget, so merged snapshots keep the buckets apart
        self.meters = meters if meters is not None else Meters()
        self._bucket = f"flowsim[cap={switch_capacity}]"

    def _key(self, task: CommTask, algorithm: str) -> Tuple:
        return (task.primitive, algorithm, task.size_bytes, task.group)

    def cache_stats(self) -> Dict[str, float]:
        """This model's memoization counters plus the hit rates (the
        headline numbers ``search()`` telemetry floors on)."""
        m = self.meters
        out = m.snapshot()
        for kind in ("cost", "flow"):
            rate = m.ratio(f"{self._bucket}.{kind}.hit",
                           f"{self._bucket}.{kind}.miss")
            if rate is not None:
                out[f"{self._bucket}.{kind}.hit_rate"] = rate
        out[f"{self._bucket}.cost.entries"] = float(len(self._cost_memo))
        return out

    def supports(self, task: CommTask, algorithm: str) -> bool:
        base = base_algorithm(algorithm)  # compressed names inherit base's
        if base == "hierarchical":
            return _hierarchical_partition_ok(self.topo, task.group)
        if base == "atp":
            # needs programmable switches below a host structure (fat-tree /
            # DGX NIC tier); pure ICI fabrics have no aggregation point
            return bool(self.topo.hosts) and bool(self.topo.switch_nodes())
        return True

    def flowset(self, task: CommTask, algorithm: str) -> FlowSet:
        key = self._key(task, algorithm)
        if key not in self._flow_memo:
            self.meters.incr(f"{self._bucket}.flow.miss")
            self._flow_memo[key] = flows_on_topology(
                self.topo, task, algorithm)
        else:
            self.meters.incr(f"{self._bucket}.flow.hit")
        return self._flow_memo[key]

    def cost(self, task: CommTask, algorithm: str) -> float:
        key = self._key(task, algorithm)
        if key in self._cost_memo:
            self.meters.incr(f"{self._bucket}.cost.hit")
            return self._cost_memo[key]
        self.meters.incr(f"{self._bucket}.cost.miss")
        agg = None
        if base_algorithm(algorithm) == "atp":
            agg = aggregation_switches(self.topo, task.group,
                                       self.switch_capacity)
        fs = self.flowset(task, algorithm)
        t = simulate_flowset(self.topo, fs, aggregate_at=agg)
        _, codec = split_algorithm(algorithm)
        if codec is not None:
            spec = codec_spec(codec)
            t += fs.num_steps * self.codec_alpha \
                + spec.passes * task.size_bytes / self.codec_bw
        self._cost_memo[key] = t
        return t

    def cost_flowset(self, task: CommTask, fs: FlowSet,
                     algorithm: Optional[str] = None) -> float:
        """Price an *explicit* flow schedule (a synthesized move list) by
        simulating it on the topology — the same path registered
        algorithms take, minus the generator.  Memoized alongside
        :meth:`cost` under a schedule fingerprint (same schedule handed
        in twice — e.g. a lossless and a wire-scaled variant share a
        solver run but not flows — prices once each).  Compressed names
        (``synthesized+q8``) add the codec overhead; their flowsets are
        expected to already carry wire-scaled bytes."""
        name = algorithm or fs.algorithm
        fp = hash(tuple((f.src, f.dst, f.size_bytes, f.step)
                        for f in fs.flows))
        key = (task.primitive, name, task.size_bytes, task.group, fp)
        if key in self._cost_memo:
            self.meters.incr(f"{self._bucket}.cost.hit")
            return self._cost_memo[key]
        self.meters.incr(f"{self._bucket}.cost.miss")
        t = simulate_flowset(self.topo, fs)
        _, codec = split_algorithm(name)
        if codec is not None:
            spec = codec_spec(codec)
            t += fs.num_steps * self.codec_alpha \
                + spec.passes * task.size_bytes / self.codec_bw
        self._cost_memo[key] = t
        return t


def flows_on_topology(topo: Topology, task: CommTask,
                      algorithm: str) -> FlowSet:
    """`generate_flows`, but topology-aware: hierarchical algorithms (plain
    or compressed) get the physical host partition of the (placed) group."""
    if base_algorithm(algorithm) == "hierarchical":
        return generate_flows(task, algorithm,
                              hosts=topo.host_groups(task.group))
    return generate_flows(task, algorithm)


# ---------------------------------------------------------------------------
# Selection
# ---------------------------------------------------------------------------


@dataclass
class Selection:
    """Outcome of pricing every eligible candidate for one task."""

    algorithm: str
    cost: float
    costs: Dict[str, float] = field(default_factory=dict)
    excluded: List[str] = field(default_factory=list)


def constraint_from_allow(allow: Optional[Tuple[str, ...]]) -> Knob:
    """The legacy ``allow`` tuple as a knob: None (or empty, which always
    behaved like None) opens the full registry, a single name is a force
    (``Fixed``), several names a whitelist."""
    if not allow:
        return Search()
    if len(allow) == 1:
        return Fixed(allow[0])
    return Choice(*allow)


def select_for_task(task: CommTask, model: CostModel,
                    allow: Optional[Tuple[str, ...]] = None,
                    error_budget: float = 0.0,
                    constraint: Optional[Knob] = None,
                    extra_flowsets: Optional[Mapping[str, FlowSet]] = None
                    ) -> Selection:
    """Pick the cheapest eligible algorithm for ``task`` under ``model``.

    ``constraint`` is the plan-space knob for this task's primitive
    (``repro_torch.core.knobs``): ``Search()`` opens every registered candidate
    (the default), ``Choice(...)`` whitelists, and ``Fixed(name)`` forces
    one algorithm.  The legacy ``allow`` tuple is accepted as shorthand
    and normalized via :func:`constraint_from_allow` (None -> Search,
    one name -> Fixed, several -> Choice); passing both is an error.

    ``error_budget`` gates compressed candidates: a ``"<base>+<codec>"``
    name competes only if the codec's effective relative error (see
    ``CodecSpec.effective_error``) fits the budget.  The default budget of
    0 excludes all lossy candidates — exactness is opt-in per task.  Only
    a ``Fixed`` constraint (a force, e.g. the driver's ``force=`` path)
    bypasses the budget — forcing one compressed algorithm is an explicit
    accuracy decision; a ``Choice`` whitelist still respects the budget.

    ``extra_flowsets`` maps candidate names to *explicit* flow schedules
    (synthesized move lists from ``ccl.synth``) that compete alongside the
    registry: each is priced through the model's ``cost_flowset`` (both
    ``AlphaBeta`` and ``FlowSim`` implement it; models without it skip the
    extras).  Extras bypass the structural/``supports`` guards — an
    explicit schedule *is* its own feasibility proof — but compressed
    extras (``synthesized+q8``) still face the error budget, and a
    ``Choice``/``Fixed`` constraint whitelists extras by name exactly
    like registered candidates."""
    if constraint is None:
        constraint = constraint_from_allow(allow)
    elif allow is not None:
        raise ValueError("pass either allow= or constraint=, not both")
    forced = isinstance(constraint, Fixed)
    allowed: Optional[Tuple[str, ...]] = None
    if forced:
        allowed = (constraint.value,)
    elif isinstance(constraint, Choice):
        allowed = constraint.options
    elif not isinstance(constraint, Search):
        raise TypeError(f"constraint must be a Fixed/Choice/Search knob, "
                        f"got {constraint!r}")
    p = len(task.group)
    costs: Dict[str, float] = {}
    excluded: List[str] = []
    names = list(ALGORITHMS[task.primitive])
    if allowed:
        # ad hoc "<base>+<codec>" combos beyond the canonical registry are
        # explicitly allowable (generate_flows/algo_cost compose them)
        for name in allowed:
            if name not in names and "+" in name:
                base, codec = split_algorithm(name)
                if base_algorithm(name) in ALGORITHMS[task.primitive] \
                        and codec in SPECS:
                    names.append(name)
    for name in names:
        if allowed and name not in allowed:
            continue
        _, codec = split_algorithm(name)
        if codec is not None and not forced and \
                codec_spec(codec).effective_error > error_budget:
            excluded.append(name)
            continue
        if not structurally_eligible(name, p) or \
                not model.supports(task, name):
            excluded.append(name)
            continue
        costs[name] = model.cost(task, name)
    if extra_flowsets:
        pricer = getattr(model, "cost_flowset", None)
        for name, fs in extra_flowsets.items():
            if pricer is None or (allowed and name not in allowed):
                continue
            _, codec = split_algorithm(name)
            if codec is not None and not forced and \
                    codec_spec(codec).effective_error > error_budget:
                excluded.append(name)
                continue
            costs[name] = pricer(task, fs, algorithm=name)
    if not costs:
        raise ValueError(
            f"no eligible algorithm for primitive {task.primitive!r} with "
            f"group size p={p}: registered="
            f"{list(ALGORITHMS[task.primitive])}, allow={allowed}, "
            f"excluded by eligibility guards={excluded}")
    best = min(costs, key=costs.get)
    return Selection(best, costs[best], costs, excluded)


def select_algorithm(primitive: str, size_bytes: int, p: int,
                     cp: CostParams,
                     allow: Optional[Tuple[str, ...]] = None
                     ) -> Tuple[str, float, Dict[str, float]]:
    """Seed-compatible entry point: alpha-beta pricing over a logical
    ``range(p)`` group.  Returns (best_algorithm, predicted_cost, all_costs)."""
    task = CommTask("select", primitive, size_bytes, tuple(range(p)))
    sel = select_for_task(task, AlphaBeta(cp), allow=allow)
    return sel.algorithm, sel.cost, sel.costs
