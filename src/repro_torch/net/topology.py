"""Network topologies for distributed training (paper Sec. II-D).

Builders for the topology families the survey discusses: fat-tree (+ over-
subscription), 2D/3D torus (TPU pods), ring, full-mesh, and the DGX-style
intra-host NVLink ring+mesh with slower inter-host links — the heterogeneous
"Intra-Inter" setting of Sec. IV-B.  Backed by networkx for path queries.

The port's copy of ``repro.net.topology``, kept line for line: importing any
``repro`` module runs the JAX package's ``__init__``, which imports jax, so
the port keeps its own.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import networkx as nx


@dataclass
class Topology:
    """Directed multigraph of GPUs/TPUs (+switch nodes) with per-link
    bandwidth (bytes/s) and latency (s).

    ``hosts`` partitions the accelerators into physical hosts (empty = no
    host structure, e.g. a TPU torus where every chip talks ICI directly).
    The codesign layer uses it for placement and for hierarchical
    (intra-host / inter-host) collective decomposition.
    """

    graph: nx.DiGraph
    name: str = "custom"
    accelerators: Tuple[int, ...] = ()
    hosts: Tuple[Tuple[int, ...], ...] = ()

    # ------------------------------------------------------------------
    def link_bw(self, u, v) -> float:
        return self.graph[u][v]["bw"]

    def links(self) -> Iterable[Tuple[int, int, dict]]:
        return self.graph.edges(data=True)

    def path(self, src, dst) -> List:
        """Latency-weighted shortest path (list of nodes)."""
        return nx.shortest_path(self.graph, src, dst, weight="lat")

    def path_links(self, src, dst) -> Tuple[Tuple, ...]:
        """Links of the latency-weighted shortest path, memoized — the flow
        simulator queries the same pairs for every step of a schedule.
        (Assumes the graph is not mutated after the first query.)"""
        cache = self.__dict__.setdefault("_path_cache", {})
        key = (src, dst)
        if key not in cache:
            p = self.path(src, dst)
            cache[key] = tuple(zip(p[:-1], p[1:]))
        return cache[key]

    # ------------------------------------------------------------------
    # Host / switch structure (codesign + ATP consumers)
    # ------------------------------------------------------------------

    def switch_nodes(self) -> Tuple:
        """Non-accelerator nodes (ToR/Agg/Core switches, host NICs, DCN
        routers) — the candidates for in-network aggregation."""
        accel = set(self.accelerators)
        return tuple(n for n in self.graph.nodes if n not in accel)

    def host_of(self, device) -> int:
        """Index into ``hosts`` of the host owning ``device`` (-1 if the
        topology has no host structure or the device is unassigned)."""
        lookup = self.__dict__.get("_host_lookup")
        if lookup is None:
            lookup = {d: h for h, devs in enumerate(self.hosts)
                      for d in devs}
            self.__dict__["_host_lookup"] = lookup
        return lookup.get(device, -1)

    def host_groups(self, group: Iterable[int]
                    ) -> Tuple[Tuple[int, ...], ...]:
        """Partition ``group`` (physical device ids) by host, preserving
        the group's order within each host.  Devices without a host each
        form a singleton."""
        buckets: Dict[int, List[int]] = {}
        order: List[int] = []
        for i, d in enumerate(group):
            h = self.host_of(d)
            key = h if h >= 0 else -(i + 2)  # unassigned: unique bucket
            if key not in buckets:
                buckets[key] = []
                order.append(key)
            buckets[key].append(d)
        return tuple(tuple(buckets[k]) for k in order)

    def bisection_bw(self) -> float:
        """Max-flow bandwidth across a node-count bisection of the
        accelerators (switch nodes route flow, they don't count as
        endpoints)."""
        n = len(self.accelerators)
        left = self.accelerators[: n // 2]
        right = self.accelerators[n // 2:]
        g = nx.DiGraph()
        for u, v, d in self.graph.edges(data=True):
            g.add_edge(u, v, capacity=d["bw"])
        inf = float("inf")
        for u in left:
            g.add_edge("__s", u, capacity=inf)
        for v in right:
            g.add_edge(v, "__t", capacity=inf)
        return nx.maximum_flow_value(g, "__s", "__t")

    @property
    def num_accelerators(self) -> int:
        return len(self.accelerators)

    # ------------------------------------------------------------------
    # Degradation views (codesign.dynamics consumers)
    # ------------------------------------------------------------------
    #
    # Production clusters churn: links fail or degrade, hosts drop out.
    # Each view returns a NEW Topology sharing nothing mutable with this
    # one (fresh graph copy, fresh path/host caches), so the event loop
    # can re-plan on the degraded fabric while the base topology keeps
    # answering queries for the healthy state.

    def without_link(self, u, v, symmetric: bool = True) -> "Topology":
        """View with the ``u<->v`` link removed (``symmetric=False`` drops
        only the ``u->v`` orientation).  Missing edges are ignored, so
        stacking failures is idempotent."""
        g = self.graph.copy()
        for a, b in ((u, v), (v, u)) if symmetric else ((u, v),):
            if g.has_edge(a, b):
                g.remove_edge(a, b)
        return Topology(g, name=f"{self.name}-link({u},{v})",
                        accelerators=self.accelerators, hosts=self.hosts)

    def without_host(self, host: int) -> "Topology":
        """View with one host's accelerators (and their incident links)
        removed.  ``host`` indexes ``hosts``; the surviving hosts keep
        their relative order (indices shift — views are snapshots, not
        stable ids)."""
        if not 0 <= host < len(self.hosts):
            raise ValueError(f"host {host} out of range "
                             f"(topology has {len(self.hosts)} hosts)")
        dead = set(self.hosts[host])
        g = self.graph.copy()
        g.remove_nodes_from(dead)
        return Topology(
            g, name=f"{self.name}-host{host}",
            accelerators=tuple(a for a in self.accelerators
                               if a not in dead),
            hosts=tuple(h for i, h in enumerate(self.hosts) if i != host))

    def scaled_bw(self, factors) -> "Topology":
        """View with link bandwidths scaled: ``factors`` is either one
        float applied to every link, or a ``{(u, v): factor}`` map (each
        entry scales both orientations of its link; factors must be
        > 0 — use :meth:`without_link` for outright failure)."""
        # normalize to one factor per *directed* edge before applying:
        # a dict entry names a physical link (both orientations), but the
        # scalar form enumerates graph.edges(), which already lists each
        # orientation — expanding those to both directions again would
        # scale every link twice
        per_edge = {}
        if not isinstance(factors, dict):
            per_edge = {(u, v): float(factors)
                        for u, v in self.graph.edges()}
        else:
            for (u, v), f in factors.items():
                for a, b in ((u, v), (v, u)):
                    if self.graph.has_edge(a, b):
                        per_edge[(a, b)] = f
        g = self.graph.copy()
        for (u, v), f in per_edge.items():
            if f <= 0:
                raise ValueError(f"bandwidth factor for ({u}, {v}) must "
                                 f"be > 0, got {f} (use without_link)")
            g[u][v]["bw"] = g[u][v]["bw"] * f
        return Topology(g, name=f"{self.name}-degraded",
                        accelerators=self.accelerators, hosts=self.hosts)


def _new_graph():
    return nx.DiGraph()


def _bilink(g, u, v, bw, lat):
    g.add_edge(u, v, bw=bw, lat=lat)
    g.add_edge(v, u, bw=bw, lat=lat)


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


def ring(n: int, bw: float = 50e9, lat: float = 1e-6) -> Topology:
    g = _new_graph()
    for i in range(n):
        _bilink(g, i, (i + 1) % n, bw, lat)
    return Topology(g, name=f"ring{n}", accelerators=tuple(range(n)))


def full_mesh(n: int, bw: float = 50e9, lat: float = 1e-6) -> Topology:
    g = _new_graph()
    for i, j in itertools.combinations(range(n), 2):
        _bilink(g, i, j, bw, lat)
    return Topology(g, name=f"mesh{n}", accelerators=tuple(range(n)))


def torus2d(nx_: int, ny: int, bw: float = 50e9, lat: float = 1e-6
            ) -> Topology:
    """2D torus with wraparound (TPU v5e pod = 16x16)."""
    g = _new_graph()
    def nid(x, y):
        return x * ny + y
    for x in range(nx_):
        for y in range(ny):
            _bilink(g, nid(x, y), nid((x + 1) % nx_, y), bw, lat)
            _bilink(g, nid(x, y), nid(x, (y + 1) % ny), bw, lat)
    return Topology(g, name=f"torus{nx_}x{ny}",
                    accelerators=tuple(range(nx_ * ny)))


def torus3d(a: int, b: int, c: int, bw: float = 50e9, lat: float = 1e-6
            ) -> Topology:
    """3D torus (TPU v4, [4] in the paper)."""
    g = _new_graph()
    def nid(x, y, z):
        return (x * b + y) * c + z
    for x in range(a):
        for y in range(b):
            for z in range(c):
                _bilink(g, nid(x, y, z), nid((x + 1) % a, y, z), bw, lat)
                _bilink(g, nid(x, y, z), nid(x, (y + 1) % b, z), bw, lat)
                _bilink(g, nid(x, y, z), nid(x, y, (z + 1) % c), bw, lat)
    return Topology(g, name=f"torus{a}x{b}x{c}",
                    accelerators=tuple(range(a * b * c)))


def fat_tree(num_hosts: int, gpus_per_host: int = 8,
             nic_bw: float = 25e9, agg_bw: float = 100e9,
             core_bw: float = 400e9, oversub: float = 1.0,
             pcie_bw: float = 32e9, lat: float = 2e-6,
             hosts_per_rack: int = 4, racks_per_pod: int = 4,
             agg_redundancy: int = 1) -> Topology:
    """Three-tier fat-tree (ToR / Agg / Core) with hosts of ``gpus_per_host``
    GPUs behind a NIC — the Fig. 5(b) setting.  ``oversub`` > 1 thins the
    uplinks.  ``agg_redundancy`` > 1 gives each pod that many parallel agg
    switches (every ToR uplinks to all of them, per-uplink bandwidth split
    so pod capacity is unchanged) — the multi-path tier that lets
    ``Topology.without_link`` failures re-route instead of partitioning
    the tree."""
    if agg_redundancy < 1:
        raise ValueError(f"agg_redundancy must be >= 1, got "
                         f"{agg_redundancy}")
    g = _new_graph()
    accel = []
    num_racks = (num_hosts + hosts_per_rack - 1) // hosts_per_rack
    num_pods = (num_racks + racks_per_pod - 1) // racks_per_pod
    core = "core"

    def agg_name(pod: int, k: int) -> str:
        # keep the legacy single-agg node names so redundancy=1 graphs
        # are byte-identical to what earlier PRs priced
        return f"agg{pod}" if agg_redundancy == 1 else f"agg{pod}.{k}"

    for r in range(num_racks):
        tor = f"tor{r}"
        for k in range(agg_redundancy):
            _bilink(g, tor, agg_name(r // racks_per_pod, k),
                    agg_bw / oversub / agg_redundancy, lat)
    for p in range(num_pods):
        for k in range(agg_redundancy):
            _bilink(g, agg_name(p, k), core,
                    core_bw / oversub / agg_redundancy, lat)
    gid = 0
    hosts = []
    for h in range(num_hosts):
        tor = f"tor{h // hosts_per_rack}"
        nic = f"host{h}"
        _bilink(g, nic, tor, nic_bw, lat)
        members = []
        for _ in range(gpus_per_host):
            _bilink(g, gid, nic, pcie_bw, 5e-7)
            accel.append(gid)
            members.append(gid)
            gid += 1
        hosts.append(tuple(members))
    return Topology(g, name=f"fattree_h{num_hosts}",
                    accelerators=tuple(accel), hosts=tuple(hosts))


def dgx_cluster(num_hosts: int, gpus_per_host: int = 8,
                nvlink_bw: float = 150e9, nic_bw: float = 25e9,
                lat: float = 1e-6) -> Topology:
    """DGX-1-style hosts: intra-host NVLink ring+mesh (fast), inter-host
    NICs into a single switch (slow) — the "Intra-Inter" heterogeneity."""
    g = _new_graph()
    accel = []
    hosts = []
    sw = "switch"
    for h in range(num_hosts):
        base = h * gpus_per_host
        gpus = list(range(base, base + gpus_per_host))
        accel.extend(gpus)
        hosts.append(tuple(gpus))
        # ring
        for i in range(gpus_per_host):
            _bilink(g, gpus[i], gpus[(i + 1) % gpus_per_host], nvlink_bw, lat)
        # partial mesh (skip-2 links, as in DGX-1's hypercube-ish wiring)
        for i in range(gpus_per_host):
            _bilink(g, gpus[i], gpus[(i + 2) % gpus_per_host],
                    nvlink_bw / 2, lat)
        nic = f"host{h}"
        _bilink(g, nic, sw, nic_bw, 2e-6)
        for gpu in gpus:
            _bilink(g, gpu, nic, nic_bw, 1e-6)
    return Topology(g, name=f"dgx_h{num_hosts}", accelerators=tuple(accel),
                    hosts=tuple(hosts))


def tpu_pod(multi_pod: bool = False, ici_bw: float = 50e9,
            dcn_bw: float = 25e9) -> Topology:
    """The production mesh's physical fabric: 16x16 ICI torus per pod;
    two pods joined via DCN through per-pod border hosts."""
    if not multi_pod:
        return torus2d(16, 16, bw=ici_bw)
    g = _new_graph()
    pods = []
    for p in range(2):
        t = torus2d(16, 16, bw=ici_bw)
        off = p * 256
        for u, v, d in t.graph.edges(data=True):
            g.add_edge(u + off, v + off, **d)
        pods.append(off)
    # DCN: one border router per pod, 8 chips per pod homed on it
    _bilink(g, "dcn0", "dcn1", dcn_bw * 8, 5e-6)
    for p, off in enumerate(pods):
        for i in range(0, 256, 32):
            _bilink(g, off + i, f"dcn{p}", dcn_bw, 2e-6)
    return Topology(g, name="tpu_2pods", accelerators=tuple(range(512)))


TOPOLOGY_BUILDERS = {
    "ring": ring,
    "full_mesh": full_mesh,
    "torus2d": torus2d,
    "torus3d": torus3d,
    "fat_tree": fat_tree,
    "dgx": dgx_cluster,
    "tpu_pod": tpu_pod,
}
