"""Placement search: candidate generators for the placement knob.

The ROADMAP's TopoOpt-style open item: ``codesign.placement`` offered
packed / strided / custom, but nothing *searched* placements against the
FlowSim cost.  This module supplies the candidates ``codesign.api.search``
prices when ``PlanSpace.placement`` is ``Search()``:

  * the named strategies (``packed``, ``strided``);
  * ``balanced`` — host-balanced blocks: each innermost (model-axis)
    communicator is split as evenly as possible across the fewest hosts
    that can hold it.  Where ``packed`` straddles a host boundary
    unevenly (e.g. a TP-12 group over 8-GPU hosts lands 8+4), the even
    6+6 split restores the equal-size host partition the hierarchical
    decomposition needs — the single biggest placement win on
    oversubscribed fat-trees;
  * axis permutations — row-major rank layouts under every permutation
    of the mesh axes (the "which axis is physically innermost" family);
  * a swap neighborhood for local refinement, ordered by the incumbent
    plan's link hot spots (move the ranks pressing the hottest links
    first).

All generators are deterministic (no RNG): the same mesh + topology
always yield the same candidate sequence, which is what makes
``search()`` reproducible.

The port's copy of ``repro.codesign.placement_search``, kept line for
line: importing any ``repro`` module runs the JAX package's ``__init__``,
which imports jax, so the port keeps its own.
"""
from __future__ import annotations

import itertools
import math
from typing import Iterator, List, Optional, Sequence, Tuple, Union

from repro_torch.core.types import MeshConfig
from repro_torch.net.topology import Topology

from repro_torch.codesign.placement import Placement, place_mesh
from repro_torch.codesign.report import CodesignReport


def _ravel(coord: Sequence[int], shape: Sequence[int]) -> int:
    idx = 0
    for dim, c in zip(shape, coord):
        idx = idx * dim + c
    return idx


def _unravel(idx: int, shape: Sequence[int]) -> Tuple[int, ...]:
    coord = []
    for dim in reversed(shape):
        coord.append(idx % dim)
        idx //= dim
    return tuple(reversed(coord))


def axis_permuted_placement(mesh: MeshConfig, topo: Topology,
                            perm: Tuple[int, ...]) -> Placement:
    """Lay logical ranks out row-major over the mesh axes reordered by
    ``perm`` — i.e. make ``perm[-1]`` the physically innermost axis."""
    shape = mesh.shape
    pshape = tuple(shape[a] for a in perm)
    accel = topo.accelerators
    devices = []
    for r in range(mesh.num_devices):
        coord = _unravel(r, shape)
        devices.append(accel[_ravel([coord[a] for a in perm], pshape)])
    return Placement(mesh=mesh, devices=tuple(devices),
                     strategy=f"axis_perm{perm}", topology=topo.name)


def balanced_placement(mesh: MeshConfig, topo: Topology
                       ) -> Optional[Placement]:
    """Host-balanced model-axis communicators: split each TP group (size
    ``mesh.tp``) as evenly as possible across the fewest hosts that can
    hold it, preferring the emptiest hosts.  The groups are the mesh's
    actual model-axis communicators — any axis order, not just the
    model-innermost convention.

    Returns None when the topology has no host structure, the mesh is
    pure-DP (group size 1 — packed/strided already cover that family),
    or the cluster cannot hold the groups."""
    g = max(1, mesh.tp)
    n = mesh.num_devices
    if not topo.hosts or g <= 1 or n > len(topo.accelerators):
        return None
    # the model-axis communicators as logical-rank groups: an identity
    # placement's model_groups() are exactly them, for any axis order
    ident = Placement(mesh=mesh, devices=tuple(range(n)),
                      strategy="packed", topology=topo.name)
    free: List[List[int]] = [list(h) for h in topo.hosts]
    devices: List[Optional[int]] = [None] * n
    for group in ident.model_groups():
        order = sorted(range(len(free)), key=lambda h: (-len(free[h]), h))
        max_free = len(free[order[0]])
        if max_free == 0:
            return None
        # fewest hosts that can hold the group under an even split ...
        chosen = order[:math.ceil(g / max_free)]
        if sum(len(free[h]) for h in chosen) < g:
            # ... falling back to a greedy fill when tails are uneven
            chosen = []
            for h in order:
                chosen.append(h)
                if sum(len(free[x]) for x in chosen) >= g:
                    break
            else:
                return None
        # Size the shares largest-host-first: an even ceil split, but never
        # below what the remaining hosts cannot absorb — so a small host
        # capping its share backfills onto the larger ones (free [8, 4]
        # with g=12 must yield 8+4, not a failed 6+6).
        order_desc = sorted(chosen, key=lambda h: (-len(free[h]), h))
        shares: dict = {}
        remaining = g
        for i, h in enumerate(order_desc):
            rest = sum(len(free[x]) for x in order_desc[i + 1:])
            even = -(-remaining // (len(order_desc) - i))  # ceil div
            shares[h] = min(len(free[h]), max(even, remaining - rest))
            remaining -= shares[h]
        if remaining:
            return None
        chosen.sort()  # group members in host order -> minimal crossings
        alloc: List[int] = []
        for h in chosen:
            alloc.extend(free[h][:shares[h]])
            free[h] = free[h][shares[h]:]
        for rank, dev in zip(group, alloc):
            devices[rank] = dev
    return Placement(mesh=mesh, devices=tuple(devices),  # type: ignore
                     strategy="balanced", topology=topo.name)


def heuristic_placements(mesh: MeshConfig, topo: Topology,
                         seeds: Sequence[Union[str, Placement]] = ()
                         ) -> List[Placement]:
    """The deterministic candidate sweep for ``placement=Search()``:
    packed first (the attribution baseline — ties resolve to it), then
    host-balanced, strided, every non-identity axis permutation, and any
    caller seeds.  Duplicates (same device tuple) are dropped."""
    cands: List[Placement] = []
    devsets = set()

    def add(pl: Optional[Placement]) -> None:
        if pl is not None and pl.devices not in devsets:
            devsets.add(pl.devices)
            cands.append(pl)

    add(place_mesh(mesh, topo, "packed"))
    add(balanced_placement(mesh, topo))
    try:
        add(place_mesh(mesh, topo, "strided"))
    except ValueError:
        pass
    if len(mesh.shape) > 1:
        identity = tuple(range(len(mesh.shape)))
        for perm in itertools.permutations(range(len(mesh.shape))):
            if perm != identity:
                add(axis_permuted_placement(mesh, topo, perm))
    for seed in seeds:
        add(seed if isinstance(seed, Placement)
            else place_mesh(mesh, topo, strategy=seed))
    return cands


def swap_neighbors(pl: Placement, topo: Topology,
                   report: Optional[CodesignReport] = None
                   ) -> Iterator[Placement]:
    """The local-refinement neighborhood of ``pl``: first move each rank
    onto an unused accelerator, then exchange rank pairs.  When the
    incumbent's :class:`CodesignReport` is given, ranks whose devices
    touch the hottest links go first — the moves most likely to relieve
    the bottleneck are tried (and charged against the search budget)
    earliest.  Deterministic: ties break on rank index."""
    devices = pl.devices
    n = len(devices)
    used = set(devices)
    unused = [d for d in topo.accelerators if d not in used]

    heat = {}
    if report is not None:
        for (u, v), nbytes in report.link_hotspots:
            for node in (u, v):
                if node in used:
                    heat[node] = heat.get(node, 0.0) + nbytes
    rank_order = sorted(range(n),
                        key=lambda r: (-heat.get(devices[r], 0.0), r))

    for r in rank_order:
        for d in unused:
            nd = list(devices)
            nd[r] = d
            yield Placement(mesh=pl.mesh, devices=tuple(nd),
                            strategy=f"swap(r{r}->{d})",
                            topology=pl.topology)
    for i_pos, i in enumerate(rank_order):
        for j in rank_order[i_pos + 1:]:
            nd = list(devices)
            nd[i], nd[j] = nd[j], nd[i]
            yield Placement(mesh=pl.mesh, devices=tuple(nd),
                            strategy=f"swap(r{i}<->r{j})",
                            topology=pl.topology)
