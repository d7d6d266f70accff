"""Placement layer: logical mesh coordinates -> physical accelerators.

The seed's ``core.demand_builder`` emits logical rank groups
(``range(tp)`` / ``range(dp)``) that never touched a ``net.Topology``;
here we close that gap.  A :class:`Placement` is a bijection from logical
global ranks (row-major over ``MeshConfig.shape``) to physical device ids
of a topology, so every ``CommTask.group`` can be resolved to real devices
before the CCL layer prices algorithms on real links.

Strategies:
  * ``packed``  — logical rank r -> r-th accelerator.  With the model axis
    innermost (the MeshConfig convention) TP groups land on consecutive
    devices, i.e. inside one host on DGX/fat-tree topologies.
  * ``strided`` — round-robin across hosts: consecutive logical ranks land
    on different hosts.  The anti-pattern baseline that scatters TP groups
    over the NIC tier (what topology-oblivious placement can do to you).
  * ``custom``  — caller-provided rank -> device tuple.

The port's copy of ``repro.codesign.placement``, kept line for line:
importing any ``repro`` module runs the JAX package's ``__init__``, which
imports jax, so the port keeps its own.
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.demand import CommDemand, CommTask
from repro_torch.core.types import MeshConfig
from repro_torch.net.topology import Topology


@dataclass(frozen=True)
class Placement:
    """Maps logical global ranks onto physical device ids."""

    mesh: MeshConfig
    devices: Tuple[int, ...]  # logical rank (row-major) -> physical device
    strategy: str = "packed"
    topology: str = "custom"

    def __post_init__(self):
        if len(self.devices) != self.mesh.num_devices:
            raise ValueError(
                f"placement covers {len(self.devices)} devices but mesh "
                f"{self.mesh.shape} has {self.mesh.num_devices}")
        if len(set(self.devices)) != len(self.devices):
            raise ValueError("placement maps two logical ranks to the same "
                             "physical device")

    # ------------------------------------------------------------------
    def device(self, rank: int) -> int:
        return self.devices[rank]

    def _axis_groups(self, axes: Sequence[str]) -> List[Tuple[int, ...]]:
        """Physical-device groups of the communicators spanning ``axes``
        (one group per assignment of the remaining axes)."""
        mesh = self.mesh
        idx = [mesh.axis_names.index(a) for a in axes]
        other = [i for i in range(len(mesh.shape)) if i not in idx]
        groups: List[Tuple[int, ...]] = []
        for fixed in itertools.product(*[range(mesh.shape[i])
                                         for i in other]):
            members: List[int] = []
            for var in itertools.product(*[range(mesh.shape[i])
                                           for i in idx]):
                coord = [0] * len(mesh.shape)
                for i, v in zip(other, fixed):
                    coord[i] = v
                for i, v in zip(idx, var):
                    coord[i] = v
                rank = 0
                for dim, c in zip(mesh.shape, coord):
                    rank = rank * dim + c
                members.append(self.devices[rank])
            groups.append(tuple(members))
        return groups

    def model_groups(self) -> List[Tuple[int, ...]]:
        """TP communicators (one per data-parallel replica)."""
        return self._axis_groups(self.mesh.model_axes)

    def data_groups(self) -> List[Tuple[int, ...]]:
        """DP communicators (one per model shard)."""
        return self._axis_groups(self.mesh.data_axes)

    # ------------------------------------------------------------------
    def place_group(self, group: Sequence[int],
                    axis: Optional[str] = None,
                    replica: int = 0) -> Tuple[int, ...]:
        """Resolve a logical group to physical devices.

        ``axis`` (from ``CommTask.axis``) disambiguates: "model"/"data"
        pick the ``replica``-th communicator along those mesh axes (the
        demand builder emits one representative group per axis — all
        replicas run the same collective concurrently).  Without an axis
        tag we fall back to size inference, then to rank-wise mapping."""
        p = len(group)
        if axis == "model" or (axis is None and p == self.mesh.tp
                               and p != self.mesh.num_devices):
            cands = self.model_groups()
        elif axis == "data" or (axis is None and p == self.mesh.dp
                                and p != self.mesh.num_devices):
            cands = self.data_groups()
        elif axis in ("all", None) and p == self.mesh.num_devices:
            return tuple(self.devices)
        else:
            cands = None
        if cands is not None:
            g = cands[replica % len(cands)]
            if len(g) != p:
                raise ValueError(
                    f"group of {p} does not match the {axis!r}-axis "
                    f"communicator size {len(g)} of mesh {self.mesh.shape}")
            return g
        if max(group) >= self.mesh.num_devices:
            raise ValueError(
                f"cannot place group {group!r}: ranks exceed mesh size "
                f"{self.mesh.num_devices} and no axis tag was given")
        return tuple(self.devices[r] for r in group)

    def place_task(self, task: CommTask, replica: int = 0) -> CommTask:
        return dataclasses.replace(
            task, group=self.place_group(task.group, task.axis, replica))

    def place_demand(self, demand: CommDemand, replica: int = 0
                     ) -> CommDemand:
        """New CommDemand with every comm task's group resolved to physical
        device ids (compute tasks are device-agnostic and pass through)."""
        placed = CommDemand(comm_tasks=[self.place_task(t, replica)
                                        for t in demand.comm_tasks],
                            compute_tasks=list(demand.compute_tasks),
                            job_id=demand.job_id)
        return placed


def place_mesh(mesh: MeshConfig, topo: Topology, strategy: str = "packed",
               custom: Optional[Sequence[int]] = None) -> Placement:
    """Build a Placement of ``mesh`` onto ``topo``'s accelerators."""
    n = mesh.num_devices
    accel = topo.accelerators
    if n > len(accel):
        raise ValueError(f"mesh {mesh.shape} needs {n} devices but "
                         f"{topo.name} has {len(accel)}")
    if strategy == "custom":
        if custom is None:
            raise ValueError("strategy='custom' requires custom=<devices>")
        devices = tuple(custom)
        bad = set(devices) - set(accel)
        if bad:
            raise ValueError(f"custom placement uses non-accelerator "
                             f"devices {sorted(bad)} on {topo.name}")
    elif strategy == "packed":
        devices = tuple(accel[:n])
    elif strategy == "strided":
        if topo.hosts:
            # round-robin over hosts: rank r -> host r % H
            order = [h for hosts in itertools.zip_longest(*topo.hosts)
                     for h in hosts if h is not None]
        else:
            # hostless fabric: interleave with a stride of the innermost
            # (model) axis size so that communicator is spread apart
            stride = max(1, mesh.shape[-1])
            order = [accel[off + k] for off in range(stride)
                     for k in range(0, len(accel) - off, stride)]
        devices = tuple(order[:n])
    else:
        raise ValueError(f"unknown placement strategy {strategy!r} "
                         f"(packed | strided | custom)")
    return Placement(mesh=mesh, devices=devices, strategy=strategy,
                     topology=topo.name)
