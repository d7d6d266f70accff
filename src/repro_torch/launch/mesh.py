"""The device mesh of a multi-rank run (counterpart of
``repro.launch.mesh``).

The JAX package builds a ``jax.sharding.Mesh`` over devices; the port's
ranks are the processes of an initialised ``torch.distributed`` group, and
only the data axes run here: the data-axis group is the whole group.  A
model axis larger than 1 (tensor parallelism, and with it pipeline and
collective matmul) waits for ROADMAP item 8.
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.core.types import MeshConfig


def check_data_only(mesh_cfg: MeshConfig) -> None:
    """Raises where the mesh has a model axis larger than 1."""
    if mesh_cfg.tp > 1:
        raise NotImplementedError(
            f"a model axis of {mesh_cfg.tp} (tensor parallelism) is not "
            f"ported yet: ROADMAP item 8")


def data_group(mesh_cfg: MeshConfig, group=None):
    """The process group of ``mesh_cfg``'s data axes, from ``group`` (the
    default group when ``None``), which must hold ``mesh_cfg.num_devices``
    ranks."""
    check_data_only(mesh_cfg)
    n = dist.get_world_size(group)
    if n != mesh_cfg.num_devices:
        raise ValueError(f"mesh {mesh_cfg.shape} needs "
                         f"{mesh_cfg.num_devices} ranks, the group has {n}")
    return group
