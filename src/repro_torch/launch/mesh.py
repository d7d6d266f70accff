"""The device mesh of a multi-rank run (counterpart of
``repro.launch.mesh``).

The JAX package builds a ``jax.sharding.Mesh`` over devices; the port's
ranks are the processes of an initialised ``torch.distributed`` group.  A
``(data, model)`` mesh of ``dp x tp`` ranks puts rank ``d * tp + m`` at
data index d and model index m, the row-major device order of
``jax.make_mesh``.  The data axes carry data parallelism; a model axis
larger than 1 carries tensor parallelism of every layer
(``parallel.tensor``) and, for a MoE config, expert parallelism of its
experts beside it (``models.moe``).
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.core.types import MeshConfig
from repro_torch.launch.ranks import torus_groups


def mesh_groups(mesh_cfg: MeshConfig):
    """(data group, model group) of this rank on a ``(data, model)`` mesh
    over the default group: the ranks of its model index, and the ranks of
    its data index.  On a data-only mesh (model axis 1) both are ``None``:
    the data axes are the default group, and nothing calls a collective
    over the model axis.  Every rank calls it, in the same order."""
    _check_size(mesh_cfg)
    if len(mesh_cfg.shape) != 2 or mesh_cfg.tp != mesh_cfg.shape[1]:
        raise ValueError(f"want a (data, model) mesh, got {mesh_cfg}")
    if mesh_cfg.tp == 1:
        return None, None
    return torus_groups(mesh_cfg.dp, mesh_cfg.tp)


def _check_size(mesh_cfg: MeshConfig) -> None:
    n = dist.get_world_size()
    if n != mesh_cfg.num_devices:
        raise ValueError(f"mesh {mesh_cfg.shape} needs "
                         f"{mesh_cfg.num_devices} ranks, the group has {n}")
