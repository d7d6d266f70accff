"""The device mesh of a multi-rank run (counterpart of
``repro.launch.mesh``).

The JAX package builds a ``jax.sharding.Mesh`` over devices; the port's
ranks are the processes of an initialised ``torch.distributed`` group.  A
``(data, model)`` mesh of ``dp x tp`` ranks puts rank ``d * tp + m`` at
data index d and model index m, the row-major device order of
``jax.make_mesh``.  The data axes carry data parallelism; a model axis
larger than 1 carries expert parallelism of the MoE layers of a MoE config
(``models.moe``), and tensor parallelism of the dense GQA and Mamba2
layers of the others (``parallel.tensor``).  The tensor parallelism of
MLA, cross-attention and the encoder waits for ROADMAP item 8b.
"""
from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from repro_torch.core.types import MeshConfig, ModelConfig
from repro_torch.launch.ranks import torus_groups
from repro_torch.parallel.planner import check_tensor_parallel


def check_model_axis(mesh_cfg: MeshConfig,
                     cfg: Optional[ModelConfig] = None) -> None:
    """Raises where the mesh has a model axis larger than 1 and ``cfg``
    (``None``: no config, nothing to check) has no MoE layer and layers
    whose tensor parallelism is not ported (``check_tensor_parallel``)."""
    if mesh_cfg.tp > 1 and cfg is not None and not cfg.is_moe:
        check_tensor_parallel(cfg)


def mesh_groups(mesh_cfg: MeshConfig, cfg: Optional[ModelConfig] = None):
    """(data group, model group) of this rank on a ``(data, model)`` mesh
    over the default group: the ranks of its model index, and the ranks of
    its data index.  On a data-only mesh (model axis 1) both are ``None``:
    the data axes are the default group, and nothing calls a collective
    over the model axis.  Every rank calls it, in the same order."""
    check_model_axis(mesh_cfg, cfg)
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
