"""The device mesh of a multi-rank run (counterpart of
``repro.launch.mesh``).

The JAX package builds a ``jax.sharding.Mesh`` over devices; the port's
ranks are the processes of an initialised ``torch.distributed`` group.  A
``(data, model)`` mesh of ``dp x tp`` ranks puts rank ``d * tp + m`` at
data index d and model index m, the row-major device order of
``jax.make_mesh``; a ``(pod, data, model)`` mesh puts rank ``(p * data +
d) * tp + m`` at (p, d, m), and its data axes are pod and data together
(the batch axes of the JAX package's specs).  The data axes carry data
parallelism; a model axis larger than 1 carries tensor parallelism of
every layer (``parallel.tensor``) and, for a MoE config, expert
parallelism of its experts beside it (``models.moe``).

``production_world`` stands for the JAX package's ``make_production_mesh``
(a mesh over 256 or 512 forced host devices): a ``torch.distributed``
world of that size on the ``fake`` backend of
``torch.testing._internal.distributed.fake_pg``, joined as one rank.  Its
collectives complete at once and move nothing, and no device is touched;
with meta tensors (``ccl.primitives._permute``'s meta branch) the port's
code runs one rank's share of a production mesh on the host
(``launch.dryrun``).
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.core.types import (MULTI_POD_MESH, SINGLE_POD_MESH,
                                    MeshConfig)
from repro_torch.launch.ranks import torus_groups


def mesh_config(*, multi_pod: bool = False) -> MeshConfig:
    return MULTI_POD_MESH if multi_pod else SINGLE_POD_MESH


def smoke_mesh_config() -> MeshConfig:
    return MeshConfig(shape=(1, 1))


def fake_world(world_size: int, rank: int = 0) -> None:
    """Initialises ``torch.distributed`` as rank ``rank`` of a world of
    ``world_size`` on the ``fake`` backend (no peers, no transport)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(),
                            world_size=world_size, rank=rank)


def production_world(*, multi_pod: bool = False, rank: int = 0
                     ) -> MeshConfig:
    """The production mesh as a fake world (``fake_world``) of 256 ranks
    (16 x 16) or 512 (2 x 16 x 16), joined as ``rank``; returns its
    ``MeshConfig``.  ``dist.destroy_process_group()`` ends it."""
    mesh_cfg = mesh_config(multi_pod=multi_pod)
    fake_world(mesh_cfg.num_devices, rank)
    return mesh_cfg


def mesh_groups(mesh_cfg: MeshConfig):
    """(data group, model group) of this rank on a ``(data, model)`` or
    ``(pod, data, model)`` mesh over the default group: the ranks of its
    model index (over every data axis), and the ranks of its data index.
    On a data-only mesh (model axis 1) both are ``None``: the data axes are
    the default group, and nothing calls a collective over the model axis.
    Every rank calls it, in the same order."""
    _check_size(mesh_cfg)
    if len(mesh_cfg.shape) not in (2, 3) or \
            tuple(mesh_cfg.model_axes) != mesh_cfg.axis_names[-1:] or \
            mesh_cfg.dp * mesh_cfg.tp != mesh_cfg.num_devices:
        raise ValueError(f"want a (data, model) or (pod, data, model) mesh, "
                         f"got {mesh_cfg}")
    if mesh_cfg.tp == 1:
        return None, None
    return torus_groups(mesh_cfg.dp, mesh_cfg.tp)


def _check_size(mesh_cfg: MeshConfig) -> None:
    n = dist.get_world_size()
    if n != mesh_cfg.num_devices:
        raise ValueError(f"mesh {mesh_cfg.shape} needs "
                         f"{mesh_cfg.num_devices} ranks, the group has {n}")
