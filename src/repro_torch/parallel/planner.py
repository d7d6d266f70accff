"""Data-parallel context and gradient layout of the port: the data-axis part
of ``repro.parallel.planner``.

The JAX package threads a ``ParallelCtx`` holding a mesh through its model
code and lets XLA's sharding propagation place the collectives: plain DP
parameter specs give a gradient all-reduce, ZeRO-1 optimizer-state specs
(``zero1_spec``) a reduce-scatter and an all-gather.  Here the context holds
the data axis's process group instead, and the step calls the collectives
itself (``repro_torch.train.make_train_step``):

- ``make_ctx`` builds the context from a group and a ``MeshConfig``;
- ``microbatch_rows`` is the batch shard of ``batch_specs``;
- ``FlatLayout`` is the gradient flattened into the planner's 64 MiB
  buckets, with the chunk of each bucket that ``ring_reduce_scatter``
  leaves on this rank: the ZeRO-1 shard of the optimizer state.

Model and expert parallelism (the ``model`` axis) are not ported.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.ccl import primitives as prim
from repro_torch.core.types import MeshConfig

# the planner's gradient bucket (``plan_iteration(bucket_bytes=...)``), in
# f32 values: the dtype of the sums and of the moments
BUCKET_BYTES = 64 * 2 ** 20
BUCKET_VALUES = BUCKET_BYTES // 4


@dataclass
class ParallelCtx:
    """What the model and the step need to know of the data axes.

    ``group`` is the process group of the data axes (``None``: the default
    group), ``rank`` this process's rank in it and ``dp`` its size.
    ``grad_all_reduce`` names the entry of ``ccl.primitives.IMPLEMENTATIONS``
    that carries a plain-DP gradient sync."""

    group: Any = None
    rank: int = 0
    dp: int = 1
    data_axes: Tuple[str, ...] = ("data",)
    remat: bool = True
    use_ep: bool = False
    grad_all_reduce: str = "ring"

    def allsum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, the same bits on every rank:
        ``ring_all_gather`` then a sum in rank order.  For the scalars and
        small vectors of a step (losses, squared norms, routing
        fractions); on a gloo group ``_permute`` copies them through the
        host, the transport of gloo."""
        if self.dp == 1:
            return x
        return prim.ring_all_gather(x, self.group).sum(dim=0)


def make_ctx(group, mesh_cfg: MeshConfig, *, remat: bool = True,
             use_ep: bool = False, grad_all_reduce: str = "ring"
             ) -> ParallelCtx:
    """The context of this rank in ``group``, the data axes of
    ``mesh_cfg`` (``repro_torch.launch.mesh.data_group`` builds the
    group).  Expert parallelism waits for its port (ROADMAP item 10)."""
    if use_ep:
        raise NotImplementedError("expert-parallel MoE (use_ep=True) is "
                                  "not ported yet: ROADMAP item 10")
    if grad_all_reduce not in prim.IMPLEMENTATIONS:
        raise KeyError(f"unknown all-reduce {grad_all_reduce!r}; known: "
                       f"{sorted(prim.IMPLEMENTATIONS)}")
    dp = dist.get_world_size(group)
    if dp != mesh_cfg.dp:
        raise ValueError(f"the group has {dp} ranks, the mesh's data axes "
                         f"{mesh_cfg.data_axes} {mesh_cfg.dp}")
    return ParallelCtx(group=group, rank=dist.get_rank(group), dp=dp,
                       data_axes=tuple(mesh_cfg.data_axes), remat=remat,
                       use_ep=use_ep, grad_all_reduce=grad_all_reduce)


def microbatch_rows(batch_size: int, microbatches: int,
                    ctx: Optional[ParallelCtx] = None
                    ) -> List[Tuple[slice, slice]]:
    """(the microbatch's global rows, this rank's rows of it), one pair a
    microbatch.  Microbatch i is the global rows [i B/nmb, (i+1) B/nmb),
    as the JAX step splits the batch; within it rank r takes the r-th of
    ``dp`` equal parts, as ``batch_specs`` shards the batch dimension (with
    one microbatch: rows [r B/dp, (r+1) B/dp))."""
    dp, rank = (ctx.dp, ctx.rank) if ctx is not None else (1, 0)
    if batch_size % (microbatches * dp):
        raise ValueError(f"batch {batch_size} is not a multiple of "
                         f"{microbatches} microbatches x {dp} ranks")
    mb = batch_size // microbatches
    local = mb // dp
    return [(slice(i * mb, (i + 1) * mb),
             slice(i * mb + rank * local, i * mb + (rank + 1) * local))
            for i in range(microbatches)]


@dataclass(frozen=True)
class FlatLayout:
    """The parameter leaves flattened in ``param_leaves`` order and cut
    into buckets of ``BUCKET_VALUES``; each bucket is padded to a multiple
    of ``dp`` and split into ``dp`` chunks, and this rank owns chunk
    ``rank`` of each, the chunk ``ring_reduce_scatter`` leaves on it.

    The ZeRO-1 shard (``zero1_spec`` of the JAX package, which shards each
    stacked leaf of the optimizer state on its first free divisible dim) is
    the concatenation of this rank's chunks: the same per-element AdamW
    arithmetic on 1/dp of the state, padding included (zeros, which stay
    zeros)."""

    shapes: Tuple[Tuple[int, ...], ...]
    dp: int
    rank: int

    @property
    def numel(self) -> int:
        return sum(math.prod(s) for s in self.shapes)

    @property
    def buckets(self) -> List[Tuple[int, int]]:
        n = self.numel
        return [(lo, min(lo + BUCKET_VALUES, n))
                for lo in range(0, n, BUCKET_VALUES)]

    def chunk(self, lo: int, hi: int) -> int:
        """Values in each rank's chunk of the bucket [lo, hi)."""
        return -(-(hi - lo) // self.dp)

    @property
    def shard_numel(self) -> int:
        return sum(self.chunk(lo, hi) for lo, hi in self.buckets)

    def flatten(self, leaves: Sequence[torch.Tensor],
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """One flat tensor of every leaf, in ``dtype`` (default: the
        leaves' common dtype, promoted where they differ)."""
        flat = torch.cat([t.reshape(-1) for t in leaves])
        return flat if dtype is None else flat.to(dtype)

    def unflatten(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Views of ``flat`` shaped like the leaves."""
        sizes = [math.prod(s) for s in self.shapes]
        return [t.view(s) for t, s in zip(flat.split(sizes), self.shapes)]

    def _padded(self, flat: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """Bucket [lo, hi) of ``flat`` as (dp, chunk), zero-padded."""
        c = self.chunk(lo, hi)
        x = flat[lo:hi]
        pad = self.dp * c - (hi - lo)
        if pad:
            x = torch.cat([x, x.new_zeros(pad)])
        return x.view(self.dp, c)

    def shard(self, flat: torch.Tensor) -> torch.Tensor:
        """This rank's chunks of ``flat`` (no communication)."""
        return torch.cat([self._padded(flat, lo, hi)[self.rank]
                          for lo, hi in self.buckets])

    def reduce_scatter(self, flat: torch.Tensor, group) -> torch.Tensor:
        """Each bucket through ``ring_reduce_scatter``: this rank's chunks
        of the sum over the ranks."""
        return torch.cat([prim.ring_reduce_scatter(
            self._padded(flat, lo, hi), group) for lo, hi in self.buckets])

    def all_gather(self, shard: torch.Tensor, group) -> torch.Tensor:
        """Every rank's chunks back into one flat tensor, bucket by bucket
        through ``ring_all_gather`` (the inverse of ``shard``)."""
        out = shard.new_empty(self.numel)
        at = 0
        for lo, hi in self.buckets:
            c = self.chunk(lo, hi)
            got = prim.ring_all_gather(shard[at:at + c], group)
            out[lo:hi] = got.reshape(-1)[:hi - lo]
            at += c
        return out

    def all_reduce(self, flat: torch.Tensor, impl: str, group
                   ) -> torch.Tensor:
        """Each bucket through ``make_all_reduce(impl)``, in place."""
        fn = prim.make_all_reduce(impl, group)
        for lo, hi in self.buckets:
            flat[lo:hi] = fn(flat[lo:hi])
        return flat


def flat_layout(leaves: Sequence[torch.Tensor],
                ctx: Optional[ParallelCtx] = None) -> FlatLayout:
    dp, rank = (ctx.dp, ctx.rank) if ctx is not None else (1, 0)
    return FlatLayout(tuple(tuple(t.shape) for t in leaves), dp, rank)
