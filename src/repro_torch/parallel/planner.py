"""Data- and expert-parallel context and gradient layout of the port: the
part of ``repro.parallel.planner`` that the port runs.

The JAX package threads a ``ParallelCtx`` holding a mesh through its model
code and lets XLA's sharding propagation place the collectives: plain DP
parameter specs give a gradient all-reduce, ZeRO-1 optimizer-state specs
(``zero1_spec``) a reduce-scatter and an all-gather, and the expert specs
of ``param_specs`` (experts over the model axis) put each expert's weights
on one model rank.  Here the context holds the process groups of the data
axes and of the model axis instead, and the step and the MoE layers call
the collectives themselves (``repro_torch.train.make_train_step``,
``repro_torch.models.moe``):

- ``make_ctx`` builds the context from the groups and a ``MeshConfig``;
- ``microbatch_rows`` is the batch shard of ``batch_specs``;
- ``shard_params`` cuts a rank's experts out of the full parameters, the
  layouts of ``param_specs``: under expert parallelism each MoE layer's
  ``w_gate``, ``w_up``, ``w_down`` as ``(E/tp, ...)``, model rank m
  holding experts ``m E/tp .. (m+1) E/tp - 1``; weight-stationary, also
  the ffn dim over the data axes;
- ``FlatLayout`` is the gradient of this rank's leaves flattened into the
  planner's 64 MiB buckets, with the chunk of each bucket that
  ``ring_reduce_scatter`` leaves on this rank: the ZeRO-1 shard of the
  optimizer state.

Tensor parallelism of the dense layers (a model axis without MoE) is not
ported: ROADMAP item 8.
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
    """What the model and the step need to know of the mesh.

    ``group`` is the process group of the data axes (``None``: the default
    group), ``rank`` this process's rank in it and ``dp`` its size;
    ``model_group``, ``model_rank`` and ``tp`` the same of the model axis
    (``model_group`` ``None`` where ``tp`` is 1).  ``grad_all_reduce``
    names the entry of ``ccl.primitives.IMPLEMENTATIONS`` that carries a
    plain-DP gradient sync.  ``use_ep``: the MoE layers run expert-parallel
    over the model axis (``models.moe.moe_apply``), with the JAX package's
    capacity factors and ``ep_weight_stationary`` decode.
    """

    group: Any = None
    rank: int = 0
    dp: int = 1
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    model_group: Any = None
    model_rank: int = 0
    tp: int = 1
    remat: bool = True
    use_ep: bool = False
    capacity_factor: float = 1.25
    decode_capacity_factor: float = 4.0
    ep_weight_stationary: bool = False
    grad_all_reduce: str = "ring"

    @property
    def ep_axis(self) -> str:
        return self.model_axis

    def allsum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the data ranks, the same bits on every
        rank: ``ring_all_gather`` then a sum in rank order.  For the
        scalars and small vectors of a step (losses, squared norms, routing
        fractions); on a gloo group ``_permute`` copies them through the
        host, the transport of gloo."""
        if self.dp == 1:
            return x
        return prim.ring_all_gather(x, self.group).sum(dim=0)

    def model_allsum(self, x: torch.Tensor) -> torch.Tensor:
        """``allsum`` over the model ranks."""
        if self.tp == 1:
            return x
        return prim.ring_all_gather(x, self.model_group).sum(dim=0)


def make_ctx(group, mesh_cfg: MeshConfig, *, model_group=None,
             remat: bool = True, use_ep: Optional[bool] = None,
             capacity_factor: float = 1.25,
             decode_capacity_factor: float = 4.0,
             ep_weight_stationary: bool = False,
             grad_all_reduce: str = "ring") -> ParallelCtx:
    """The context of this rank in ``group`` (the data axes of
    ``mesh_cfg``) and ``model_group`` (its model axis);
    ``repro_torch.launch.mesh.mesh_groups`` builds both.

    ``use_ep`` defaults to ``mesh_cfg.tp > 1``: the port runs a model axis
    only expert-parallel, and with a model axis of 1 expert parallelism
    would only add capacity drops (the JAX package's default, ``True``,
    drops tokens there too; pass ``use_ep=True`` for that).  A model axis
    without it is tensor parallelism: ROADMAP item 8."""
    if grad_all_reduce not in prim.IMPLEMENTATIONS:
        raise KeyError(f"unknown all-reduce {grad_all_reduce!r}; known: "
                       f"{sorted(prim.IMPLEMENTATIONS)}")
    tp = mesh_cfg.tp
    if use_ep is None:
        use_ep = tp > 1
    if tp > 1 and not use_ep:
        raise NotImplementedError(
            f"a model axis of {tp} without expert parallelism is tensor "
            f"parallelism, not ported yet: ROADMAP item 8")
    dp = dist.get_world_size(group)
    if dp != mesh_cfg.dp:
        raise ValueError(f"the group has {dp} ranks, the mesh's data axes "
                         f"{mesh_cfg.data_axes} {mesh_cfg.dp}")
    if tp > 1 and (model_group is None
                   or dist.get_world_size(model_group) != tp):
        raise ValueError(f"a model axis of {tp} needs its model group "
                         f"(launch.mesh.mesh_groups)")
    return ParallelCtx(
        group=group, rank=dist.get_rank(group), dp=dp,
        data_axes=tuple(mesh_cfg.data_axes),
        model_axis=mesh_cfg.model_axes[0],
        model_group=model_group if tp > 1 else None,
        model_rank=dist.get_rank(model_group) if tp > 1 else 0, tp=tp,
        remat=remat, use_ep=use_ep, capacity_factor=capacity_factor,
        decode_capacity_factor=decode_capacity_factor,
        ep_weight_stationary=ep_weight_stationary,
        grad_all_reduce=grad_all_reduce)


# ---------------------------------------------------------------------------
# Expert layouts (the MoE rules of ``param_specs``)
# ---------------------------------------------------------------------------

EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def expert_flags(tree, _expert: bool = False) -> List[bool]:
    """One flag a leaf of a parameter tree (or m or v), in
    ``param_leaves`` order: set for the expert weights of the MoE layers
    (the ``w_gate``, ``w_up``, ``w_down`` of a dict holding a
    ``router``), which expert parallelism shards; shared experts and the
    router are replicated."""
    if isinstance(tree, dict):
        moe = "router" in tree
        return [f for k, v in tree.items()
                for f in expert_flags(v, moe and k in EXPERT_LEAVES)]
    if isinstance(tree, list):
        return [f for v in tree for f in expert_flags(v)]
    return [_expert]


def sharded_experts(ctx: Optional[ParallelCtx]) -> bool:
    """Whether ``ctx`` keeps a part of each expert weight on a rank."""
    return ctx is not None and ctx.use_ep and (
        ctx.tp > 1 or (ctx.ep_weight_stationary and ctx.dp > 1))


def expert_range(num_experts: int, ctx: ParallelCtx) -> Tuple[int, int]:
    """[lo, hi): the experts of this model rank, ``model_rank E/tp ..``."""
    if num_experts % ctx.tp:
        raise ValueError(f"{num_experts} experts do not split over a model "
                         f"axis of {ctx.tp}")
    el = num_experts // ctx.tp
    return ctx.model_rank * el, (ctx.model_rank + 1) * el


def ffn_slice(name: str, w: torch.Tensor, ctx: ParallelCtx) -> torch.Tensor:
    """A contiguous copy of this rank's experts ``w`` (K5 wants its
    weights contiguous), weight-stationary only the ``rank``-th of dp
    slices of the ffn dim: (E/tp, d, ff/dp) for ``w_gate``/``w_up``,
    (E/tp, ff/dp, d) for ``w_down``."""
    if ctx.ep_weight_stationary and ctx.dp > 1:
        dim = 1 if name == "w_down" else 2
        ff = w.shape[dim]
        if ff % ctx.dp:
            raise ValueError(f"an ffn dim of {ff} does not split over "
                             f"{ctx.dp} data ranks")
        w = w.narrow(dim, ctx.rank * (ff // ctx.dp), ff // ctx.dp)
    return w.clone(memory_format=torch.contiguous_format)


def expert_shard(name: str, w: torch.Tensor, ctx: ParallelCtx
                 ) -> torch.Tensor:
    """This rank's part of the full expert weight ``w`` (``name`` one of
    ``EXPERT_LEAVES``): its experts (``expert_range``), weight-stationary
    its slice of the ffn dim (``ffn_slice``)."""
    lo, hi = expert_range(w.shape[0], ctx)
    return ffn_slice(name, w[lo:hi], ctx)


def shard_params(params, ctx: Optional[ParallelCtx]):
    """The tree with each expert weight replaced by this rank's part
    (``expert_shard``); every other leaf is the same tensor.  Without
    sharded experts the tree itself."""
    if not sharded_experts(ctx):
        return params
    if isinstance(params, list):
        return [shard_params(v, ctx) for v in params]
    if not isinstance(params, dict):
        return params
    moe = "router" in params
    return {k: expert_shard(k, v, ctx) if moe and k in EXPERT_LEAVES
            else shard_params(v, ctx) for k, v in params.items()}


def gather_params(params, ctx: Optional[ParallelCtx]):
    """The inverse of ``shard_params``: each expert weight gathered from
    the ranks that hold its parts (the model group, and weight-stationary
    the data group), every other leaf the same tensor.  Every rank calls
    it and gets the full tree."""
    if not sharded_experts(ctx):
        return params
    if isinstance(params, list):
        return [gather_params(v, ctx) for v in params]
    if not isinstance(params, dict):
        return params
    moe = "router" in params
    return {k: _gather_expert(k, v, ctx) if moe and k in EXPERT_LEAVES
            else gather_params(v, ctx) for k, v in params.items()}


def _gather_expert(name: str, w: torch.Tensor, ctx: ParallelCtx
                   ) -> torch.Tensor:
    if ctx.ep_weight_stationary and ctx.dp > 1:
        dim = 1 if name == "w_down" else 2
        w = torch.cat(prim.ring_all_gather(w, ctx.group).unbind(0), dim=dim)
    if ctx.tp > 1:
        w = prim.ring_all_gather(w, ctx.model_group).flatten(0, 1)
    return w


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
    """This rank's parameter leaves (under expert parallelism its own
    experts) flattened in ``param_leaves`` order and cut
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

    def shard_ranges(self, flags: Sequence[bool]) -> List[Tuple[int, int]]:
        """The [start, stop) ranges of ``shard``'s result that hold values
        of the leaves whose flag is set (``expert_flags``)."""
        offsets = [0]
        for s in self.shapes:
            offsets.append(offsets[-1] + math.prod(s))
        flagged = [(offsets[i], offsets[i + 1])
                   for i, f in enumerate(flags) if f]
        out, at = [], 0
        for lo, hi in self.buckets:
            c = self.chunk(lo, hi)
            s0 = lo + self.rank * c
            s1 = min(s0 + c, hi)
            for a, b in flagged:
                a, b = max(a, s0), min(b, s1)
                if a < b:
                    out.append((at + a - s0, at + b - s0))
            at += c
        return out

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
