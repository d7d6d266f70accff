"""FSDP (ZeRO-3) as a path: parameters sharded over the data axes and
gathered on demand.

In the JAX package FSDP is a set of specs (``parallel.planner.apply_fsdp``:
each leaf also over the data axes on its first free dim they divide) and
XLA places the all-gathers of the weights before their uses and the
reduce-scatters of their gradients.  The port places them by hand:

- ``fsdp_layout`` is what ``apply_fsdp`` decides, leaf by leaf of the
  port's tree: the dim a leaf is sharded on (``None``: no free dim that
  the data axes divide, the leaf replicated) and whether it is an expert
  weight.  The model axis's split (``parallel.tensor``, the experts under
  expert parallelism) is kept beside it: a rank holds the data-axis block
  of its model-axis block;
- ``fsdp_shard`` cuts this rank's shard out of the tree that
  ``shard_params`` gives (for example from ``bridge.params_from_jax``),
  ``fsdp_gather`` undoes it;
- ``gather_tree`` is what the model calls before a layer (or the
  embedding, or the head) runs: the layer's shards of one dtype
  flattened into one buffer and gathered by one ``ring_all_gather`` over
  the data group (``_Gather``: the layer is FSDP's unit, one collective a
  layer and not one a leaf), and backward the gradients cut the same way
  and reduce-scattered by one ``ring_reduce_scatter`` onto this rank's
  shards.  The gathered weights live as long as the layer's graph needs
  them; a checkpointed layer (``remat``) gathers them again when it is
  recomputed.

Weight-stationary expert-parallel decode (``ep_weight_stationary``) keeps
the experts sharded: their slices of the ffn dim over the data ranks
(``planner.ffn_slice``) are the shards, and nothing gathers them, as the
JAX package's comment on that flag says.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.ccl import primitives as prim
from repro_torch.core.types import MeshConfig, ModelConfig
from repro_torch.parallel.planner import (_bspec, _unflatten_like,
                                          _with_paths, apply_fsdp,
                                          expert_flags, param_shapes,
                                          param_specs)

Layout = Dict[str, Tuple[Optional[int], bool]]


def fsdp_layout(cfg: ModelConfig, mesh_cfg: MeshConfig) -> Layout:
    """(the dim that ``apply_fsdp`` shards over the data axes or ``None``,
    whether the leaf is an expert weight) of every leaf of the port's
    parameter tree, by path."""
    return _layout(cfg, mesh_cfg)


@functools.lru_cache(maxsize=16)
def _layout(cfg: ModelConfig, mesh_cfg: MeshConfig) -> Layout:
    shapes = param_shapes(cfg)
    specs = apply_fsdp(param_specs(cfg, mesh_cfg, shapes=shapes), shapes,
                       mesh_cfg)
    b = _bspec(mesh_cfg)
    return {path: (next((i for i, ax in enumerate(sp) if ax == b), None),
                   e)
            for (path, sp), e in zip(_with_paths(specs),
                                     expert_flags(shapes))}


def _dim(ctx, path: str) -> Optional[int]:
    """The dim of the leaf at ``path`` that ``ctx`` holds a shard of."""
    dim, expert = ctx.fsdp[path]
    if ctx.dp == 1 or (expert and ctx.ep_weight_stationary):
        return None
    return dim


def sharded_flags(params, ctx) -> list:
    """One flag a leaf of ``params``, in ``param_leaves`` order: set where
    the leaf is this rank's shard over the data axes."""
    return [_dim(ctx, path) is not None for path, _ in _with_paths(params)]


def _block(t: torch.Tensor, dim: int, ctx) -> torch.Tensor:
    n = t.shape[dim]
    if n % ctx.dp:
        raise ValueError(f"a dim of {n} does not split over {ctx.dp} data "
                         f"ranks")
    return t.narrow(dim, ctx.rank * (n // ctx.dp), n // ctx.dp).clone(
        memory_format=torch.contiguous_format)


def fsdp_shard(params, ctx):
    """This rank's FSDP shard of ``params``, the tree that
    ``parallel.shard_params`` gives (its model-axis part): each leaf that
    ``fsdp_layout`` shards cut to its ``ctx.rank``-th of ``ctx.dp`` equal
    blocks along its dim (a contiguous copy), every other leaf the same
    tensor."""
    return _unflatten_like(params, [
        t if _dim(ctx, path) is None else _block(t, _dim(ctx, path), ctx)
        for path, t in _with_paths(params)])


def _gather(shards, dims, group, dp) -> list:
    """Shards of one dtype gathered over the data group by one
    ``ring_all_gather`` of their flat concatenation, each put back
    together along its dim."""
    got = prim.ring_all_gather(torch.cat([t.reshape(-1) for t in shards]),
                               group)
    out, at = [], 0
    for t, dim in zip(shards, dims):
        n = t.numel()
        part = got[:, at:at + n].reshape(dp, *t.shape)
        out.append(part.movedim(0, dim).flatten(dim, dim + 1))
        at += n
    return out


class _Gather(torch.autograd.Function):
    """Shards of one dtype gathered over the data group along their dims;
    their gradients reduce-scattered back onto the shards (the sums over
    the data ranks), by one collective each way."""

    @staticmethod
    def forward(c, dims, group, dp, *shards):
        c.dims, c.group, c.dp = dims, group, dp
        c.shapes = [t.shape for t in shards]
        c.like = shards[0].new_empty(())  # the dtype and device
        return tuple(_gather(shards, dims, group, dp))

    @staticmethod
    def backward(c, *grads):
        parts = []
        for g, dim, shape in zip(grads, c.dims, c.shapes):
            if g is None:  # a leaf the layer did not use
                full = list(shape)
                full[dim] *= c.dp
                g = c.like.new_zeros(full)
            parts.append(torch.stack(g.chunk(c.dp, dim=dim)).reshape(
                c.dp, -1))
        red = prim.ring_reduce_scatter(torch.cat(parts, dim=1), c.group)
        out, at = [], 0
        for shape in c.shapes:
            n = shape.numel()
            out.append(red[at:at + n].view(shape))
            at += n
        return (None, None, None, *out)


def gather_tree(tree, ctx, prefix: str):
    """The leaves of ``tree`` (the subtree at ``prefix`` of this rank's
    parameters, or a single leaf) with every shard gathered over the data
    group, one ``_Gather`` a dtype; the tree itself where ``ctx`` runs no
    FSDP."""
    if not getattr(ctx, "fsdp", None):
        return tree
    leaves = [(prefix + path, t) for path, t in _with_paths(tree)]
    out = [t for _, t in leaves]
    groups: dict = {}
    for i, (path, t) in enumerate(leaves):
        if _dim(ctx, path) is not None:
            groups.setdefault(t.dtype, []).append(i)
    for idx in groups.values():
        got = _Gather.apply(tuple(_dim(ctx, leaves[i][0]) for i in idx),
                            ctx.group, ctx.dp, *(out[i] for i in idx))
        for i, g in zip(idx, got):
            out[i] = g
    return out[0] if isinstance(tree, torch.Tensor) else \
        _unflatten_like(tree, out)


def fsdp_gather(params, ctx):
    """The inverse of ``fsdp_shard``: every shard gathered from the data
    ranks, no graph recorded.  Every rank of the data group calls it and
    gets the same tree."""
    with torch.no_grad():
        return _unflatten_like(params, [
            t if _dim(ctx, path) is None
            else _gather([t], [_dim(ctx, path)], ctx.group, ctx.dp)[0]
            for path, t in _with_paths(params)])
