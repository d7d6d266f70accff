"""Megatron tensor parallelism over the model axis: the collectives that
the JAX package's sharding propagation inserts for the specs of
``param_specs``, placed by hand.

In the JAX package a tensor-parallel layer is the single-device code with
sharded weights and an ``act_spec`` constraint on the residual stream, and
XLA adds the all-reduces.  Here every model rank runs the layer on its
block of the weights (``parallel.planner.tp_layout``), and the layer calls
the conjugate pair of Megatron-LM around each column-parallel /
row-parallel product:

- ``copy_to_model``: the identity forward, an all-reduce of the gradient
  backward: placed where a replicated activation enters the ranks' blocks
  (each rank's gradient of it is its blocks' part);
- ``reduce_from_model``: an all-reduce forward (the row-parallel partial
  sums), the identity backward (what follows is replicated: every rank
  holds the whole gradient of the one loss);
- ``sum_over_model``: an all-reduce both ways, for a sum whose terms feed
  rank-local values on every rank (the mean square of Mamba's gated norm
  over the whole ``d_inner``).

Each all-reduce is ``ccl.primitives.ring_all_reduce`` over
``ctx.model_group``: its hops go through ``_permute``, so the counters
see them, and every rank ends with the same bits.  Then the gather of
every rank's block of the last dim (``gather_from_model``: the
vocabulary-sharded logits before a token is picked, and Mamba's
``conv_x`` outputs in decode, where the cache splits the channels and not
the heads), and the vocabulary-parallel pieces: the embedding lookup on
this rank's rows (``vocab_embed``) and the cross-entropy of
vocabulary-sharded logits, whose max, sum of exponentials and label logit
are reduced over the model group without gathering the (B, S, V) logits
(``vocab_parallel_cross_entropy``, the small all-reduce of the JAX
package's loss).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.ccl import primitives as prim


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return prim.ring_all_reduce(g.contiguous(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return prim.ring_all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return prim.ring_all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return prim.ring_all_reduce(g.contiguous(), ctx.group), None


def copy_to_model(x: torch.Tensor, ctx) -> torch.Tensor:
    """``x`` itself; its gradient summed over the model ranks."""
    return _CopyToModel.apply(x, ctx.model_group)


def reduce_from_model(x: torch.Tensor, ctx) -> torch.Tensor:
    """The sum of ``x`` over the model ranks; the gradient passes as is."""
    return _ReduceFromModel.apply(x, ctx.model_group)


def sum_over_model(x: torch.Tensor, ctx) -> torch.Tensor:
    """The sum of ``x`` over the model ranks, its gradient summed too."""
    return _SumOverModel.apply(x, ctx.model_group)


def vocab_embed(embed: torch.Tensor, tokens: torch.Tensor, lo: int,
                ctx) -> torch.Tensor:
    """The embedding of ``tokens`` from this rank's rows ``embed``
    (vocabulary ids ``lo .. lo + rows - 1``): each rank looks up the
    tokens it holds, zeros for the others, and the ranks' lookups are
    summed (exactly: one term of each sum is not zero).  The gradient
    reaches only the rows looked up."""
    rows = embed.shape[0]
    mine = (tokens >= lo) & (tokens < lo + rows)
    local = torch.where(mine, tokens - lo, torch.zeros_like(tokens))
    x = embed[local]
    x = torch.where(mine[..., None], x, torch.zeros_like(x))
    return reduce_from_model(x, ctx)


def gather_from_model(x: torch.Tensor, ctx) -> torch.Tensor:
    """Every model rank's block of ``x`` (..., n/tp) side by side, in rank
    order: (..., n), the same bits on every rank (``ring_all_gather``)."""
    got = prim.ring_all_gather(x.contiguous(), ctx.model_group)
    return torch.cat(got.unbind(0), dim=-1)


def model_max(x: torch.Tensor, ctx) -> torch.Tensor:
    """The elementwise max of ``x`` over the model ranks (no gradient)."""
    return prim.ring_all_gather(x.detach().contiguous(),
                                ctx.model_group).amax(dim=0)


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 ctx, ignore_index: int = -1,
                                 count: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """``train.loss.cross_entropy`` of vocabulary-sharded logits: this
    model rank's block (B, S, V_pad/tp) of the logits, ids
    ``model_rank V_pad/tp ..``.  The logsumexp is m + log(sum exp(l - m))
    with m the max over the model ranks (a gather of (B, S) values), the
    sums of exponentials and the label logit (the one rank holding the
    label gives it, the others 0) all-reduced together; every rank
    returns the same loss, and its gradient reaches its own block of the
    logits.  The padded ids carry the LM head's -1e30 bias: exp gives 0,
    and being below every real logit they never set the max."""
    logits = logits.float()
    v_local = logits.shape[-1]
    lo = ctx.model_rank * v_local
    m = model_max(logits.amax(dim=-1), ctx)
    sum_exp = torch.exp(logits - m[..., None]).sum(dim=-1)
    lab = labels.clamp(min=0).long()
    mine = (lab >= lo) & (lab < lo + v_local)
    idx = torch.where(mine, lab - lo, torch.zeros_like(lab))
    true_logit = torch.take_along_dim(logits, idx[..., None], dim=-1)[..., 0]
    true_logit = torch.where(mine, true_logit, torch.zeros_like(true_logit))
    sum_exp, true_logit = reduce_from_model(
        torch.stack([sum_exp, true_logit]), ctx).unbind(0)
    nll = torch.log(sum_exp) + m - true_logit
    mask = (labels != ignore_index).float()
    if count is None:
        count = mask.sum().clamp(min=1.0)
    return (nll * mask).sum() / count
