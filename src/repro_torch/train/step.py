"""The training step: fwd -> loss -> bwd -> (sync) -> clip -> AdamW.

Port of ``repro.train.step``.  ``jax.value_and_grad`` becomes
``torch.autograd.grad`` over detached copies of the parameter leaves that
require grad (the caller's tensors keep ``requires_grad=False``, so serving
from them never records a graph); the microbatch ``lax.scan`` becomes a
loop over slices of the batch dimension with f32 gradient sums.  The
parameters' device decides where the step runs: on the card, the forward
and backward of attention, the SSD scan and the expert products are the
kernels K1, K6 and K5 and their backward kernels.  Batches are numpy
(``repro_torch.data.make_batches``) or tensors, moved to that device.

Data parallelism.  In the JAX package the gradient sync falls out of the
sharding propagation (plain DP specs: an all-reduce; ZeRO-1 specs: a
reduce-scatter and an all-gather).  Here, with a ``ParallelCtx`` of
``dp > 1``, every rank takes the whole global batch, computes the gradient
of its rows (``parallel.microbatch_rows``) and the step syncs it once:
``TrainConfig.zero1`` picks the sync, as the JAX package's demand builder
picks it (``reduce_scatter`` if zero1, else ``all_reduce``):

- all-reduce: the gradient, flattened into the planner's 64 MiB buckets,
  through ``make_all_reduce(ctx.grad_all_reduce)``; every rank updates
  every parameter;
- ZeRO-1: each bucket through ``ring_reduce_scatter``, AdamW on this
  rank's chunks (``optim.adamw_shard_update``, m and v sharded), then
  ``ring_all_gather`` of the updated parameter chunks.

A rank's loss is its share of the global one: each microbatch's summed NLL
over the microbatch's global count of labels that are not -1 (the rows of
the global batch give it on every rank), the MoE router loss over ``dp``;
the shares, and so the gradients, add up over the ranks.  The bf16
gradient cast comes before the sync and halves its bytes.

Model axis.  With a context whose model axis splits
(``ParallelCtx.tensor_parallel``) the ranks of one data index take the
same rows and run the layers on their blocks (``parallel.tensor``): the
heads of GQA, MLA, cross-attention and the encoder, the FFN's and the
shared experts' columns, the Mamba heads; for a MoE config the MoE layers
run ``moe_ep_train`` over the same axis (``models.moe``), each rank on its
own experts, and on the card the two all-to-alls of a layer carry the
inputs of K5's backward kernel too (``ccl.primitives.AllToAll`` is
differentiable).  The loss is the vocabulary-parallel cross-entropy of the
sharded logits, the same on every model rank, and the conjugate
all-reduces leave every leaf's gradient complete on its rank: a block's
or an expert's for that part, a replicated leaf's whole.  So the sync
runs over the data group only (plain DP or ZeRO-1 alike), on each rank's
own leaves, and the clip's norm sums the parts' squares over the model
ranks (``parallel.model_flags``, ``optim.global_norm``).  An
encoder-decoder's encoder runs inside the loss on the same context, as
the JAX step's ``encode(..., ctx=ctx)``.

FSDP (a context of ``make_ctx(..., fsdp=True)``): the parameters are this
rank's shards over the data axes (``parallel.fsdp``), the model gathers
each layer's before it runs, and the gather's backward reduce-scatters the
gradient: each sharded leaf's gradient comes out of the backward already
summed over the data ranks, on this rank's shard.  The step all-reduces
the gradient of the leaves left replicated (no free dim the data axes
divide), sums the clip norm's squares of the shards over the data ranks,
and runs AdamW on the shards, its m and v shaped like them
(``init_opt_state(params)``, without the ZeRO-1 ``ctx``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.types import ModelConfig, TrainConfig
from repro_torch.core.tree import param_leaves, tree_map
from repro_torch.models.transformer import encode, forward
from repro_torch.optim.adamw import adamw_shard_update, adamw_update
from repro_torch.optim.schedule import lr_schedule
from repro_torch.parallel.fsdp import sharded_flags
from repro_torch.parallel.planner import (ParallelCtx, flat_layout,
                                          microbatch_rows, model_flags,
                                          tp_layout)
from repro_torch.train.loss import cross_entropy

GradHook = Callable[[str, Any], None]


def _on(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    ctx: Optional[ParallelCtx] = None, *,
                    remat: Optional[bool] = None) -> Callable:
    """Returns train_step(params, opt_state, batch, grad_hook=None) ->
    (params, opt_state, metrics) with metrics {"ce", "aux", "loss", "lr",
    "grad_norm"} as 0-d tensors, those of the global batch.  batch:
    {"tokens", "labels"} (B, S) int, the global batch (the same on every
    rank), and for the configs with cross-attention "context" (B, T, d):
    the vision patch embeddings, or the frame embeddings that the loss
    runs through ``encode`` for an encoder-decoder; B must be a multiple of
    ``tcfg.microbatches`` x ``ctx.dp``.
    params and the optimizer state are updated in place; under ZeRO-1 the
    state is ``init_opt_state(params, ctx)``'s shards.

    ``grad_hook(stage, grads)``, where given, sees the gradient before
    AdamW: at stage "local" this rank's (after the microbatch mean and the
    bf16 cast, a list of leaves), at stage "synced" the synced one (the
    list of leaves; under ZeRO-1 this rank's flat shard of the sum).  With
    one rank the two are the same list.  The tensors are freed after the
    step: a hook that keeps one keeps a reference or a copy.

    ``tcfg.remat``: each layer checkpointed (``forward(..., remat=True)``);
    the keyword ``remat`` and ``ctx.remat``, where given, must agree with
    it (one setting, three spellings)."""
    for name, other in (("remat", remat),
                        ("ctx.remat", None if ctx is None else ctx.remat)):
        if other is not None and other != tcfg.remat:
            raise ValueError(f"make_train_step: {name}={other} disagrees "
                             f"with TrainConfig(remat={tcfg.remat})")
    remat = tcfg.remat
    nmb = max(1, tcfg.microbatches)
    dp = ctx.dp if ctx is not None else 1
    fsdp = ctx is not None and bool(ctx.fsdp)
    zero1 = dp > 1 and tcfg.zero1 and not fsdp
    split = ctx is not None and ctx.tp > 1
    lay = tp_layout(cfg, ctx)
    vocab_ctx = ctx if lay is not None and lay.vocab else None

    def grads_of(p, leaves, tokens, labels, context, count):
        if cfg.is_encoder_decoder:
            context = encode(cfg, p, context, remat=remat, ctx=ctx)
        logits, aux = forward(cfg, p, tokens, context=context, remat=remat,
                              ctx=ctx)
        ce = cross_entropy(logits, labels, count=count, ctx=vocab_ctx)
        aux = aux / dp
        loss = ce + cfg.router_aux_loss * aux
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        return grads, loss.detach(), ce.detach(), aux.detach()

    def train_step(params: Any, opt_state: Dict[str, Any],
                   batch: Dict[str, Any],
                   grad_hook: Optional[GradHook] = None):
        if zero1 and not isinstance(opt_state["m"], torch.Tensor):
            raise ValueError("ZeRO-1 (TrainConfig.zero1 with dp > 1) needs "
                             "the sharded state of init_opt_state(params, "
                             "ctx)")
        device = params["embed"].device
        sharded = model_flags(params, ctx, cfg) if split else None
        dsplit = sharded_flags(params, ctx) if fsdp else None
        tokens, labels = _on(batch["tokens"], device), \
            _on(batch["labels"], device)
        context = batch.get("context")
        if context is not None:
            context = _on(context, device)
        rows = microbatch_rows(tokens.shape[0], nmb, ctx)
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        leaves = list(param_leaves(p))
        def microbatch(mb_rows, mine):
            # normalised by the microbatch's global count of labels that
            # are not -1: the ranks' shares add up to its mean
            count = (labels[mb_rows] != -1).sum().clamp(min=1).float()
            return grads_of(p, leaves, tokens[mine], labels[mine],
                            None if context is None else context[mine],
                            count)

        if nmb == 1:
            grads, loss, ce, aux = microbatch(*rows[0])
        else:
            grads = [torch.zeros(x.shape, dtype=torch.float32, device=device)
                     for x in leaves]
            loss = ce = aux = torch.zeros((), dtype=torch.float32,
                                          device=device)
            for mb_rows, mine in rows:
                g, l_i, ce_i, aux_i = microbatch(mb_rows, mine)
                torch._foreach_add_(grads, g)  # b_.astype(a.dtype): f32 sums
                del g
                loss, ce, aux = loss + l_i, ce + ce_i, aux + aux_i
            torch._foreach_div_(grads, nmb)
            loss, ce, aux = loss / nmb, ce / nmb, aux / nmb
        del p, leaves
        if tcfg.grad_dtype == "bf16":
            # sync-precision cast: halves the DP gradient collective bytes;
            # AdamW re-accumulates in f32
            grads = [g.to(torch.bfloat16) for g in grads]
        if grad_hook is not None:
            grad_hook("local", grads)
        if dp > 1:
            loss, ce, aux = ctx.allsum(torch.stack([loss, ce, aux])).unbind()
        lr = lr_schedule(opt_state["step"], tcfg)
        if zero1:
            params, opt_state, opt_metrics = _zero1_update(
                params, grads, opt_state, tcfg, lr, ctx, grad_hook, sharded)
        else:
            if fsdp:
                grads = _sync_replicated(grads, dsplit, ctx)
            elif dp > 1:
                layout = flat_layout(grads, ctx)
                flat = layout.flatten(grads)
                del grads
                grads = layout.unflatten(layout.all_reduce(
                    flat, ctx.grad_all_reduce, ctx.group))
                del flat
            if grad_hook is not None:
                grad_hook("synced", grads)
            params, opt_state, opt_metrics = adamw_update(
                params, grads, opt_state, tcfg, lr, ctx, sharded,
                data_split=dsplit)
        metrics = {"ce": ce, "aux": aux, "loss": loss, "lr": lr,
                   **opt_metrics}
        return params, opt_state, metrics

    return train_step


def _sync_replicated(grads: list, dsplit, ctx) -> list:
    """FSDP: the gradients of the leaves that are not sharded over the
    data axes (``dsplit`` False) all-reduced over the data group, in the
    planner's buckets; the shards' gradients are sums already."""
    rep = [i for i, f in enumerate(dsplit) if not f]
    if ctx.dp == 1 or not rep:
        return grads
    sub = [grads[i] for i in rep]
    layout = flat_layout(sub, ctx)
    synced = layout.unflatten(layout.all_reduce(
        layout.flatten(sub), ctx.grad_all_reduce, ctx.group))
    grads = list(grads)
    for i, g in zip(rep, synced):
        grads[i] = g
    return grads


def _zero1_update(params, grads, opt_state, tcfg, lr, ctx, grad_hook,
                  sharded=None):
    """Reduce-scatter the gradient, AdamW on this rank's shard, all-gather
    the updated parameters into every rank's ``params`` (in place).
    ``sharded``: the flags of this model rank's leaves split over the
    model axis, whose squares the clip's norm sums over the model
    ranks."""
    flat_p = list(param_leaves(params))
    layout = flat_layout(flat_p, ctx)
    flat_g = layout.flatten(grads)
    del grads
    g_shard = layout.reduce_scatter(flat_g, ctx.group)
    del flat_g
    if grad_hook is not None:
        grad_hook("synced", g_shard)
    with torch.no_grad():
        p_shard = layout.shard(layout.flatten(flat_p, torch.float32))
    new, opt_state, opt_metrics = adamw_shard_update(
        p_shard, g_shard, opt_state, tcfg, lr, ctx,
        layout.shard_ranges(sharded) if sharded is not None else ())
    del p_shard, g_shard
    # the wire carries the parameters' dtype where they share one
    dtypes = {p.dtype for p in flat_p}
    wire = dtypes.pop() if len(dtypes) == 1 else torch.float32
    gathered = layout.unflatten(layout.all_gather(new.to(wire), ctx.group))
    del new
    with torch.no_grad():
        for p, q in zip(flat_p, gathered):
            p.copy_(q)  # cast back to p's dtype
    return params, opt_state, opt_metrics


def make_eval_step(cfg: ModelConfig, ctx: Optional[ParallelCtx] = None
                   ) -> Callable:
    """Returns eval_step(params, batch) -> the mean cross-entropy, with no
    graph recorded (batch: as ``make_train_step``'s).  ``ctx``: as the
    train step's, every rank returning the same mean: each data rank takes
    its rows of the batch (``microbatch_rows``) and their NLL over the
    batch's count of labels, summed over the data ranks (``allsum``); a
    model axis runs ``encode`` and ``forward`` on the rank's blocks, and
    its vocabulary-sharded logits take the vocabulary-parallel loss."""
    lay = tp_layout(cfg, ctx)
    vocab_ctx = ctx if lay is not None and lay.vocab else None

    def eval_step(params, batch):
        device = params["embed"].device
        tokens, labels = _on(batch["tokens"], device), \
            _on(batch["labels"], device)
        _, mine = microbatch_rows(tokens.shape[0], 1, ctx)[0]
        context = batch.get("context")
        with torch.no_grad():
            if context is not None:
                context = _on(context, device)[mine]
                if cfg.is_encoder_decoder:
                    context = encode(cfg, params, context, ctx=ctx)
            logits, _ = forward(cfg, params, tokens[mine], context=context,
                                ctx=ctx)
            count = (labels != -1).sum().clamp(min=1).float()
            ce = cross_entropy(logits, labels[mine], count=count,
                               ctx=vocab_ctx)
            return ce if ctx is None else ctx.allsum(ce)

    return eval_step
