"""The single-card training step: fwd -> loss -> bwd -> clip -> AdamW.

Port of ``repro.train.step``.  ``jax.value_and_grad`` becomes
``torch.autograd.grad`` over detached copies of the parameter leaves that
require grad (the caller's tensors keep ``requires_grad=False``, so serving
from them never records a graph); the microbatch ``lax.scan`` becomes a
loop over slices of the batch dimension with f32 gradient sums.  The
parameters' device decides where the step runs: on the card, attention's
forward and backward are the flash-attention kernels.  Batches are numpy
(``repro_torch.data.make_batches``) or tensors, moved to that device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.types import ModelConfig, TrainConfig
from repro_torch.core.tree import param_leaves, tree_map
from repro_torch.models.transformer import check_ported, forward
from repro_torch.optim.adamw import adamw_update
from repro_torch.optim.schedule import lr_schedule
from repro_torch.train.loss import cross_entropy


def _on(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, *,
                    remat: Optional[bool] = None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics) with metrics {"ce", "aux", "loss", "lr", "grad_norm"} as 0-d
    tensors.  batch: {"tokens", "labels"} (B, S) int; B must be a multiple
    of ``tcfg.microbatches``.  params and the optimizer state are updated
    in place.  ``tcfg.remat``: each layer checkpointed
    (``forward(..., remat=True)``); the keyword ``remat``, where given,
    must agree with it (one setting, two spellings)."""
    check_ported(cfg)  # MLA, cross-attention and encoder-decoder raise
    if remat is None:
        remat = tcfg.remat
    elif remat != tcfg.remat:
        raise ValueError(f"make_train_step(remat={remat}) disagrees with "
                         f"TrainConfig(remat={tcfg.remat})")
    nmb = max(1, tcfg.microbatches)

    def loss_fn(p, tokens, labels):
        logits, aux = forward(cfg, p, tokens, remat=remat)
        ce = cross_entropy(logits, labels)
        return ce + cfg.router_aux_loss * aux, ce, aux

    def grads_of(p, leaves, tokens, labels):
        loss, ce, aux = loss_fn(p, tokens, labels)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        return grads, loss.detach(), ce.detach(), aux.detach()

    def train_step(params: Any, opt_state: Dict[str, Any],
                   batch: Dict[str, Any]):
        device = params["embed"].device
        tokens, labels = _on(batch["tokens"], device), \
            _on(batch["labels"], device)
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        leaves = list(param_leaves(p))
        if nmb == 1:
            grads, loss, ce, aux = grads_of(p, leaves, tokens, labels)
        else:
            b = tokens.shape[0]
            if b % nmb:
                raise ValueError(f"batch {b} is not a multiple of "
                                 f"{nmb} microbatches")
            mb = b // nmb
            grads = [torch.zeros(x.shape, dtype=torch.float32, device=device)
                     for x in leaves]
            loss = ce = aux = torch.zeros((), dtype=torch.float32,
                                          device=device)
            for i in range(nmb):
                sl = slice(i * mb, (i + 1) * mb)
                g, l_i, ce_i, aux_i = grads_of(p, leaves, tokens[sl],
                                               labels[sl])
                torch._foreach_add_(grads, g)  # b_.astype(a.dtype): f32 sums
                del g
                loss, ce, aux = loss + l_i, ce + ce_i, aux + aux_i
            torch._foreach_div_(grads, nmb)
            loss, ce, aux = loss / nmb, ce / nmb, aux / nmb
        del p, leaves
        if tcfg.grad_dtype == "bf16":
            # sync-precision cast; AdamW re-accumulates in f32
            grads = [g.to(torch.bfloat16) for g in grads]
        lr = lr_schedule(opt_state["step"], tcfg)
        params, opt_state, opt_metrics = adamw_update(params, grads,
                                                      opt_state, tcfg, lr)
        metrics = {"ce": ce, "aux": aux, "loss": loss, "lr": lr,
                   **opt_metrics}
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig) -> Callable:
    """Returns eval_step(params, batch) -> the mean cross-entropy, with no
    graph recorded."""
    check_ported(cfg)

    def eval_step(params, batch):
        device = params["embed"].device
        with torch.no_grad():
            logits, _ = forward(cfg, params, _on(batch["tokens"], device))
            return cross_entropy(logits, _on(batch["labels"], device))

    return eval_step
