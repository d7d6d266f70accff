"""Serving: prefill + batched single-token decode against the KV cache.

Port of ``repro.serve.step``.  On a model axis the model returns each
rank's block of the vocabulary (with or without expert parallelism of the
MoE layers beside it); both entry points gather the logits over the model
ranks (``full_logits``), so that every rank returns all of them and picks
the same token."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.types import ModelConfig
from repro_torch.models.transformer import decode_step, forward
from repro_torch.parallel.planner import tp_layout
from repro_torch.parallel.tensor import gather_from_model


def full_logits(cfg: ModelConfig, logits: torch.Tensor, ctx=None
                ) -> torch.Tensor:
    """The logits over the whole vocabulary: a tensor-parallel rank's
    block gathered from the model ranks (the same bits on every rank),
    else ``logits`` itself."""
    lay = tp_layout(cfg, ctx)
    return gather_from_model(logits, ctx) if lay is not None and lay.vocab \
        else logits


def make_serve_step(cfg: ModelConfig, ctx=None,
                    window: Optional[int] = None,
                    temperature: float = 0.0) -> Callable:
    """Returns step(params, cache, tokens (B,1), pos, generator) ->
    (next_tokens (B,1) int64, logits, cache).

    Greedy argmax at temperature 0; otherwise a sample from
    softmax(logits / temperature) drawn with ``generator``.  ``ctx``: a
    ``parallel.ParallelCtx`` (``decode_step``): every rank of its mesh
    calls the step on its data rank's tokens and its cache (the ranks of
    a model group on the same tokens), the logits are gathered
    (``full_logits``) and, with the generators of the ranks seeded alike,
    every rank of a model group draws the same token."""

    def serve_step(params, cache, tokens, pos, generator=None):
        logits, cache = decode_step(cfg, params, cache, tokens, pos,
                                    ctx=ctx, window=window)
        logits = full_logits(cfg, logits, ctx)
        last = logits[:, -1, :]
        if temperature > 0.0:
            probs = torch.softmax(last.float() / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(last, dim=-1)
        return nxt[:, None], logits, cache

    return serve_step


def make_prefill(cfg: ModelConfig, ctx=None,
                 window: Optional[int] = None) -> Callable:
    """Forward over the prompt: prefill(params, tokens (B,S),
    context=None) -> logits.  ``context``: the encoder's output (the
    caller runs ``models.encode``) or the vision patch embeddings, for the
    configs with cross-attention.

    On the card its attention runs the flash-attention kernel where
    ``models.prefill_launches`` says.  The batcher fills its cache by
    replaying the prompt through decode_step instead (simple and
    cache-exact).  ``ctx``: every rank of a model group runs on the same
    prompts (its data shard of them) and its blocks, the context encoded
    or projected on its heads, the MoE layers through ``moe_ep_train``
    under expert parallelism (the sequence split over the model axis
    inside the layer), and returns the gathered logits
    (``full_logits``)."""

    def prefill(params, tokens, context=None):
        logits, _ = forward(cfg, params, tokens, context=context,
                            window=window, ctx=ctx)
        return full_logits(cfg, logits, ctx)

    return prefill
