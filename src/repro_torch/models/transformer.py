"""Full-model assembly: embeddings -> decoder layers -> LM head.

Port of ``repro.models.transformer``: decoders whose layers mix GQA or MLA
self-attention, cross-attention or Mamba2 (``LayerSpec.mixer``) with a
dense, MoE or no FFN (``LayerSpec.ffn``), and the encoder-decoder stack.
The JAX package scans over parameters stacked per layer group; here the
parameters are a list of per-layer dicts (``params["layers"]``) walked by a
Python loop, in the JAX layer order.  An encoder-decoder config adds
``params["encoder"]`` ({"layers": its causal GQA + dense FFN layers,
"final_norm"}) and ``params["cross"]``, one cross-attention block per
decoder layer, applied after the layer's self-attention with the layer's
``norm1`` scale.

The context (encoder output, or vision patch embeddings) is cast to the
parameters' dtype where it enters (``encode``, ``forward``,
``init_cache``); the JAX package promotes instead, so with bf16
parameters and an f32 context its stream turns f32 (with f32 parameters
the two are the same).

Tensor parallelism (a ``ctx`` whose model axis splits,
``ParallelCtx.tensor_parallel``, for every config): a rank holds the
blocks of its model index (``parallel.planner.tp_layout``;
``init_params(..., ctx=)`` draws every leaf whole and keeps its block),
the residual stream stays whole on every rank, and the layers sum their
partial products over the model ranks (``parallel.tensor``): GQA, MLA,
cross-attention, the encoder-decoder's cross blocks and the encoder's
layers on their heads, the dense FFN and the shared experts on their
columns, Mamba on its heads, and the MoE experts, under expert
parallelism, on the same model axis (``models.moe``).  Where the
vocabulary splits, the embedding is looked up on this rank's rows and
summed (``vocab_embed``), the LM head (with tied embeddings, the
embedding's rows) gives this rank's block of the logits and its
``_vocab_bias``, and ``forward``/``decode_step`` return the logits
sharded over the vocabulary, as the JAX package's ``logit_spec`` keeps
them (``serve`` gathers them before a token is picked;
``train.loss.cross_entropy`` never gathers them).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.device import resolve_device
from repro_torch.core.types import LayerSpec, ModelConfig
from repro_torch.kernels.flash_attention.ops import \
    LAUNCHES_PER_CALL as FA_BWD_LAUNCHES
from repro_torch.kernels.moe_gmm.ops import \
    BWD_LAUNCHES_PER_CALL as GMM_BWD_LAUNCHES
from repro_torch.kernels.ssd_scan.ops import \
    BWD_LAUNCHES_PER_CALL as SSD_BWD_LAUNCHES
from repro_torch.kernels.ssd_scan.ops import LAUNCHES_PER_CALL as SSD_LAUNCHES
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.modules import (dense_init, embed_init, ffn_apply,
                                        init_ffn, init_norm, rms_norm, whole)
from repro_torch.parallel.fsdp import gather_tree
from repro_torch.parallel.planner import (check_tensor_parallel, tp_cut,
                                          tp_layout)
from repro_torch.parallel.tensor import copy_to_model, vocab_embed


ENCODER_SPEC = LayerSpec(mixer="attn", ffn="dense")


def _context_len(cfg: ModelConfig) -> int:
    return cfg.num_audio_frames if cfg.is_encoder_decoder \
        else cfg.num_vision_tokens


def prefill_launches(cfg: ModelConfig, seq_len: Optional[int] = None
                     ) -> dict:
    """Kernel launches of one ``forward`` of ``seq_len`` tokens on CUDA
    tensors, by the names of ``repro_torch.kernels.WRAPPERS``: flash
    attention once per GQA self-attention layer (none for MLA, whose q and
    v head dims differ), and once per cross-attention layer or interleaved
    cross block where ``seq_len`` equals the config's context length
    (``num_audio_frames`` or ``num_vision_tokens``; elsewhere it takes the
    plain path); the SSD scan's three stages once per Mamba layer; the
    grouped expert GEMM three times (gate, up, down) per MoE layer.  The
    encoder's are counted by ``encode_launches``."""
    specs = cfg.layer_specs()
    n_self = 0 if cfg.attention == "mla" else \
        sum(s.mixer == "attn" for s in specs)
    n_cross = sum(s.mixer == "cross_attn" for s in specs)
    if cfg.is_encoder_decoder:
        n_cross += sum(s.mixer == "attn" for s in specs)
    if seq_len is None or seq_len != _context_len(cfg):
        n_cross = 0
    return {"flash_attention": n_self + n_cross,
            "ssd_scan": SSD_LAUNCHES * sum(s.mixer == "mamba"
                                           for s in specs),
            "moe_gmm": 3 * sum(s.ffn == "moe" for s in specs)}


def encode_launches(cfg: ModelConfig) -> dict:
    """Kernel launches of one ``encode`` on CUDA tensors: flash attention
    (causal) once per encoder layer."""
    return {"flash_attention": cfg.encoder_layers}


def train_launches(cfg: ModelConfig, microbatches: int = 1,
                   remat: bool = False, seq_len: Optional[int] = None
                   ) -> dict:
    """Kernel launches of one training step on CUDA tensors
    (``repro_torch.train.make_train_step``) over sequences of ``seq_len``,
    by the names of ``repro_torch.kernels.WRAPPERS``, those that launch:
    each forward kernel once per layer that takes it
    (``prefill_launches``, and the encoder's ``encode_launches``, which the
    step runs inside the loss) and microbatch, twice with ``remat`` (the
    checkpointed layer runs again in the backward), and each backward
    kernel once per such layer and microbatch: flash attention's
    ``LAUNCHES_PER_CALL`` per attention, the SSD scan's
    ``BWD_LAUNCHES_PER_CALL`` per Mamba layer, the grouped GEMM's
    ``BWD_LAUNCHES_PER_CALL`` per expert product (three a MoE layer).  An
    expert-parallel rank launches as many on its own experts."""
    fwd = prefill_launches(cfg, seq_len)
    n_attn = fwd["flash_attention"] + encode_launches(cfg)["flash_attention"]
    n_ssd = fwd["ssd_scan"] // SSD_LAUNCHES
    n_gmm = fwd["moe_gmm"]
    again = microbatches * (2 if remat else 1)
    counts = {"flash_attention": n_attn * again,
              "flash_attention_bwd": n_attn * microbatches * FA_BWD_LAUNCHES,
              "ssd_scan": n_ssd * SSD_LAUNCHES * again,
              "ssd_scan_bwd": n_ssd * microbatches * SSD_BWD_LAUNCHES,
              "moe_gmm": n_gmm * again,
              "moe_gmm_bwd": n_gmm * microbatches * GMM_BWD_LAUNCHES}
    return {k: n for k, n in counts.items() if n}


def ep_launches(cfg: ModelConfig) -> dict:
    """K5 launches of one rank in one expert-parallel forward
    (``moe_ep_train``) or decode step (``moe_ep_decode``,
    ``moe_ep_decode_ws``): three (gate, up, down) per MoE layer on its own
    experts, whatever the mesh."""
    return {"moe_gmm": 3 * sum(s.ffn == "moe" for s in cfg.layer_specs())}


def _init_layer(cfg: ModelConfig, spec: LayerSpec, dtype, device,
                generator: torch.Generator, ctx=None, cut=whole) -> dict:
    p = {"norm1": init_norm(cfg.d_model, dtype, device)}
    if spec.mixer == "attn" and cfg.attention == "mla":
        p["mixer"] = attn.init_mla(cfg, dtype, device, generator, cut=cut)
    elif spec.mixer in ("attn", "cross_attn"):
        p["mixer"] = attn.init_gqa(cfg, dtype, device, generator,
                                   cross=spec.mixer == "cross_attn",
                                   cut=cut)
    else:
        p["mixer"] = ssm.init_mamba(cfg, dtype, device, generator, cut=cut)
    if spec.ffn != "none":
        p["norm2"] = init_norm(cfg.d_model, dtype, device)
        if spec.ffn == "moe":
            p["ffn"] = moe_mod.init_moe(cfg, dtype, device, generator, ctx,
                                        cut=cut)
        else:
            p["ffn"] = init_ffn(cfg, cfg.d_ff, dtype, device, generator,
                                cut=cut)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda", ctx=None) -> dict:
    """Random parameters in the JAX package's layout, drawn from
    ``generator`` (which must live on ``device``).  With an
    expert-parallel ``ctx`` each MoE layer keeps only this rank's part of
    its experts (``parallel.shard_params``'s layout; ``models.moe.
    init_moe`` draws the rest and drops it); on a model axis every other
    leaf is drawn whole and only this rank's block of it kept
    (``parallel.planner.tp_cut``): both bit-equal to the same part of the
    full draw."""
    dev = resolve_device(device)
    cut = whole
    if ctx is not None and ctx.tensor_parallel:
        check_tensor_parallel(cfg, ctx.use_ep)

        def cut(name, w):
            return tp_cut(name, w, cfg, ctx)
    params = {
        "embed": cut("embed", embed_init(cfg.padded_vocab, cfg.d_model,
                                         dtype, dev, generator)),
        "final_norm": init_norm(cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = cut("lm_head", dense_init(
            cfg.d_model, (cfg.padded_vocab,), dtype, dev, generator))
    params["layers"] = [_init_layer(cfg, spec, dtype, dev, generator, ctx,
                                    cut)
                        for spec in cfg.layer_specs()]
    if cfg.is_encoder_decoder:
        params["encoder"] = {
            "layers": [_init_layer(cfg, ENCODER_SPEC, dtype, dev, generator,
                                   ctx, cut)
                       for _ in range(cfg.encoder_layers)],
            "final_norm": init_norm(cfg.d_model, dtype, dev)}
        params["cross"] = [attn.init_gqa(cfg, dtype, dev, generator,
                                         cross=True, cut=cut)
                           for _ in range(cfg.num_layers)]
    return params


def _vocab_bias(cfg: ModelConfig, dtype, device, lo: int,
                hi: int) -> torch.Tensor:
    """NEG_INF on the padded vocabulary ids of [lo, hi) (all of them, or a
    tensor-parallel rank's block), so argmax never picks one."""
    v = torch.arange(lo, hi, device=device)
    return torch.where(v < cfg.vocab_size, 0.0, attn.NEG_INF).to(dtype)


def _tp_vocab(cfg: ModelConfig, ctx):
    lay = tp_layout(cfg, ctx)
    return lay if lay is not None and lay.vocab else None


def _embed(cfg: ModelConfig, params: dict, tokens, ctx):
    embed = gather_tree(params["embed"], ctx, "/embed")
    lay = _tp_vocab(cfg, ctx)
    if lay is None:
        return embed[tokens]
    lo, _ = lay.block(cfg.padded_vocab)
    return vocab_embed(embed, tokens, lo, ctx)


def _lm_head(cfg: ModelConfig, params: dict, x, ctx=None) -> torch.Tensor:
    x = rms_norm(x, gather_tree(params["final_norm"]["scale"], ctx,
                                "/final_norm/scale"), cfg.norm_eps)
    lay = _tp_vocab(cfg, ctx)
    lo, hi = (0, cfg.padded_vocab) if lay is None else \
        lay.block(cfg.padded_vocab)
    if lay is not None:
        x = copy_to_model(x, ctx)
    if cfg.tie_embeddings:
        logits = x @ gather_tree(params["embed"], ctx, "/embed").T
    else:
        logits = x @ gather_tree(params["lm_head"], ctx, "/lm_head")
    return logits + _vocab_bias(cfg, logits.dtype, logits.device, lo, hi)


def _apply_layer(lp: dict, spec: LayerSpec, cfg: ModelConfig, x,
                 positions, window, ctx=None, context=None, cross_lp=None,
                 paths=("", "")
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One decoder (or encoder) layer over the whole sequence; returns (x,
    aux_loss), aux_loss None without a MoE FFN.  ``cross_lp``: the
    encoder-decoder's cross block, after the self-attention.  ``paths``:
    where ``lp`` and ``cross_lp`` sit in the parameter tree, whose shards
    an FSDP ``ctx`` gathers here (under ``remat`` again in the
    recompute)."""
    lp = gather_tree(lp, ctx, paths[0])
    if cross_lp is not None:
        cross_lp = gather_tree(cross_lp, ctx, paths[1])
    h = rms_norm(x, lp["norm1"]["scale"], cfg.norm_eps)
    if spec.mixer == "attn" and cfg.attention == "mla":
        h = attn.mla_forward(lp["mixer"], cfg, h, positions, window=window,
                             ctx=ctx, **_chunk_flags(ctx))
    elif spec.mixer == "attn":
        h = attn.gqa_forward(lp["mixer"], cfg, h, positions, window=window,
                             ctx=ctx, **_chunk_flags(ctx))
    elif spec.mixer == "cross_attn":
        h = attn.cross_attention_forward(lp["mixer"], cfg, h, context,
                                         ctx=ctx,
                                         **_chunk_flags(ctx, cross=True))
    else:
        h = ssm.mamba_forward(lp["mixer"], cfg, h, ctx=ctx)
    x = x + h
    if cross_lp is not None:  # norm1's scale again, as in the JAX package
        h = rms_norm(x, lp["norm1"]["scale"], cfg.norm_eps)
        x = x + attn.cross_attention_forward(cross_lp, cfg, h, context,
                                             ctx=ctx)
    aux = None
    if spec.ffn != "none":
        h2 = rms_norm(x, lp["norm2"]["scale"], cfg.norm_eps)
        if spec.ffn == "moe":
            y, aux = moe_mod.moe_apply(lp["ffn"], cfg, h2, ctx=ctx)
        else:
            y = ffn_apply(lp["ffn"], h2, cfg.ffn_act, _tp_ffn(cfg, ctx))
        x = x + y
    return x, aux


def _chunk_flags(ctx, cross: bool = False) -> dict:
    """The chunked attention's keywords that the context sets
    (``ParallelCtx.causal_skip``, ``unroll_layers``): ``causal_skip`` and
    ``unroll`` where set (cross-attention takes ``unroll`` only), none
    where not."""
    flags = {}
    if getattr(ctx, "causal_skip", False) and not cross:
        flags["causal_skip"] = True
    if getattr(ctx, "unroll_layers", False):
        flags["unroll"] = True
    return flags


def _tp_ffn(cfg: ModelConfig, ctx):
    """``ctx`` where it splits the dense FFN, else ``None``."""
    lay = tp_layout(cfg, ctx)
    return ctx if lay is not None and lay.ffn else None


def _context(cfg: ModelConfig, params: dict, context):
    """The context in the parameters' dtype; raises where the config needs
    one and none is given."""
    if not (cfg.is_encoder_decoder or cfg.cross_attn_period):
        return None
    if context is None:
        raise ValueError(f"{cfg.name} requires a context (the encoder "
                         f"output or the vision patch embeddings)")
    return context.to(params["embed"].dtype)


def _cross_blocks(cfg: ModelConfig, params: dict) -> list:
    """The encoder-decoder's cross block of each decoder layer, None where
    there is none (JAX: a block after every self-attention layer)."""
    cross = params.get("cross")
    return [cross[i] if cross is not None and spec.mixer == "attn" else None
            for i, spec in enumerate(cfg.layer_specs())]


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            context: Optional[torch.Tensor] = None,
            window: Optional[int] = None, remat: bool = False, ctx=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) int. Returns (logits (B,S,V_pad), aux_loss): the sum
    of the MoE layers' router losses (0 without MoE).

    ``context`` (B, T, d): the encoder's output (``encode``; the caller
    encodes) or the vision patch embeddings, for the configs with cross-
    attention; ignored by the others.
    ``window`` overrides cfg.sliding_window.  ``remat``: each layer under
    ``torch.utils.checkpoint`` (non-reentrant), its activations recomputed
    in the backward, as the JAX package's ``jax.checkpoint`` of each layer
    group's scan body under ``ctx.remat``.  ``ctx``: a
    ``repro_torch.parallel.ParallelCtx``, whose data ranks share the MoE
    router's load statistics (``models.moe.route``) and whose MoE layers
    run expert-parallel over its model axis where ``ctx.use_ep``
    (``models.moe.moe_ep_train``); a tensor-parallel ``ctx`` (the module's
    docstring) returns this rank's vocabulary block of the logits (B, S,
    V_pad/tp) where the vocabulary splits."""
    if ctx is not None and ctx.tensor_parallel:
        check_tensor_parallel(cfg, ctx.use_ep)
    context = _context(cfg, params, context)
    x = _embed(cfg, params, tokens, ctx)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    win = window if window is not None else cfg.sliding_window
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (spec, lp, cross_lp) in enumerate(zip(
            cfg.layer_specs(), params["layers"], _cross_blocks(cfg, params))):
        args = (lp, spec, cfg, x, positions, win, ctx, context, cross_lp,
                (f"/layers/{i}", f"/cross/{i}"))
        if remat:
            x, a = checkpoint(_apply_layer, *args, use_reentrant=False)
        else:
            x, a = _apply_layer(*args)
        if a is not None:
            aux = aux + a
    return _lm_head(cfg, params, x, ctx), aux


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor, *,
           remat: bool = False, ctx=None) -> torch.Tensor:
    """Encoder stack over the stub frame embeddings (B, T, d) -> the
    context: causal GQA self-attention (``gqa_forward``, as the JAX
    package's encoder) and a dense FFN a layer, then the encoder's final
    norm.  ``remat``: each layer checkpointed, as ``forward``'s.  ``ctx``:
    a tensor-parallel context runs each layer on this rank's heads and FFN
    columns (``forward``'s docstring); the context comes out whole on
    every rank."""
    enc = params["encoder"]
    x = _context(cfg, params, frames)
    positions = torch.arange(x.shape[1], device=x.device)
    for i, lp in enumerate(enc["layers"]):
        args = (lp, ENCODER_SPEC, cfg, x, positions, cfg.sliding_window, ctx,
                None, None, (f"/encoder/layers/{i}", ""))
        if remat:
            x, _ = checkpoint(_apply_layer, *args, use_reentrant=False)
        else:
            x, _ = _apply_layer(*args)
    return rms_norm(x, gather_tree(enc["final_norm"]["scale"], ctx,
                                   "/encoder/final_norm/scale"),
                    cfg.norm_eps)


def _init_layer_cache(cfg: ModelConfig, spec: LayerSpec, lp: dict,
                      batch: int, max_len: int, dtype, device, context,
                      window) -> dict:
    if spec.mixer == "attn" and cfg.attention == "mla":
        return attn.init_mla_cache(cfg, batch, max_len, dtype, device)
    if spec.mixer == "attn":
        return attn.init_kv_cache(cfg, batch, max_len, dtype, device,
                                  window=window,
                                  kv_heads=lp["mixer"]["wk"].shape[1])
    if spec.mixer == "cross_attn":
        return attn.init_cross_cache(lp["mixer"], cfg, context, dtype)
    return ssm.init_mamba_cache(cfg, batch, dtype, device,
                                heads=lp["mixer"]["A_log"].shape[0])


def init_cache(cfg: ModelConfig, params: dict, batch: int, max_len: int,
               dtype=torch.float32, *, context=None,
               window: Optional[int] = None, ctx=None) -> dict:
    """Decode cache on the parameters' device, one dict per layer, slot
    (batch) axis first: {"k", "v"} for GQA attention, {"c", "k_rope"} (the
    latent) for MLA, conv histories and the SSM state for Mamba, and for a
    cross-attention layer its K/V over ``context`` (batch: the context's).
    An encoder-decoder config adds ``cache["cross"]``, each decoder layer's
    cross-block K/V over ``context`` (the encoder's output).  Defaults to
    f32 whatever the parameters' dtype, like the JAX package (the SSM
    state is f32 always).  Each layer's cache has the KV heads of its
    ``wk`` and the SSM heads of its ``A_log``: on a tensor-parallel rank's
    parameters, that rank's part (``parallel.planner.cache_specs``).  An
    FSDP ``ctx`` gathers each layer's shards first."""
    win = window if window is not None else cfg.sliding_window
    device = params["embed"].device
    context = _context(cfg, params, context)
    cache = {"layers": [
        _init_layer_cache(cfg, spec, gather_tree(lp, ctx, f"/layers/{i}"),
                          batch, max_len, dtype, device, context, win)
        for i, (spec, lp) in enumerate(zip(cfg.layer_specs(),
                                           params["layers"]))]}
    if cfg.is_encoder_decoder:
        cache["cross"] = [
            attn.init_cross_cache(gather_tree(cp, ctx, f"/cross/{i}"), cfg,
                                  context, dtype)
            for i, cp in enumerate(params["cross"])]
    return cache


def _decode_layer(lp: dict, spec: LayerSpec, cfg: ModelConfig, x, lcache,
                  pos, window, ctx=None, cross_lp=None, cross_cache=None,
                  i: int = 0) -> torch.Tensor:
    lp = gather_tree(lp, ctx, f"/layers/{i}")
    if cross_lp is not None:
        cross_lp = gather_tree(cross_lp, ctx, f"/cross/{i}")
    h = rms_norm(x, lp["norm1"]["scale"], cfg.norm_eps)
    if spec.mixer == "attn" and cfg.attention == "mla":
        h, _ = attn.mla_decode(lp["mixer"], cfg, h, lcache, pos, ctx=ctx)
    elif spec.mixer == "attn":
        h, _ = attn.gqa_decode(lp["mixer"], cfg, h, lcache, pos,
                               window=window, ctx=ctx)
    elif spec.mixer == "cross_attn":
        h = attn.cross_attention_decode(lp["mixer"], cfg, h, lcache,
                                        ctx=ctx)
    else:
        h, _ = ssm.mamba_decode(lp["mixer"], cfg, h, lcache, ctx=ctx)
    x = x + h
    if cross_lp is not None:
        h = rms_norm(x, lp["norm1"]["scale"], cfg.norm_eps)
        x = x + attn.cross_attention_decode(cross_lp, cfg, h, cross_cache,
                                            ctx=ctx)
    if spec.ffn != "none":
        h2 = rms_norm(x, lp["norm2"]["scale"], cfg.norm_eps)
        if spec.ffn == "moe":
            y, _ = moe_mod.moe_apply(lp["ffn"], cfg, h2, ctx=ctx,
                                     decode=True)
        else:
            y = ffn_apply(lp["ffn"], h2, cfg.ffn_act, _tp_ffn(cfg, ctx))
        x = x + y
    return x


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, pos, *, ctx=None,
                window: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
    """tokens: (B, 1) int; pos: int or (B,) position(s) of the new token.
    Returns (logits (B,1,V_pad), cache), the cache updated in place.
    ``ctx``: an expert-parallel context runs the MoE layers through
    ``moe_ep_decode`` (or ``moe_ep_decode_ws``); tokens and cache are then
    this rank's 1/dp of the batch.  A tensor-parallel one runs on this
    rank's blocks and cache and returns its vocabulary block of the logits,
    as ``forward``."""
    if ctx is not None and ctx.tensor_parallel:
        check_tensor_parallel(cfg, ctx.use_ep)
    win = window if window is not None else cfg.sliding_window
    x = _embed(cfg, params, tokens, ctx)
    cross_caches = cache.get("cross") or [None] * cfg.num_layers
    for i, (spec, lp, lc, cross_lp, cc) in enumerate(zip(
            cfg.layer_specs(), params["layers"], cache["layers"],
            _cross_blocks(cfg, params), cross_caches)):
        x = _decode_layer(lp, spec, cfg, x, lc, pos, win, ctx, cross_lp, cc,
                          i)
    return _lm_head(cfg, params, x, ctx), cache
