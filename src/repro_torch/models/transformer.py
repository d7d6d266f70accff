"""Full-model assembly: embeddings -> decoder layers -> LM head.

Port of ``repro.models.transformer`` for decoders whose layers mix GQA
self-attention or Mamba2 (``LayerSpec.mixer``) with a dense, MoE or no FFN
(``LayerSpec.ffn``): the dense GQA family, the SSM, MoE and the hybrid.  The
JAX package scans over parameters stacked per layer group; here the
parameters are a list of per-layer dicts (``params["layers"]``) walked by a
Python loop, in the JAX layer order.  MLA, cross-attention and encoder
configs raise ``NotImplementedError`` when their parameters are made
(``init_params``, ``repro_torch.bridge.params_from_jax``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.device import resolve_device
from repro_torch.core.types import LayerSpec, ModelConfig
from repro_torch.kernels.flash_attention.ops import \
    LAUNCHES_PER_CALL as FA_BWD_LAUNCHES
from repro_torch.kernels.ssd_scan.ops import LAUNCHES_PER_CALL as SSD_LAUNCHES
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.modules import (dense_init, embed_init, ffn_apply,
                                        init_ffn, init_norm, rms_norm)


def check_ported(cfg: ModelConfig) -> None:
    """Raise for the families not ported yet: MLA, cross-attention and
    encoder-decoder configs."""
    if cfg.attention == "mla" or cfg.is_encoder_decoder or \
            any(s.mixer == "cross_attn" for s in cfg.layer_specs()):
        raise NotImplementedError(
            f"{cfg.name}: MLA, cross-attention and encoder-decoder layers "
            f"are not ported yet")


def prefill_launches(cfg: ModelConfig) -> dict:
    """Kernel launches of one ``forward`` on CUDA tensors, by the names of
    ``repro_torch.kernels.WRAPPERS``: flash attention once per attention
    layer, the SSD scan's three stages once per Mamba layer, the grouped
    expert GEMM three times (gate, up, down) per MoE layer."""
    specs = cfg.layer_specs()
    return {"flash_attention": sum(s.mixer == "attn" for s in specs),
            "ssd_scan": SSD_LAUNCHES * sum(s.mixer == "mamba"
                                           for s in specs),
            "moe_gmm": 3 * sum(s.ffn == "moe" for s in specs)}


def train_launches(cfg: ModelConfig, microbatches: int = 1,
                   remat: bool = False) -> dict:
    """Flash-attention launches of one training step on CUDA tensors
    (``repro_torch.train.make_train_step``): the forward once per attention
    layer and microbatch, twice with ``remat`` (the checkpointed layer runs
    again in the backward), and the backward kernel's
    ``LAUNCHES_PER_CALL`` per attention layer and microbatch.  (Training a
    Mamba or MoE layer on the card raises until K6 and K5 have backward
    kernels.)"""
    n_attn = sum(s.mixer == "attn" for s in cfg.layer_specs())
    return {"flash_attention": n_attn * microbatches * (2 if remat else 1),
            "flash_attention_bwd": n_attn * microbatches * FA_BWD_LAUNCHES}


def ep_launches(cfg: ModelConfig) -> dict:
    """K5 launches of one rank in one expert-parallel forward
    (``moe_ep_train``) or decode step (``moe_ep_decode``,
    ``moe_ep_decode_ws``): three (gate, up, down) per MoE layer on its own
    experts, whatever the mesh."""
    return {"moe_gmm": 3 * sum(s.ffn == "moe" for s in cfg.layer_specs())}


def _init_layer(cfg: ModelConfig, spec: LayerSpec, dtype, device,
                generator: torch.Generator, ctx=None) -> dict:
    p = {"norm1": init_norm(cfg.d_model, dtype, device)}
    if spec.mixer == "attn":
        p["mixer"] = attn.init_gqa(cfg, dtype, device, generator)
    else:
        p["mixer"] = ssm.init_mamba(cfg, dtype, device, generator)
    if spec.ffn != "none":
        p["norm2"] = init_norm(cfg.d_model, dtype, device)
        if spec.ffn == "moe":
            p["ffn"] = moe_mod.init_moe(cfg, dtype, device, generator, ctx)
        else:
            p["ffn"] = init_ffn(cfg, cfg.d_ff, dtype, device, generator)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda", ctx=None) -> dict:
    """Random parameters in the JAX package's layout, drawn from
    ``generator`` (which must live on ``device``).  With an
    expert-parallel ``ctx`` each MoE layer keeps only this rank's part of
    its experts (``parallel.shard_params``'s layout; ``models.moe.
    init_moe`` draws the rest and drops it), bit-equal to the same part of
    the full draw."""
    check_ported(cfg)
    dev = resolve_device(device)
    params = {
        "embed": embed_init(cfg.padded_vocab, cfg.d_model, dtype, dev,
                            generator),
        "final_norm": init_norm(cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(cfg.d_model, (cfg.padded_vocab,),
                                       dtype, dev, generator)
    params["layers"] = [_init_layer(cfg, spec, dtype, dev, generator, ctx)
                        for spec in cfg.layer_specs()]
    return params


def _vocab_bias(cfg: ModelConfig, dtype, device) -> torch.Tensor:
    """NEG_INF on the padded vocabulary ids, so argmax never picks one."""
    v = torch.arange(cfg.padded_vocab, device=device)
    return torch.where(v < cfg.vocab_size, 0.0, attn.NEG_INF).to(dtype)


def _lm_head(cfg: ModelConfig, params: dict, x) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["lm_head"]
    return logits + _vocab_bias(cfg, logits.dtype, logits.device)


def _apply_layer(lp: dict, spec: LayerSpec, cfg: ModelConfig, x,
                 positions, window, ctx=None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One decoder layer over the whole sequence; returns (x, aux_loss),
    aux_loss None without a MoE FFN."""
    h = rms_norm(x, lp["norm1"]["scale"], cfg.norm_eps)
    if spec.mixer == "attn":
        h = attn.gqa_forward(lp["mixer"], cfg, h, positions, window=window)
    else:
        h = ssm.mamba_forward(lp["mixer"], cfg, h)
    x = x + h
    aux = None
    if spec.ffn != "none":
        h2 = rms_norm(x, lp["norm2"]["scale"], cfg.norm_eps)
        if spec.ffn == "moe":
            y, aux = moe_mod.moe_apply(lp["ffn"], cfg, h2, ctx=ctx)
        else:
            y = ffn_apply(lp["ffn"], h2, cfg.ffn_act)
        x = x + y
    return x, aux


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            window: Optional[int] = None, remat: bool = False, ctx=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) int. Returns (logits (B,S,V_pad), aux_loss): the sum
    of the MoE layers' router losses (0 without MoE).

    ``window`` overrides cfg.sliding_window.  ``remat``: each layer under
    ``torch.utils.checkpoint`` (non-reentrant), its activations recomputed
    in the backward, as the JAX package's ``jax.checkpoint`` of each layer
    group's scan body under ``ctx.remat``.  ``ctx``: a
    ``repro_torch.parallel.ParallelCtx``, whose data ranks share the MoE
    router's load statistics (``models.moe.route``) and whose MoE layers
    run expert-parallel over its model axis where ``ctx.use_ep``
    (``models.moe.moe_ep_train``)."""
    x = params["embed"][tokens]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    win = window if window is not None else cfg.sliding_window
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for spec, lp in zip(cfg.layer_specs(), params["layers"]):
        if remat:
            x, a = checkpoint(_apply_layer, lp, spec, cfg, x, positions, win,
                              ctx, use_reentrant=False)
        else:
            x, a = _apply_layer(lp, spec, cfg, x, positions, win, ctx)
        if a is not None:
            aux = aux + a
    return _lm_head(cfg, params, x), aux


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor):
    """Encoder stack of the encoder-decoder family: not ported yet."""
    raise NotImplementedError(f"{cfg.name}: the encoder stack is not ported "
                              f"yet")


def init_cache(cfg: ModelConfig, params: dict, batch: int, max_len: int,
               dtype=torch.float32, *, window: Optional[int] = None) -> dict:
    """Decode cache on the parameters' device, one dict per layer, slot
    (batch) axis first: {"k", "v"} for attention, conv histories and the
    SSM state for Mamba.  Defaults to f32 whatever the parameters' dtype,
    like the JAX package (the SSM state is f32 always)."""
    win = window if window is not None else cfg.sliding_window
    device = params["embed"].device
    return {"layers": [
        attn.init_kv_cache(cfg, batch, max_len, dtype, device, window=win)
        if spec.mixer == "attn" else
        ssm.init_mamba_cache(cfg, batch, dtype, device)
        for spec in cfg.layer_specs()]}


def _decode_layer(lp: dict, spec: LayerSpec, cfg: ModelConfig, x, lcache,
                  pos, window, ctx=None) -> torch.Tensor:
    h = rms_norm(x, lp["norm1"]["scale"], cfg.norm_eps)
    if spec.mixer == "attn":
        h, _ = attn.gqa_decode(lp["mixer"], cfg, h, lcache, pos,
                               window=window)
    else:
        h, _ = ssm.mamba_decode(lp["mixer"], cfg, h, lcache)
    x = x + h
    if spec.ffn != "none":
        h2 = rms_norm(x, lp["norm2"]["scale"], cfg.norm_eps)
        if spec.ffn == "moe":
            y, _ = moe_mod.moe_apply(lp["ffn"], cfg, h2, ctx=ctx,
                                     decode=True)
        else:
            y = ffn_apply(lp["ffn"], h2, cfg.ffn_act)
        x = x + y
    return x


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, pos, *, ctx=None,
                window: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
    """tokens: (B, 1) int; pos: int or (B,) position(s) of the new token.
    Returns (logits (B,1,V_pad), cache), the cache updated in place.
    ``ctx``: an expert-parallel context runs the MoE layers through
    ``moe_ep_decode`` (or ``moe_ep_decode_ws``); tokens and cache are then
    this rank's 1/dp of the batch."""
    win = window if window is not None else cfg.sliding_window
    x = params["embed"][tokens]
    for spec, lp, lc in zip(cfg.layer_specs(), params["layers"],
                            cache["layers"]):
        x = _decode_layer(lp, spec, cfg, x, lc, pos, win, ctx)
    return _lm_head(cfg, params, x), cache
