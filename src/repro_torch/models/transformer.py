"""Full-model assembly: embeddings -> decoder layers -> LM head.

Port of ``repro.models.transformer`` for configs whose every layer is GQA
self-attention plus a dense FFN.  The JAX package scans over parameters
stacked per layer group; here the parameters are a list of per-layer dicts
(``params["layers"]``) walked by a Python loop, in the JAX layer order.
MLA, MoE, Mamba, cross-attention and encoder configs raise
``NotImplementedError`` when their parameters are made (``init_params``,
``repro_torch.bridge.params_from_jax``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.types import LayerSpec, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.modules import (dense_init, embed_init, ffn_apply,
                                        init_ffn, init_norm, rms_norm)

_PORTED_LAYER = LayerSpec(mixer="attn", ffn="dense")


def check_ported(cfg: ModelConfig) -> None:
    """Raise unless every layer of ``cfg`` is GQA self-attention plus a
    dense FFN."""
    if cfg.attention != "gqa" or cfg.is_encoder_decoder or \
            any(s != _PORTED_LAYER for s in cfg.layer_specs()):
        raise NotImplementedError(
            f"{cfg.name}: only GQA self-attention + dense FFN layers are "
            f"ported yet")


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda") -> dict:
    """Random parameters in the JAX package's layout, drawn from
    ``generator`` (which must live on ``device``)."""
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
    params["layers"] = [
        {"norm1": init_norm(cfg.d_model, dtype, dev),
         "mixer": attn.init_gqa(cfg, dtype, dev, generator),
         "norm2": init_norm(cfg.d_model, dtype, dev),
         "ffn": init_ffn(cfg, cfg.d_ff, dtype, dev, generator)}
        for _ in range(cfg.num_layers)]
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


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            window: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) int. Returns (logits (B,S,V_pad), aux_loss).

    ``window`` overrides cfg.sliding_window.  aux_loss is 0: no MoE router
    is ported."""
    x = params["embed"][tokens]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    win = window if window is not None else cfg.sliding_window
    for lp in params["layers"]:
        h = rms_norm(x, lp["norm1"]["scale"], cfg.norm_eps)
        x = x + attn.gqa_forward(lp["mixer"], cfg, h, positions, window=win)
        h = rms_norm(x, lp["norm2"]["scale"], cfg.norm_eps)
        x = x + ffn_apply(lp["ffn"], h, cfg.ffn_act)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _lm_head(cfg, params, x), aux


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor):
    """Encoder stack of the encoder-decoder family: not ported yet."""
    raise NotImplementedError(f"{cfg.name}: the encoder stack is not ported "
                              f"yet")


def init_cache(cfg: ModelConfig, params: dict, batch: int, max_len: int,
               dtype=torch.float32, *, window: Optional[int] = None) -> dict:
    """Decode cache on the parameters' device: one {"k", "v"} per layer,
    slot (batch) axis first.  Defaults to f32 whatever the parameters'
    dtype, like the JAX package."""
    win = window if window is not None else cfg.sliding_window
    device = params["embed"].device
    return {"layers": [attn.init_kv_cache(cfg, batch, max_len, dtype, device,
                                          window=win)
                       for _ in range(cfg.num_layers)]}


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, pos, *,
                window: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
    """tokens: (B, 1) int; pos: int or (B,) position(s) of the new token.
    Returns (logits (B,1,V_pad), cache), the cache updated in place."""
    win = window if window is not None else cfg.sliding_window
    x = params["embed"][tokens]
    for lp, lc in zip(params["layers"], cache["layers"]):
        h = rms_norm(x, lp["norm1"]["scale"], cfg.norm_eps)
        h, _ = attn.gqa_decode(lp["mixer"], cfg, h, lc, pos, window=win)
        x = x + h
        h = rms_norm(x, lp["norm2"]["scale"], cfg.norm_eps)
        x = x + ffn_apply(lp["ffn"], h, cfg.ffn_act)
    return _lm_head(cfg, params, x), cache
