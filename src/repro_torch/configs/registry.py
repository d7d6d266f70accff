"""Architecture registry of the port: the configs ported so far.

A copy of ``repro.configs.registry`` restricted to the architectures whose
model the port can build: the dense GQA decoders, the Mamba2 SSM, the MoE
decoder and the Mamba/attention/MoE hybrid.  The others (MLA, encoder-
decoder, cross-attention) are known by name and raise
``NotImplementedError`` until their slice is ported.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.core.types import ModelConfig

_MODULES: Dict[str, str] = {
    "granite-3-8b": "granite_3_8b",
    "mamba2-130m": "mamba2_130m",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "dbrx-132b": "dbrx_132b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "qwen2-0.5b": "qwen2_0_5b",
    "starcoder2-3b": "starcoder2_3b",
}

# architectures of the JAX package whose families (MLA, encoder-decoder,
# cross-attention) are not ported yet
_NOT_PORTED = ("deepseek-v2-236b", "seamless-m4t-medium",
               "llama-3.2-vision-90b")

ARCHS: List[str] = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch in _NOT_PORTED:
        raise NotImplementedError(f"{arch}: not ported yet")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def smoke_config(arch: str) -> ModelConfig:
    """Reduced variant of the same family: 2 layers, d_model<=256, <=4
    experts — field for field what ``repro.configs.smoke_config`` gives
    (the MLA, encoder and cross-attention branches are left out with their
    families)."""
    cfg = get_config(arch)
    updates = dict(
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=min(cfg.d_model, 256),
        vocab_size=min(cfg.vocab_size, 512),
        max_seq_len=1024,
    )
    if cfg.attention != "none":
        updates.update(
            num_heads=min(cfg.num_heads, 4),
            num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
            head_dim=32,
            d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        )
    else:
        updates.update(d_ff=0)
    if cfg.is_moe:
        updates.update(
            num_experts=4,
            top_k=min(cfg.top_k, 2),
            moe_d_ff=128,
            num_shared_experts=min(cfg.num_shared_experts, 1),
            moe_first_dense=min(cfg.moe_first_dense, 1),
            moe_layer_period=min(cfg.moe_layer_period, 2),
        )
    if cfg.ssm_state:
        updates.update(ssm_state=16, ssm_head_dim=32)
    if cfg.attn_period:
        # keep the hybrid character with 2 layers: attn at layer 0, mamba at 1
        updates.update(attn_period=2)
    if cfg.sliding_window:
        updates.update(sliding_window=128)
    return dataclasses.replace(cfg, **updates)
