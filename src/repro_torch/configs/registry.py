"""Architecture registry of the port: a copy of ``repro.configs.registry``
(``--arch <id>`` resolution and the reduced smoke variants), all ten
architectures of the JAX package."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.core.types import ModelConfig

_MODULES: Dict[str, str] = {
    "granite-3-8b": "granite_3_8b",
    "mamba2-130m": "mamba2_130m",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "dbrx-132b": "dbrx_132b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "qwen2-0.5b": "qwen2_0_5b",
    "starcoder2-3b": "starcoder2_3b",
}

ARCHS: List[str] = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def list_archs() -> List[str]:
    return list(ARCHS)


def smoke_config(arch: str) -> ModelConfig:
    """Reduced variant of the same family: 2 layers, d_model<=256, <=4
    experts — field for field what ``repro.configs.smoke_config`` gives."""
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
    if cfg.attention == "mla":
        updates.update(kv_lora_rank=64, q_lora_rank=96,
                       qk_rope_head_dim=16, v_head_dim=32)
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
    if cfg.encoder_layers:
        updates.update(encoder_layers=2, num_audio_frames=64)
    if cfg.cross_attn_period:
        updates.update(cross_attn_period=2, num_vision_tokens=16)
    if cfg.sliding_window:
        updates.update(sliding_window=128)
    return dataclasses.replace(cfg, **updates)
