"""Architecture registry of the port: the dense GQA configs ported so far.

A copy of ``repro.configs.registry`` restricted to the architectures whose
model the port can build.  The others are known by name and raise
``NotImplementedError`` until their slice is ported.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.core.types import ModelConfig

_MODULES: Dict[str, str] = {
    "granite-3-8b": "granite_3_8b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "qwen2-0.5b": "qwen2_0_5b",
    "starcoder2-3b": "starcoder2_3b",
}

# architectures of the JAX package whose families (MLA, MoE, SSM, hybrid,
# encoder-decoder, cross-attention) are not ported yet
_NOT_PORTED = ("mamba2-130m", "deepseek-v2-236b", "dbrx-132b",
               "seamless-m4t-medium", "llama-3.2-vision-90b",
               "jamba-1.5-large-398b")

ARCHS: List[str] = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch in _NOT_PORTED:
        raise NotImplementedError(f"{arch}: not ported yet")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def smoke_config(arch: str) -> ModelConfig:
    """Reduced variant of the same family: 2 layers, d_model<=256, head_dim
    32 — field for field what ``repro.configs.smoke_config`` gives for the
    dense GQA archs."""
    cfg = get_config(arch)
    updates = dict(
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=min(cfg.d_model, 256),
        vocab_size=min(cfg.vocab_size, 512),
        max_seq_len=1024,
        num_heads=min(cfg.num_heads, 4),
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=32,
        d_ff=min(cfg.d_ff, 512),
    )
    if cfg.sliding_window:
        updates.update(sliding_window=128)
    return dataclasses.replace(cfg, **updates)
