"""Meta-tensor stand-ins for every model input (no device allocation):
the port's counterpart of ``repro.launch.specs``.

Where the JAX package describes an input by a ``jax.ShapeDtypeStruct``,
the port uses a tensor on the ``meta`` device: a shape and a dtype, no
storage, and every PyTorch op runs on it as a shape function.
``input_specs`` is the dry-run's workload description: training batches,
prefill prompts, or decode steps with their KV/SSM caches.  The
long-context policy (which architectures decode 500k tokens natively vs.
via the sliding-window variant) lives here as ``decode_window``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.types import ModelConfig, ShapeConfig

SWA_VARIANT_WINDOW = 8192
META = torch.device("meta")


def decode_window(cfg: ModelConfig, shape: ShapeConfig) -> Optional[int]:
    """Window override for decode shapes.  None = model's own policy.

    long_500k policy (DESIGN.md §Arch-applicability):
      native   — SSM (no KV), hybrid (9 attn layers, seq-sharded cache),
                 MLA (compact latent cache), archs with built-in SWA;
      variant  — full-attention dense/MoE/VLM archs run the sliding-window
                 variant (window 8192), flagged in the roofline table.
    """
    if shape.name != "long_500k":
        return None
    if cfg.sliding_window or cfg.attention == "none" or cfg.attn_period:
        return None
    if cfg.attention == "mla":
        return None
    return SWA_VARIANT_WINDOW


def uses_swa_variant(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    return decode_window(cfg, shape) is not None


def context_spec(cfg: ModelConfig, batch: int, dtype
                 ) -> Optional[torch.Tensor]:
    if cfg.is_encoder_decoder:
        return torch.empty((batch, cfg.num_audio_frames, cfg.d_model),
                           dtype=dtype, device=META)
    if cfg.cross_attn_period:
        return torch.empty((batch, cfg.num_vision_tokens, cfg.d_model),
                           dtype=dtype, device=META)
    return None


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Model inputs as meta tensors (token ids int32, as the JAX
    package's)."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def spec(*dims, dt=i32):
        return torch.empty(dims, dtype=dt, device=META)

    if shape.kind in ("train", "prefill"):
        out = {"tokens": spec(b, s)}
        if shape.kind == "train":
            out["labels"] = spec(b, s)
        ctxs = context_spec(cfg, b, dtype)
        if ctxs is not None:
            out["context"] = ctxs
        return out
    # decode: one new token against a cache of seq_len
    return {"tokens": spec(b, 1), "pos": spec()}


def cache_shapes(cfg: ModelConfig, shape: ShapeConfig, param_shapes,
                 dtype=torch.bfloat16) -> dict:
    """The decode cache of this workload on the meta device: the port's
    ``models.init_cache`` over ``param_shapes`` (meta parameters of the
    full model) with the decode window and the meta context; the port's
    layout, one dict a layer (no group-stacking dim)."""
    from repro_torch.models.transformer import init_cache
    ctx_s = context_spec(cfg, shape.global_batch, dtype)
    return init_cache(cfg, param_shapes, shape.global_batch, shape.seq_len,
                      dtype, context=ctx_s,
                      window=decode_window(cfg, shape))
