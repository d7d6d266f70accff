"""Modality frontends: stubs, as in the JAX package (``repro.data.stubs``).

[audio]: the mel-spectrogram + conv feature extractor is not implemented;
``audio_frames`` provides precomputed frame embeddings of the right shape.
[vlm]: the ViT/SigLIP vision encoder + projector is not implemented;
``vision_patches`` provides precomputed patch embeddings.

Both draw from the JAX package's numpy ``SeedSequence``s, so their bits
equal its own.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.types import ModelConfig


def audio_frames(cfg: ModelConfig, batch: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([seed, 7]))
    return (rng.standard_normal(
        (batch, cfg.num_audio_frames, cfg.d_model)) * 0.02).astype(np.float32)


def vision_patches(cfg: ModelConfig, batch: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([seed, 11]))
    return (rng.standard_normal(
        (batch, cfg.num_vision_tokens, cfg.d_model)) * 0.02).astype(np.float32)
