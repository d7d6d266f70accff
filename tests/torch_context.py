"""Helpers of the port's tests for the configs that take a context
(cross-attention and the encoder-decoder): the stub context, and the
cross-attention gates opened.

A fresh cross-attention block has ``gate_attn`` = 0 and adds
``tanh(0) x out`` = 0 to the stream (``init_gqa(cross=True)``), so at init
the logits depend neither on the context nor on the encoder: a parity test
would pass with either broken.  Every parity test of these configs opens
the gates first, on the shared JAX tree, so that both sides use them."""
import numpy as np
import torch

from repro_torch.data import audio_frames, vision_patches

GATE = 0.8  # tanh(0.8) = 0.66


def open_gates(tree, value: float = GATE):
    """A copy of the parameter tree (the JAX package's as numpy, or the
    port's) with every ``gate_attn`` leaf set to ``value``: stacked leaves
    each layer's to ``value`` plus 0.1 per layer, and in the port's lists
    each block's plus 0.1 per block, so that no two are alike."""
    if isinstance(tree, dict):
        return {k: (_gate_like(v, value) if k == "gate_attn"
                    else open_gates(v, value)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [open_gates(v, value + 0.1 * i) for i, v in enumerate(tree)]
    return tree


def _gate_like(leaf, value: float):
    if isinstance(leaf, torch.Tensor):
        return torch.full_like(leaf, value)
    a = np.asarray(leaf)
    g = value + 0.1 * np.arange(a.size, dtype=np.float32).reshape(a.shape)
    return g.astype(a.dtype)


def stub_context(cfg, batch: int, seed: int = 0):
    """The frame or patch embeddings the config's stub frontend gives
    (numpy f32), or None for a config without a context."""
    if cfg.is_encoder_decoder:
        return audio_frames(cfg, batch, seed)
    if cfg.cross_attn_period:
        return vision_patches(cfg, batch, seed)
    return None
