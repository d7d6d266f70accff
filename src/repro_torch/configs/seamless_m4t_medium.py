"""seamless-m4t-medium [audio] — enc-dec, multimodal [arXiv:2308.11596].

Backbone only: the mel-spectrogram + conv feature extractor frontend is a
stub; ``repro_torch.data.stubs`` provides precomputed frame embeddings (batch, frames,
d_model) for the encoder, and the decoder consumes them via cross-attention.
"""
from repro_torch.core.types import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    source="arXiv:2308.11596",
    num_layers=12,          # decoder layers
    encoder_layers=12,      # encoder layers (self-attn + dense FFN)
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    attention="gqa",
    ffn_act="gelu",
    num_audio_frames=1024,  # stub frontend output length per utterance
)
