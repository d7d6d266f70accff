"""llama-3.2-vision-90b [vlm] — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision].

Backbone only: the ViT vision encoder + projector is a stub; ``input_specs``
provides precomputed patch embeddings (batch, patches, d_model).  100 layers
with one cross-attention layer every 5th layer (20 cross-attn + 80 self-attn),
matching the Llama-3.2-Vision interleave ratio.
"""
from repro_torch.core.types import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    attention="gqa",
    cross_attn_period=5,     # layers 4, 9, ... are cross-attention
    num_vision_tokens=1601,  # (448/14)^2 + cls, Llama-3.2 vision tile
    ffn_act="swiglu",
    rope_theta=500_000.0,
)
