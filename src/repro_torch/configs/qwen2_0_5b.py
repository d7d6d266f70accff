"""qwen2-0.5b [dense] — GQA, QKV bias [arXiv:2407.10671]."""
from repro_torch.core.types import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    source="arXiv:2407.10671",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151936,
    attention="gqa",
    qkv_bias=True,
    ffn_act="swiglu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
