"""starcoder2-3b [dense] — GQA, RoPE [arXiv:2402.19173]."""
from repro_torch.core.types import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    source="arXiv:2402.19173",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    attention="gqa",
    qkv_bias=True,
    ffn_act="gelu",
    rope_theta=100_000.0,
)
