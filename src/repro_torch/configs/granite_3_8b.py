"""granite-3-8b [dense] — GQA [hf:ibm-granite/granite-3.0-2b-base]."""
from repro_torch.core.types import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    source="hf:ibm-granite/granite-3.0-2b-base",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    attention="gqa",
    ffn_act="swiglu",
    rope_theta=10_000.0,
)
