"""h2o-danube-1.8b [dense] — llama+mistral mix, SWA [arXiv:2401.16818]."""
from repro_torch.core.types import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    source="arXiv:2401.16818",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32000,
    attention="gqa",
    sliding_window=4096,  # mistral-style SWA -> long_500k is native
    ffn_act="swiglu",
)
