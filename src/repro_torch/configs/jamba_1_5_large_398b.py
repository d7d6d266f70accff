"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887]."""
from repro_torch.core.types import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    source="arXiv:2403.19887",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    attention="gqa",
    attn_period=8,        # 1 attn : 7 mamba -> 9 attn layers out of 72
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=128,     # d_inner=16384 -> 128 SSD heads
    ssm_conv_kernel=4,
    num_experts=16,
    top_k=2,
    moe_d_ff=24576,
    moe_layer_period=2,   # MoE every other layer, as in Jamba
    ffn_act="swiglu",
)
