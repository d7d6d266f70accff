"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434]."""
from repro_torch.core.types import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    source="arXiv:2405.04434",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,   # MLA: per-head KV decompressed from the latent
    head_dim=128,       # qk_nope head dim
    d_ff=12288,         # dense FFN (first layer only, as in the paper)
    vocab_size=102400,
    attention="mla",
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=160,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1536,
    moe_first_dense=1,
    ffn_act="swiglu",
)
