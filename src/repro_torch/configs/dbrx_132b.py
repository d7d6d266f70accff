"""dbrx-132b [moe] — 16 experts top-4, fine-grained [hf:databricks/dbrx-base]."""
from repro_torch.core.types import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    source="hf:databricks/dbrx-base",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    attention="gqa",
    num_experts=16,
    top_k=4,
    moe_d_ff=10752,
    ffn_act="geglu",
)
