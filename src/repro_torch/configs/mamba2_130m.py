"""mamba2-130m [ssm] — SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.core.types import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    source="arXiv:2405.21060",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,            # attention-free, no separate FFN (Mamba2 block only)
    vocab_size=50280,
    attention="none",
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,   # d_inner=1536 -> 24 SSD heads
    ssm_conv_kernel=4,
    tie_embeddings=True,
)
