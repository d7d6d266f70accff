from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    FlashAttention,
    flash_attention,
    flash_attention_bwd,
    flash_attention_stats,
)
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    attention_bwd_ref,
    attention_lse_ref,
    attention_ref,
)
