"""Model zoo of the port: dense GQA, Mamba2, MoE and hybrid decoders, with
the JAX package's exports (``encode`` raises until the encoder family is
ported) and its ``ssm`` and ``moe`` submodules, plus ``prefill_launches``,
the kernel launches a prefill makes on the card, and ``param_leaves``."""
from repro_torch.models import moe, ssm  # noqa: F401
from repro_torch.models.transformer import (  # noqa: F401
    decode_step,
    encode,
    forward,
    init_cache,
    init_params,
    param_leaves,
    prefill_launches,
)
