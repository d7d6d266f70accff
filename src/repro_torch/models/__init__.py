"""Model zoo of the port: dense GQA, Mamba2, MoE and hybrid decoders, with
the JAX package's exports (``encode`` raises until the encoder family is
ported) and its ``ssm`` and ``moe`` submodules, plus ``prefill_launches``,
``train_launches`` and ``ep_launches``, the kernel launches a prefill, a
training step and a rank's expert-parallel forward or decode step make on
the card, and (from ``repro_torch.core.tree``) the tree helpers
``param_leaves`` and ``tree_map``."""
from repro_torch.core.tree import param_leaves, tree_map  # noqa: F401
from repro_torch.models import moe, ssm  # noqa: F401
from repro_torch.models.transformer import (  # noqa: F401
    decode_step,
    encode,
    ep_launches,
    forward,
    init_cache,
    init_params,
    prefill_launches,
    train_launches,
)
