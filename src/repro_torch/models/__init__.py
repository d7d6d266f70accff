"""Model zoo of the port: dense GQA, MLA, Mamba2, MoE, hybrid and
cross-attention decoders and the encoder-decoder stack, with the JAX
package's exports and its ``ssm`` and ``moe`` submodules, plus
``prefill_launches``, ``encode_launches``, ``train_launches`` and
``ep_launches``, the kernel launches a prefill, an encoder pass, a
training step and a rank's forward or decode step on a model axis make on
the card, and (from ``repro_torch.core.tree``) the tree helpers
``param_leaves`` and ``tree_map``."""
from repro_torch.core.tree import param_leaves, tree_map  # noqa: F401
from repro_torch.models import moe, ssm  # noqa: F401
from repro_torch.models.transformer import (  # noqa: F401
    decode_step,
    encode,
    encode_launches,
    ep_launches,
    forward,
    init_cache,
    init_params,
    prefill_launches,
    train_launches,
)
