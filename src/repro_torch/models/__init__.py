"""Model zoo of the port: the dense GQA decoder, with the JAX package's
exports (``encode`` raises until the encoder family is ported)."""
from repro_torch.models.transformer import (  # noqa: F401
    decode_step,
    encode,
    forward,
    init_cache,
    init_params,
)
