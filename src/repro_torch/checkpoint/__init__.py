"""Checkpoints of the port (``repro.checkpoint``): the JAX package's layout
and keys, so that either package restores what the other wrote."""
from repro_torch.checkpoint.io import (  # noqa: F401
    checkpoint_state_bytes,
    restore_checkpoint,
    save_checkpoint,
)
