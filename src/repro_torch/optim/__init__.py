"""Optimizer of the port (``repro.optim``): AdamW with global-norm clipping
and the warmup + cosine schedule."""
from repro_torch.optim.adamw import (  # noqa: F401
    adamw_shard_update,
    adamw_update,
    gather_opt_state,
    global_norm,
    init_opt_state,
)
from repro_torch.optim.schedule import lr_schedule  # noqa: F401
