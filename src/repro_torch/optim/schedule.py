"""Linear-warmup + cosine-decay learning-rate schedule (port of
``repro.optim.schedule``), in f32 like the JAX package."""
from __future__ import annotations

import math

import torch

from repro_torch.core.types import TrainConfig


def lr_schedule(step, tcfg: TrainConfig) -> torch.Tensor:
    """Learning rate at ``step`` (an int or a 0-d tensor, counted from 0):
    warmup on step + 1, then a cosine from 1x to 0.1x over the remaining
    steps.  Returns a 0-d f32 tensor on the step's device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1) / max(tcfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - tcfg.warmup_steps)
                       / max(tcfg.total_steps - tcfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return tcfg.learning_rate * warm * (0.1 + 0.9 * cos)
