"""Core types of the port (copied from ``repro.core``, which imports jax)."""
from repro_torch.core.device import resolve_device  # noqa: F401
from repro_torch.core.types import (  # noqa: F401
    LayerSpec,
    MeshConfig,
    ModelConfig,
    TrainConfig,
)
