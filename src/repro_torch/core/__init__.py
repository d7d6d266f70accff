"""Core types of the port (copied from ``repro.core``, which imports jax):
the shared types and the five-layer paradigm's cross-layer interfaces."""
from repro_torch.core.device import resolve_device  # noqa: F401
from repro_torch.core.types import (  # noqa: F401
    INPUT_SHAPES,
    LONG_500K,
    DECODE_32K,
    MULTI_POD_MESH,
    PREFILL_32K,
    SHAPES_BY_NAME,
    SINGLE_POD_MESH,
    TRAIN_4K,
    LayerSpec,
    MeshConfig,
    ModelConfig,
    ShapeConfig,
    TrainConfig,
)
from repro_torch.core.demand import (  # noqa: F401
    CommDemand,
    CommTask,
    ComputeTask,
    Flow,
    FlowSet,
)
