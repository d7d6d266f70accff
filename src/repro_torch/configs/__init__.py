"""The model configs of the ten architectures + registry."""
from repro_torch.configs.registry import (  # noqa: F401
    ARCHS, get_config, list_archs, smoke_config)
