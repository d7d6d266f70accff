"""The model configs of the ten architectures + registry."""
from repro_torch.configs.registry import ARCHS, get_config, smoke_config  # noqa: F401
