"""Model configs ported so far (the dense GQA family) + registry."""
from repro_torch.configs.registry import ARCHS, get_config, smoke_config  # noqa: F401
