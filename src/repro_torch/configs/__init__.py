"""Model configs ported so far (dense GQA, SSM, MoE, hybrid) + registry."""
from repro_torch.configs.registry import ARCHS, get_config, smoke_config  # noqa: F401
