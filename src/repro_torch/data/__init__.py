"""Synthetic training data (numpy, host side), copied from ``repro.data``."""
from repro_torch.data.pipeline import SyntheticLM, make_batches  # noqa: F401
