"""Synthetic training data and the modality stubs (numpy, host side),
copied from ``repro.data``."""
from repro_torch.data.pipeline import SyntheticLM, make_batches  # noqa: F401
from repro_torch.data.stubs import audio_frames, vision_patches  # noqa: F401
