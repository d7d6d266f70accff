"""Plain PyTorch version of the grouped expert GEMM kernel.

Port of ``repro.kernels.moe_gmm.ref.moe_gmm_ref``: the CPU path of the
wrapper, and what the CUDA kernel is held against on the card.
"""
from __future__ import annotations

import torch


def moe_gmm_ref(x, w):
    """x: (E, C, d); w: (E, d, f) -> (E, C, f) in x's dtype."""
    return torch.einsum("ecd,edf->ecf", x, w).to(x.dtype)
