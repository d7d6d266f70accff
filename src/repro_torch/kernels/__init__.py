"""Hand-written Hopper kernels of the port, each beside its plain version.

``WRAPPERS`` maps each kernel to its public wrapper; every wrapper carries a
``launches`` count that it raises by the number of CUDA kernels it launches,
where it launches them.
``SOURCES`` maps each kernel to its CUDA source (the four compression
kernels share one).  ``flash_attention_bwd``, ``ssd_scan_bwd`` and
``moe_gmm_bwd`` are the gradients of K1, K6 and K5, which the forward-only
TPU kernels do not have.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels.compress import ops as _cmp
from repro_torch.kernels.flash_attention import ops as _fa
from repro_torch.kernels.moe_gmm import ops as _gmm
from repro_torch.kernels.ssd_scan import ops as _ssd

WRAPPERS = {"flash_attention": _fa.flash_attention,
            "flash_attention_bwd": _fa.flash_attention_bwd,
            "ssd_scan": _ssd.ssd_scan,
            "ssd_scan_bwd": _ssd.ssd_scan_bwd,
            "moe_gmm": _gmm.moe_gmm,
            "moe_gmm_bwd": _gmm.moe_gmm_bwd,
            "quantize": _cmp.quantize_kernel,
            "dequantize": _cmp.dequantize_kernel,
            "sparsify": _cmp.sparsify_kernel,
            "matmul": _cmp.matmul_kernel}
SOURCES = {"flash_attention": _fa.SOURCE,
           "flash_attention_bwd": _fa.BWD_SOURCE,
           "ssd_scan": _ssd.SOURCE,
           "ssd_scan_bwd": _ssd.BWD_SOURCE,
           "moe_gmm": _gmm.SOURCE,
           "moe_gmm_bwd": _gmm.BWD_SOURCE,
           "quantize": _cmp.SOURCE,
           "dequantize": _cmp.SOURCE,
           "sparsify": _cmp.SOURCE,
           "matmul": _cmp.SOURCE}


def reset_launch_counts() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: w.launches for name, w in WRAPPERS.items()}
