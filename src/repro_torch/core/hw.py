"""Target hardware constants (NVIDIA H100 SXM) for the roofline model.

The port's counterpart of ``repro.core.hw``, which describes the JAX
package's target chip.  These are datasheet figures of the card the port
runs on, as ``nvidia-smi --query-gpu=name,power.limit`` reports it:
``NVIDIA H100 80GB HBM3, 700.00 W``.  They are peaks, not measurements; a
card set below 700 W runs below them under load.  The demand builder turns
FLOPs into compute seconds with ``PEAK_FLOPS_BF16``, and ``chip_smoke.py``
reads the kernels' bounds from the same numbers.
"""

PEAK_FLOPS_BF16 = 989e12     # FLOP/s, tensor cores, dense (no sparsity)
PEAK_FLOPS_TF32 = 495e12     # FLOP/s, tensor cores, dense
PEAK_FLOPS_F32 = 67e12       # FLOP/s, CUDA cores, outside the tensor cores
HBM_BW = 3.35e12             # bytes/s, HBM3
HBM_BYTES = 80 * 2 ** 30     # 80 GiB of HBM3
NVLINK_BW = 450e9            # bytes/s a direction: NVLink 4, 18 links x 25 GB/s


def roofline_seconds(flops: float, hbm_bytes: float, coll_bytes: float,
                     chips: int) -> dict:
    """The three roofline terms (seconds) from Sec. ROOFLINE ANALYSIS.

    ``flops``/``hbm_bytes`` are TOTALS across chips (cost_analysis of the
    SPMD module is per-device; callers pass per-device numbers with
    chips=1).  ``coll_bytes`` is the summed operand bytes of collective ops
    per device."""
    return {
        "compute_s": flops / (chips * PEAK_FLOPS_BF16),
        "memory_s": hbm_bytes / (chips * HBM_BW),
        "collective_s": coll_bytes / (chips * NVLINK_BW),
    }
