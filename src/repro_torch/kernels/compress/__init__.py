from repro_torch.kernels.compress.ops import (  # noqa: F401
    dequantize, dequantize_kernel, lowrank_project, matmul_kernel, quantize,
    quantize_kernel, sparsify, sparsify_kernel, wire_codec)
from repro_torch.kernels.compress.ref import (  # noqa: F401
    dequantize_ref, matmul_ref, pack_int4, quantize_ref, random_bits,
    sparsify_ref, unpack_int4)
