"""Gradient-compression subsystem (paper Sec. II-A lever 3), the port of
``repro.compress``.

``codec``      static :class:`CodecSpec` pricing contracts, the executable
               :class:`Codec` API with generic error feedback, the
               registry, and the ``"algo+codec"`` naming convention.
``quant``      int8/int4 uniform quantization (K2a/K2b on the card).
``topk``       magnitude sparsification with error-feedback residual.
``lowrank``    PowerSGD-style rank-r factorization (K4 on the card).

The quantizing collectives of ``repro_torch.ccl.primitives`` share the
K2a/K2b kernels through ``repro_torch.kernels.compress.ops.wire_codec``.
"""
from repro_torch.compress.codec import (Codec, CodecSpec, Encoded,  # noqa: F401
                                        SPECS, base_algorithm, codec_spec,
                                        get_codec, register_codec,
                                        split_algorithm)
from repro_torch.compress.lowrank import LowRankCodec  # noqa: F401
from repro_torch.compress.quant import QuantCodec  # noqa: F401
from repro_torch.compress.topk import TopKCodec  # noqa: F401
