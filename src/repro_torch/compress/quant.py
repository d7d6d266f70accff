"""Uniform int8/int4 quantization codec.

Port of ``repro.compress.quant``.  One symmetric absmax scale per tensor
(the quantize kernel K2a with a single row, then K2b to decode, on the
card); int4 payloads are nibble-packed so the wire bytes really are half
of int8's, the same bytes as the JAX package's.

Rounding: deterministic half-to-even by default.  Construct with
``stochastic=True`` (and pass ``generator=`` to every encode) for unbiased
rounding, E[decode(encode(x))] = x; a stochastic codec with no generator
raises instead of silently degrading to biased rounding.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.compress.codec import Codec, CodecSpec, Encoded, codec_spec
from repro_torch.kernels.compress.ops import (dequantize_kernel,
                                              quantize_kernel)
from repro_torch.kernels.compress.ref import (pack_int4, random_bits,
                                              unpack_int4)


class QuantCodec(Codec):
    def __init__(self, bits: int = 8, stochastic: bool = False,
                 spec: Optional[CodecSpec] = None):
        if bits not in (4, 8):
            raise ValueError(f"bits must be 4 or 8, got {bits}")
        self.bits = bits
        self.stochastic = stochastic
        self.spec = spec or codec_spec(f"q{bits}")

    def _encode(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Encoded:
        if self.stochastic and generator is None:
            raise ValueError(
                "QuantCodec(stochastic=True) needs generator= on every "
                "encode; use stochastic=False for deterministic rounding")
        row = x.reshape(1, -1)
        rand = (random_bits(row.shape, generator, row.device)
                if self.stochastic else None)
        q, scale = quantize_kernel(row, rand, bits=self.bits,
                                   stochastic=self.stochastic)
        q = q.reshape(-1)
        if self.bits == 4:
            q = pack_int4(q)
        wire = math.ceil(row.numel() * self.bits / 8) + 4  # payload + scale
        return Encoded(self.spec.name, tuple(x.shape), x.dtype,
                       (q, scale.reshape(1)), wire)

    def decode(self, enc: Encoded) -> torch.Tensor:
        q, scale = enc.arrays
        n = math.prod(enc.shape)
        if self.bits == 4:
            q = unpack_int4(q, n)
        return dequantize_kernel(q.reshape(1, -1), scale.reshape(1, 1)
                                 ).reshape(enc.shape)
