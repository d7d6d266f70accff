"""Top-k magnitude sparsification with error feedback (DGC-style).

Port of ``repro.compress.topk``.  Keeps the ``fraction`` largest-magnitude
entries (values + int32 indices on the wire, hence ``wire_ratio = 2 *
fraction`` for f32 payloads) and carries the dropped mass in a residual
that re-enters the next step's input.  Like the JAX codec (``lax.top_k``
and a scatter) it selects with ``torch.topk`` and scatters back; it runs no
threshold kernel, because a threshold pass keeps every entry tied with the
k-th magnitude, more than k.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.compress.codec import Codec, CodecSpec, Encoded, codec_spec


class TopKCodec(Codec):
    def __init__(self, fraction: float = 0.05,
                 spec: Optional[CodecSpec] = None):
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got {fraction}")
        self.fraction = fraction
        self.spec = spec or codec_spec("topk")

    def _k(self, n: int) -> int:
        return max(1, int(n * self.fraction))

    def _encode(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Encoded:
        flat = x.reshape(-1).to(torch.float32)
        k = self._k(flat.numel())
        _, idx = torch.topk(flat.abs(), k)
        values = flat[idx]
        wire = k * (4 + 4)  # fp32 value + int32 index
        return Encoded(self.spec.name, tuple(x.shape), x.dtype,
                       (values, idx.to(torch.int32)), wire)

    def decode(self, enc: Encoded) -> torch.Tensor:
        values, idx = enc.arrays
        n = math.prod(enc.shape)
        dense = torch.zeros((n,), dtype=torch.float32, device=values.device)
        dense[idx.long()] = values
        return dense.reshape(enc.shape)
