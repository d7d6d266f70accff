"""PowerSGD-style low-rank gradient codec with error feedback.

Port of ``repro.compress.lowrank``.  One subspace iteration: P = orth(M @
Q0), Q = M^T @ P, wire = (P, Q) — ``(m + n) * r`` words against ``m * n``.
The three products (``M @ Q0``, ``M^T @ P`` on the transposed view, and the
decode ``P @ Q^T``) go through the K4 matmul kernel on the card.  Q0 is a
fixed pseudo-random test matrix, deterministic per shape (every rank in a
collective projects into the same subspace), drawn from a
``torch.Generator`` seeded as the JAX package seeds its key, ``r + n %
9973``; its values differ from ``jax.random``'s.  Orthonormalization is
``torch.linalg.qr``, whose column signs may differ from LAPACK's elsewhere;
the decode P P^T M does not depend on them.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.compress.codec import Codec, CodecSpec, Encoded, codec_spec
from repro_torch.kernels.compress.ops import matmul_kernel


def _matrix_shape(shape: Tuple[int, ...]) -> Tuple[int, int]:
    """View any payload as a near-square matrix."""
    n = math.prod(shape)
    if len(shape) >= 2:
        m = shape[0]
        return m, n // m
    # best divisor <= sqrt(n); prime payloads degrade to a single row
    best = 1
    d = 1
    while d * d <= n:
        if n % d == 0:
            best = d
        d += 1
    return best, n // best


class LowRankCodec(Codec):
    def __init__(self, rank: int = 4, spec: Optional[CodecSpec] = None):
        if rank < 1:
            raise ValueError(f"rank must be >= 1, got {rank}")
        self.rank = rank
        self.spec = spec or codec_spec("lowrank")

    def _test_matrix(self, n: int, r: int, device) -> torch.Tensor:
        """Q0, (n, r) standard normal, fixed per (n, r)."""
        gen = torch.Generator(device=device).manual_seed(r + n % 9973)
        return torch.randn((n, r), generator=gen, device=device)

    def _encode(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Encoded:
        m, n = _matrix_shape(tuple(x.shape))
        mat = x.reshape(m, n).to(torch.float32)
        r = min(self.rank, m, n)
        q0 = self._test_matrix(n, r, x.device)
        p = matmul_kernel(mat, q0)          # (m, r)
        p, _ = torch.linalg.qr(p)           # orthonormal columns
        q = matmul_kernel(mat.T, p)         # (n, r), M^T read in place
        wire = (m + n) * r * 4
        return Encoded(self.spec.name, tuple(x.shape), x.dtype, (p, q), wire)

    def decode(self, enc: Encoded) -> torch.Tensor:
        p, q = enc.arrays
        return matmul_kernel(p, q.T).reshape(enc.shape)
