"""Plain PyTorch versions of the compression kernels.

Port of ``repro.kernels.compress.ref``: the CPU path of the wrappers in
``ops.py``, and what the CUDA kernels are held against on the card.

Stochastic rounding takes its random bits as an input, as the TPU kernel
does: uint32 values carried in an ``int32`` (or ``int64``) tensor, of which
the top 24 bits make u in [0, 1).  Whoever needs fresh bits draws them from
an explicit ``torch.Generator`` (``random_bits``); the same bits give the
same result on every device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

_TINY = 1e-30  # guards scale against all-zero payloads


def random_bits(shape, generator: torch.Generator, device=None
                ) -> torch.Tensor:
    """uint32 random bits, carried as int32 (the same 32 bits)."""
    return torch.randint(-2 ** 31, 2 ** 31, tuple(shape), dtype=torch.int32,
                         generator=generator, device=device)


def uniform_from_bits(rand_bits: torch.Tensor) -> torch.Tensor:
    """u = (bits >> 8) * 2^-24 in f32, exact; the mask undoes the sign
    extension of an int32 shift."""
    top = (rand_bits.to(torch.int64) >> 8) & 0xFFFFFF
    return top.to(torch.float32) * (2.0 ** -24)


def quantize_ref(x: torch.Tensor, bits: int = 8, stochastic: bool = False,
                 rand_bits: Optional[torch.Tensor] = None,
                 per_row: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform symmetric quantization to ``bits`` (stored as int8).

    ``per_row=True`` scales each row of a 2D input independently (the
    kernel's layout); otherwise one scale covers the whole tensor.
    Rounding is half-to-even, or stochastic as floor(x/scale + u) with u
    from ``rand_bits`` (same shape as ``x``)."""
    qmax = float(2 ** (bits - 1) - 1)
    x32 = x.to(torch.float32)
    if per_row:
        absmax = x32.abs().amax(dim=-1, keepdim=True)
    else:
        absmax = x32.abs().max()
    # qmax as a tensor on x's device: PyTorch's CUDA division by a host
    # scalar multiplies by its reciprocal, which is not the quotient
    scale = torch.clamp_min(absmax, _TINY) / torch.tensor(qmax,
                                                          device=x32.device)
    scaled = x32 / scale
    if stochastic:
        if rand_bits is None:
            raise ValueError("stochastic rounding needs rand_bits")
        q = torch.floor(scaled + uniform_from_bits(rand_bits))
    else:
        q = torch.round(scaled)  # half to even
    q = torch.clamp(q, -qmax, qmax).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_ref(q: torch.Tensor, scale: torch.Tensor,
                   dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack 4-bit values (int8 in [-7, 7]) into uint8 nibble pairs, so a q4
    payload is half the q8 wire bytes.  Odd lengths get a zero nibble of
    padding."""
    flat = q.reshape(-1)
    if flat.numel() % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    u = (flat.to(torch.int32) + 8).to(torch.uint8)  # [-7,7] -> [1,15]
    return u[0::2] | (u[1::2] << 4)


def unpack_int4(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4`; ``n`` is the unpacked length."""
    lo = (packed & 0xF).to(torch.int32) - 8
    hi = ((packed >> 4) & 0xF).to(torch.int32) - 8
    out = torch.stack([lo, hi], dim=-1).reshape(-1)[:n]
    return out.to(torch.int8)


def sparsify_ref(x: torch.Tensor, thresh) -> torch.Tensor:
    """Magnitude thresholding: keep entries with |x| >= thresh (thresh
    broadcasts; per-row for 2D inputs), zero the rest."""
    x32 = x.to(torch.float32)
    t = torch.as_tensor(thresh, dtype=torch.float32, device=x32.device)
    return torch.where(x32.abs() >= t, x32, torch.zeros((), device=x32.device))


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 matmul, the PowerSGD projection primitive."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))
