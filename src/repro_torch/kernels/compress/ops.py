"""Public wrappers of the compression kernels, and the payload-level ops.

The kernel-level wrappers (``quantize_kernel``, ``dequantize_kernel``,
``sparsify_kernel``, ``matmul_kernel``) launch the hand-written Hopper
kernels of ``csrc/compress.cu`` on CUDA tensors, or raise; on CPU tensors
they compute the plain PyTorch versions of ``ref.py``.  The device of the
tensors decides: there is no flag and no fallback.  Each counts, in
``launches``, every CUDA kernel it launches (the long-row quantize and the
split-K projection launch two).

The payload-level ops (``quantize``, ``dequantize``, ``sparsify``,
``lowrank_project``) flatten a payload of any shape to rows of
``row_len`` with per-row scales or thresholds, the layout of the JAX
package's ``repro.kernels.compress.ops``; ``wire_codec`` is the
encode/decode of the quantizing collectives, through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.compress.ref import (dequantize_ref, matmul_ref,
                                              pack_int4, quantize_ref,
                                              random_bits, sparsify_ref,
                                              unpack_int4)

SOURCE = Path(__file__).resolve().parent / "csrc" / "compress.cu"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BITS_DTYPES = (torch.int32, torch.uint32)  # uint32 bits, 4 bytes each


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ip = ctypes.POINTER(ctypes.c_int)
    lib.compress_quantize_workspace.argtypes = [ll, ll]
    lib.compress_quantize_workspace.restype = ll
    lib.compress_quantize.argtypes = [p, i, p, p, p, p, ll, ll, i, i, ip, p]
    lib.compress_quantize.restype = i
    lib.compress_dequantize.argtypes = [p, p, p, ll, ll, ip, p]
    lib.compress_dequantize.restype = i
    lib.compress_sparsify.argtypes = [p, i, p, p, ll, ll, ip, p]
    lib.compress_sparsify.restype = i
    lib.compress_matmul_workspace.argtypes = [ll, ll, ll, ll, ll]
    lib.compress_matmul_workspace.restype = ll
    lib.compress_matmul.argtypes = [p, p, p, p, ll, ll, ll, ll, ll, ll, ll, i,
                                    ip, p]
    lib.compress_matmul.restype = i
    lib.compress_error_string.argtypes = [i]
    lib.compress_error_string.restype = ctypes.c_char_p
    return lib


def _launch(wrapper, fn, *args) -> None:
    """Call one C entry point on the current stream; raise on a CUDA error,
    else add the kernels it launched to ``wrapper.launches``."""
    n = ctypes.c_int(0)
    err = fn(*args, ctypes.byref(n), torch.cuda.current_stream().cuda_stream)
    wrapper.launches += n.value
    if err:
        raise RuntimeError(
            f"{wrapper.__name__} launch failed: CUDA error {err} "
            f"({_lib().compress_error_string(err).decode()})")


def _device_of(*tensors) -> torch.device:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"operands on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no compress kernel for device {dev}")
    return dev


def _check_rows(x, name: str) -> None:
    if x.dim() != 2 or min(x.shape) < 1:
        raise ValueError(f"{name} must be a non-empty (m, n) matrix; got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_col(v, m: int, name: str) -> None:
    if tuple(v.shape) != (m, 1) or v.dtype != torch.float32 or \
            not v.is_contiguous():
        raise ValueError(f"{name} must be contiguous f32 of shape ({m}, 1); "
                         f"got {v.dtype} {tuple(v.shape)}")


# --------------------------------------------------------------------------
# kernel-level wrappers
# --------------------------------------------------------------------------

def quantize_kernel(x: torch.Tensor, rand_bits: Optional[torch.Tensor] = None,
                    *, bits: int = 8, stochastic: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (m, n) f32/bf16 -> (q int8 (m, n), scale f32 (m, 1)), one scale per
    row.  ``rand_bits`` (m, n) int32 (or uint32), the uint32 bits of the
    stochastic rounding, is needed only with ``stochastic=True``."""
    _check_rows(x, "x")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be f32 or bf16; got {x.dtype}")
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if stochastic:
        if rand_bits is None:
            raise ValueError("stochastic quantize needs rand_bits")
        if rand_bits.shape != x.shape or rand_bits.dtype not in _BITS_DTYPES \
                or not rand_bits.is_contiguous():
            raise ValueError(f"rand_bits must be contiguous int32 of shape "
                             f"{tuple(x.shape)}; got {rand_bits.dtype} "
                             f"{tuple(rand_bits.shape)}")
        dev = _device_of(x, rand_bits)
    else:
        dev = _device_of(x)
    if dev.type == "cpu":
        return quantize_ref(x, bits, stochastic, rand_bits, per_row=True)
    m, n = x.shape
    q = torch.empty((m, n), dtype=torch.int8, device=dev)
    scale = torch.empty((m, 1), dtype=torch.float32, device=dev)
    lib = _lib()
    work = torch.empty((lib.compress_quantize_workspace(m, n),),
                       dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch(quantize_kernel, lib.compress_quantize, x.data_ptr(),
                _DTYPE_CODES[x.dtype],
                rand_bits.data_ptr() if stochastic else None, q.data_ptr(),
                scale.data_ptr(), work.data_ptr(), m, n, bits,
                int(stochastic))
    return q, scale


def dequantize_kernel(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(q int8 (m, n), scale f32 (m, 1)) -> f32 (m, n)."""
    _check_rows(q, "q")
    if q.dtype != torch.int8:
        raise TypeError(f"q must be int8; got {q.dtype}")
    _check_col(scale, q.shape[0], "scale")
    dev = _device_of(q, scale)
    if dev.type == "cpu":
        return dequantize_ref(q, scale)
    m, n = q.shape
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch(dequantize_kernel, _lib().compress_dequantize, q.data_ptr(),
                scale.data_ptr(), out.data_ptr(), m, n)
    return out


def sparsify_kernel(x: torch.Tensor, thresh: torch.Tensor) -> torch.Tensor:
    """x (m, n) f32/bf16, thresh f32 (m, 1) -> f32 (m, n), entries below
    their row's magnitude threshold zeroed."""
    _check_rows(x, "x")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be f32 or bf16; got {x.dtype}")
    _check_col(thresh, x.shape[0], "thresh")
    dev = _device_of(x, thresh)
    if dev.type == "cpu":
        return sparsify_ref(x, thresh)
    m, n = x.shape
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch(sparsify_kernel, _lib().compress_sparsify, x.data_ptr(),
                _DTYPE_CODES[x.dtype], thresh.data_ptr(), out.data_ptr(), m,
                n)
    return out


def matmul_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) x (k, n) -> f32 (m, n), contiguous, accumulated in f32 (never
    TF32).  a and b are both f32 or both bf16 and may be any strided views
    (``M.T`` is read in place, not copied)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"want a (m, k), b (k, n); got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if min(a.shape) < 1 or b.shape[1] < 1:
        raise ValueError(f"empty operand: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}")
    if a.dtype not in _DTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(f"want a and b both f32 or both bf16; got {a.dtype}, "
                        f"{b.dtype}")
    dev = _device_of(a, b)
    if dev.type == "cpu":
        return matmul_ref(a, b)
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    lib = _lib()
    work = torch.empty((lib.compress_matmul_workspace(m, n, k, a.stride(0),
                                                      a.stride(1)),),
                       dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch(matmul_kernel, lib.compress_matmul, a.data_ptr(),
                b.data_ptr(), out.data_ptr(), work.data_ptr(), m, n, k,
                a.stride(0), a.stride(1), b.stride(0), b.stride(1),
                _DTYPE_CODES[a.dtype])
    return out


# kernel launches, counted only where they happen
quantize_kernel.launches = 0
dequantize_kernel.launches = 0
sparsify_kernel.launches = 0
matmul_kernel.launches = 0


# --------------------------------------------------------------------------
# payload-level ops (layout of repro.kernels.compress.ops)
# --------------------------------------------------------------------------

def _as_rows(x: torch.Tensor, row_len: int = 256
             ) -> Tuple[torch.Tensor, int]:
    """Flatten + zero-pad to (rows, row_len); returns (rows2d, orig_size)."""
    flat = x.reshape(-1)
    n = flat.numel()
    pad = (-n) % row_len
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, row_len), n


def quantize(x: torch.Tensor, *, bits: int = 8, stochastic: bool = False,
             generator: Optional[torch.Generator] = None, row_len: int = 256
             ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[int, ...]]:
    """Quantize any-shape ``x`` -> (q int8 (rows, row_len), scales (rows, 1),
    original shape).  Stochastic rounding draws its bits from
    ``generator``, on ``x``'s device."""
    rows, _ = _as_rows(x, row_len)
    rand = None
    if stochastic:
        if generator is None:
            raise ValueError("stochastic rounding needs a generator")
        rand = random_bits(rows.shape, generator, rows.device)
    q, scales = quantize_kernel(rows, rand, bits=bits, stochastic=stochastic)
    return q, scales, tuple(x.shape)


def dequantize(q: torch.Tensor, scales: torch.Tensor, shape,
               dtype=torch.float32) -> torch.Tensor:
    out = dequantize_kernel(q, scales)
    n = math.prod(shape)
    return out.reshape(-1)[:n].reshape(shape).to(dtype)


def sparsify(x: torch.Tensor, thresh, *, row_len: int = 256) -> torch.Tensor:
    """Zero entries of ``x`` below the (scalar) magnitude threshold."""
    rows, n = _as_rows(x, row_len)
    t = torch.full((rows.shape[0], 1), float(thresh), dtype=torch.float32,
                   device=rows.device)
    out = sparsify_kernel(rows, t)
    return out.reshape(-1)[:n].reshape(x.shape)


def lowrank_project(m: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """PowerSGD projection P = M @ Q (and, with ``M.T``, Q' = M^T @ P) in
    f32."""
    return matmul_kernel(m, q)


def wire_codec(bits: int, length: int):
    """(encode, decode) of the quantizing collectives, through the kernels
    (one row: a per-chunk scale).  Encode maps a length-``length`` chunk to
    (int payload, 1-element f32 scale), nibble-packed for ``bits=4``;
    decode inverts it.  Shared by the compressed ring and the synthesized
    move-list interpreter in ``repro_torch.ccl.primitives``."""

    def encode(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        q, scale = quantize_kernel(v.reshape(1, -1), bits=bits)
        q = q.reshape(-1)
        if bits == 4:
            q = pack_int4(q)
        return q, scale.reshape(1)

    def decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        if bits == 4:
            q = unpack_int4(q, length)
        return dequantize_kernel(q.reshape(1, -1), scale.reshape(1, 1)
                                 ).reshape(-1)

    return encode, decode


reference = {
    "quantize": quantize_ref,
    "dequantize": dequantize_ref,
    "sparsify": sparsify_ref,
    "matmul": matmul_ref,
}
