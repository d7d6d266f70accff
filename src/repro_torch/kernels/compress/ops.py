"""Public wrappers of the compression kernels, and the payload-level ops.

The kernel-level wrappers (``quantize_kernel``, ``dequantize_kernel``,
``sparsify_kernel``, ``matmul_kernel``) launch the hand-written Hopper
kernels of ``csrc/compress.cu`` on CUDA tensors, or raise; on CPU tensors
they compute the plain PyTorch versions of ``ref.py``.  The device of the
tensors decides: there is no flag and no fallback.  Each counts, in
``launches``, every CUDA kernel it launches (the long-row quantize and the
split-K projections launch two), from the entry point's return code.  K2b
and K4 choose their variant from the layout in Python
(``dequantize_variant``, ``matmul_variant``), hand it to the entry point,
which refuses one the operands do not fit, and record it in
``last_variant``.  The launch path is the cheap one of the other kernels:
no device switch where the device is current, the raw stream handle, the
checks the kernels need and no more, workspace sizes cached by shape.

The payload-level ops (``quantize``, ``dequantize``, ``lowrank_project``)
flatten a payload of any shape to rows of ``row_len`` with per-row
scales, the layout of the JAX package's ``repro.kernels.compress.ops``;
``sparsify``, whose one threshold makes it elementwise, passes the
payload as one row; ``wire_codec`` is the encode/decode of the
quantizing collectives, through the kernels.
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

_F32 = torch.float32
_DTYPE_CODES = {_F32: 0, torch.bfloat16: 1}
_BITS_DTYPES = (torch.int32, torch.uint32)  # uint32 bits, 4 bytes each


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.compress_quantize_workspace.argtypes = [ll, ll]
    lib.compress_quantize_workspace.restype = ll
    lib.compress_quantize.argtypes = [p, i, p, p, p, p, ll, ll, i, i, p]
    lib.compress_quantize.restype = i
    lib.compress_dequantize.argtypes = [p, p, p, ll, ll, i, p]
    lib.compress_dequantize.restype = i
    lib.compress_sparsify.argtypes = [p, i, p, p, ll, ll, p]
    lib.compress_sparsify.restype = i
    lib.compress_matmul_workspace.argtypes = [ll, ll, ll, i, i]
    lib.compress_matmul_workspace.restype = ll
    lib.compress_matmul.argtypes = [p, p, p, p, ll, ll, ll, ll, ll, ll, ll, i,
                                    i, p]
    lib.compress_matmul.restype = i
    lib.compress_error_string.argtypes = [i]
    lib.compress_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=256)
def _quantize_workspace(m: int, n: int) -> int:
    return _lib().compress_quantize_workspace(m, n)


@functools.lru_cache(maxsize=256)
def _matmul_workspace(m: int, n: int, k: int, route: int, dtype: int) -> int:
    return _lib().compress_matmul_workspace(m, n, k, route, dtype)


def _failed(wrapper, rc: int, variant: Optional[str] = None
            ) -> RuntimeError:
    """The error of an entry point's return code: the kernels it launched
    sit in the low four bits, a CUDA error above them."""
    err = rc >> 4
    where = f" ({variant})" if variant else ""
    return RuntimeError(
        f"{wrapper.__name__} launch failed{where}: CUDA error {err} "
        f"({_lib().compress_error_string(err).decode()})")


def _rows(x, name: str) -> Tuple[int, int]:
    """(m, n) of a non-empty contiguous matrix, or raise."""
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous (m, n) matrix; got "
                         f"{tuple(x.shape)}, strides {x.stride()}")
    m, n = x.shape
    if not (m and n):
        raise ValueError(f"{name} must be non-empty; got {(m, n)}")
    return m, n


def _col(v, m: int, dev, name: str) -> None:
    """v must be contiguous f32 (m, 1) on ``dev``."""
    if v.shape != (m, 1) or v.dtype != _F32 or not v.is_contiguous():
        raise ValueError(f"{name} must be contiguous f32 of shape ({m}, 1); "
                         f"got {v.dtype} {tuple(v.shape)}")
    if v.device != dev:
        raise ValueError(f"operands on {dev} and {v.device}")


def _cpu(dev) -> bool:
    """True for CPU tensors (the plain version runs); False for CUDA ones
    (the kernel runs); raises for any other device."""
    if dev.type == "cuda":
        return False
    if dev.type == "cpu":
        return True
    raise ValueError(f"no compress kernel for device {dev}")


# --------------------------------------------------------------------------
# kernel-level wrappers (on the card: outputs from torch.empty with integer
# sizes, which parses faster than a tuple; launch counts and errors read
# from the return code)
# --------------------------------------------------------------------------

def quantize_kernel(x: torch.Tensor, rand_bits: Optional[torch.Tensor] = None,
                    *, bits: int = 8, stochastic: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (m, n) f32/bf16 -> (q int8 (m, n), scale f32 (m, 1)), one scale per
    row.  ``rand_bits`` (m, n) int32 (or uint32), the uint32 bits of the
    stochastic rounding, is needed only with ``stochastic=True``."""
    m, n = _rows(x, "x")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be f32 or bf16; got {x.dtype}")
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    dev = x.device
    if stochastic:
        if rand_bits is None:
            raise ValueError("stochastic quantize needs rand_bits")
        if rand_bits.shape != x.shape or rand_bits.dtype not in _BITS_DTYPES \
                or not rand_bits.is_contiguous():
            raise ValueError(f"rand_bits must be contiguous int32 of shape "
                             f"{tuple(x.shape)}; got {rand_bits.dtype} "
                             f"{tuple(rand_bits.shape)}")
        if rand_bits.device != dev:
            raise ValueError(f"operands on {dev} and {rand_bits.device}")
    if _cpu(dev):
        return quantize_ref(x, bits, stochastic, rand_bits, per_row=True)
    _build.refuse_grad("quantize_kernel", "quantize's backward", x)
    q = torch.empty(m, n, dtype=torch.int8, device=dev)
    scale = torch.empty(m, 1, dtype=_F32, device=dev)
    ws = _quantize_workspace(m, n)  # the long-row pass's partial maxima
    work = torch.empty(ws, dtype=_F32, device=dev) if ws else None
    with _build.on_device(dev):
        rc = _lib().compress_quantize(
            x.data_ptr(), _DTYPE_CODES[x.dtype],
            rand_bits.data_ptr() if stochastic else None, q.data_ptr(),
            scale.data_ptr(), work.data_ptr() if ws else None, m, n, bits,
            int(stochastic), _build.raw_stream(dev))
    quantize_kernel.launches += rc & 15
    if rc >> 4:
        raise _failed(quantize_kernel, rc)
    return q, scale


# K2b's variants: values a thread takes at a time (csrc/compress.cu)
_DQ_CODES = {"vec16": 0, "vec4": 1, "scalar": 2}


def dequantize_variant(n: int, q_ptr: int) -> str:
    """Which variant K2b takes for rows of ``n`` int8 starting at address
    ``q_ptr`` (the f32 output, allocated by the wrapper, is always 16-byte
    aligned): "vec16" (a 16-byte load and four float4 stores a thread)
    where n % 16 == 0 and q is 16-byte aligned, else "vec4" where n % 4 ==
    0 and q is 4-byte aligned, else "scalar"."""
    if n % 16 == 0 and q_ptr % 16 == 0:
        return "vec16"
    if n % 4 == 0 and q_ptr % 4 == 0:
        return "vec4"
    return "scalar"


def dequantize_kernel(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(q int8 (m, n), scale f32 (m, 1)) -> f32 (m, n)."""
    if q.dtype != torch.int8:
        raise TypeError(f"q must be int8; got {q.dtype}")
    m, n = _rows(q, "q")
    dev = q.device
    _col(scale, m, dev, "scale")
    if _cpu(dev):
        return dequantize_ref(q, scale)
    _build.refuse_grad("dequantize_kernel", "dequantize's backward", scale)
    qp = q.data_ptr()
    variant = dequantize_variant(n, qp)
    out = torch.empty(m, n, dtype=_F32, device=dev)
    with _build.on_device(dev):
        rc = _lib().compress_dequantize(qp, scale.data_ptr(), out.data_ptr(),
                                        m, n, _DQ_CODES[variant],
                                        _build.raw_stream(dev))
    dequantize_kernel.launches += rc & 15
    if rc >> 4:
        raise _failed(dequantize_kernel, rc, variant)
    dequantize_kernel.last_variant = variant
    return out


def sparsify_kernel(x: torch.Tensor, thresh: torch.Tensor) -> torch.Tensor:
    """x (m, n) f32/bf16, thresh f32 (m, 1) -> f32 (m, n), entries below
    their row's magnitude threshold zeroed."""
    m, n = _rows(x, "x")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be f32 or bf16; got {x.dtype}")
    dev = x.device
    _col(thresh, m, dev, "thresh")
    if _cpu(dev):
        return sparsify_ref(x, thresh)
    _build.refuse_grad("sparsify_kernel", "sparsify's backward", x, thresh)
    out = torch.empty(m, n, dtype=_F32, device=dev)
    with _build.on_device(dev):
        rc = _lib().compress_sparsify(x.data_ptr(), _DTYPE_CODES[x.dtype],
                                      thresh.data_ptr(), out.data_ptr(), m, n,
                                      _build.raw_stream(dev))
    sparsify_kernel.launches += rc & 15
    if rc >> 4:
        raise _failed(sparsify_kernel, rc)
    return out


# K4's routes (csrc/compress.cu, enum Route)
_ROUTE_CODES = {"rows": 0, "cols": 1, "smallk": 2, "tiled": 3,
                "cols_bulk": 4}
SMALL = 8  # n (or k) of the skinny products
# the streamed M^T @ P pays ~10 us to fill and drain its pipeline: on the
# card it is slower than "cols" at 34 MB of M and faster at 68 MB
# (tools/compress_route_bench.py); a bulk copy of a row under 512 bytes
# moves too little to pay for itself
BULK_MIN_BYTES = 48 * 2 ** 20
BULK_MIN_ROW_BYTES = 512


def matmul_variant(a: torch.Tensor, b: torch.Tensor) -> str:
    """Which route K4 takes for a (m, k) x b (k, n), from shape, strides
    and alignment: with n <= 8, "rows" where a has unit stride along k (M @
    Q0), else, where a has unit stride along m (M^T @ P on the view),
    "cols_bulk" (streamed by bulk copies) for 16-byte aligned rows of at
    least ``BULK_MIN_ROW_BYTES`` and at least ``BULK_MIN_BYTES`` of M (the
    embedding gradient), else "cols"; "smallk" for k <= 8 (the decode);
    else "tiled"."""
    (m, k), n = a.shape, b.shape[1]
    sam, sak = a.stride()
    if n <= SMALL:
        if sak == 1:
            return "rows"
        if sam == 1:
            size = a.element_size()
            if a.data_ptr() % 16 == 0 and sak * size % 16 == 0 and \
                    m * size >= BULK_MIN_ROW_BYTES and \
                    m * k * size >= BULK_MIN_BYTES:
                return "cols_bulk"
            return "cols"
    if k <= SMALL:
        return "smallk"
    return "tiled"


def matmul_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) x (k, n) -> f32 (m, n), contiguous, accumulated in f32 (never
    TF32).  a and b are both f32 or both bf16 and may be any strided views
    (``M.T`` is read in place, not copied)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"want a (m, k), b (k, n); got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    (m, k), n = a.shape, b.shape[1]
    if not (m and k and n):
        raise ValueError(f"empty operand: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}")
    dtype = a.dtype
    if dtype not in _DTYPE_CODES or b.dtype != dtype:
        raise TypeError(f"want a and b both f32 or both bf16; got {a.dtype}, "
                        f"{b.dtype}")
    dev = a.device
    if b.device != dev:
        raise ValueError(f"operands on {dev} and {b.device}")
    if _cpu(dev):
        return matmul_ref(a, b)
    _build.refuse_grad("matmul_kernel", "the PowerSGD matmul's backward", a,
                       b)
    variant = matmul_variant(a, b)
    route, code = _ROUTE_CODES[variant], _DTYPE_CODES[dtype]
    out = torch.empty(m, n, dtype=_F32, device=dev)
    ws = _matmul_workspace(m, n, k, route, code)
    work = torch.empty(ws, dtype=_F32, device=dev) if ws else None
    sam, sak = a.stride()
    sbk, sbn = b.stride()
    with _build.on_device(dev):
        rc = _lib().compress_matmul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            work.data_ptr() if ws else None, m, n, k, sam, sak, sbk, sbn,
            code, route, _build.raw_stream(dev))
    matmul_kernel.launches += rc & 15
    if rc >> 4:
        raise _failed(matmul_kernel, rc, variant)
    matmul_kernel.last_variant = variant
    return out


# kernel launches, counted only where they happen
quantize_kernel.launches = 0
dequantize_kernel.launches = 0
sparsify_kernel.launches = 0
matmul_kernel.launches = 0
# the variant of the last launch (None before the first)
dequantize_kernel.last_variant = None
matmul_kernel.last_variant = None


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
    """Zero entries of ``x`` below the (scalar) magnitude threshold.

    With one threshold for every value the op is elementwise, so ``x`` goes
    to the kernel as one row (a view where ``x`` is contiguous) with a
    (1, 1) threshold: no zero-padded copy, no threshold per row.  The
    result equals the JAX package's rows of ``row_len`` bit for bit;
    ``row_len`` is kept for its signature and does not change it."""
    t = torch.full((1, 1), float(thresh), dtype=torch.float32,
                   device=x.device)
    return sparsify_kernel(x.reshape(1, -1), t).reshape(x.shape)


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
