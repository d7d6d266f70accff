"""Public wrapper of the SSD chunked-scan kernel.

On CUDA tensors it launches the hand-written Hopper kernel
(``csrc/ssd_scan_fwd.cu``: three launches, chunk states, the carry, the
chunks' outputs, through an f32 workspace allocated here) or raises; on
CPU tensors it computes the plain PyTorch version (``ref.ssd_scan_ref``).
The device of the tensors decides: there is no flag and no fallback.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import check_chunk, ssd_scan_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan_fwd.cu"

HEAD_DIMS = (32, 64, 128)      # P, instantiated in the kernel
STATE_DIMS = (16, 32, 64, 128)  # N
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
LAUNCHES_PER_CALL = 3  # chunk states, the carry, the outputs


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_workspace.argtypes = [i, i, i, i, i]
    lib.ssd_scan_workspace.restype = ll
    lib.ssd_scan_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                 ll, ll, ll, ll, ll, ll, i, p]
    lib.ssd_scan_fwd.restype = i
    lib.ssd_scan_error_string.argtypes = [i]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=256)
def _workspace(b: int, h: int, l: int, p: int, n: int) -> int:
    return _lib().ssd_scan_workspace(b, h, l, p, n)


def _check(x, dt, a, b, c) -> None:
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or b.dim() != 3 or \
            c.shape != b.shape:
        raise ValueError(f"want x (B,H,L,P), dt (B,H,L), a (H,), b = c "
                         f"(B,L,N); got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    bsz, h, l, p = x.shape
    if tuple(dt.shape) != (bsz, h, l) or a.shape[0] != h or \
            b.shape[:2] != (bsz, l):
        raise ValueError(f"shapes do not agree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}")
    if p not in HEAD_DIMS or b.shape[2] not in STATE_DIMS:
        raise ValueError(f"(P, N) = ({p}, {b.shape[2]}) not supported; the "
                         f"kernel takes P in {HEAD_DIMS}, N in {STATE_DIMS}")
    if x.dtype not in _DTYPE_CODES or b.dtype != x.dtype or \
            c.dtype != x.dtype:
        raise TypeError(f"want x, b, c all f32 or all bf16; got {x.dtype}, "
                        f"{b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"want f32 dt and a; got {dt.dtype}, {a.dtype}")
    # x and dt may be strided views (the model passes its (B,L,H,P) and
    # (B,L,H) tensors permuted, without a copy); b, c, a must be contiguous
    if x.stride(3) != 1:
        raise ValueError(f"x must have a unit stride along P; strides "
                         f"{x.stride()}")
    if not (b.is_contiguous() and c.is_contiguous() and a.is_contiguous()):
        raise ValueError("b, c and a must be contiguous")
    if not (x.device == dt.device == a.device == b.device == c.device):
        raise ValueError("x, dt, a, b, c on different devices")


def ssd_scan(x, dt, a, b, c, *, chunk: int = 128):
    """Chunked SSD scan, forward.

    x: (B,H,L,P) f32 or bf16 (unit stride along P, any other strides);
    dt: (B,H,L) f32 (post-softplus, any strides); a: (H,) f32 decay rates;
    b, c: (B,L,N) contiguous, in x's dtype, shared by all heads.  Returns
    y (B,H,L,P) contiguous in x's dtype, computed in f32.  L must be a
    multiple of min(chunk, L), as in the JAX package; the function does not
    depend on the chunk, so the kernel tiles L its own way."""
    _check(x, dt, a, b, c)
    check_chunk(x.shape[2], chunk)
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, a, b, c, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"no ssd_scan for device {x.device}")
    _build.refuse_grad("ssd_scan", "the SSD scan's backward (dx, ddt, da, "
                       "db, dc)", x, dt, a, b, c)
    bsz, h, l, p = x.shape
    n = b.shape[2]
    dev = x.device
    y = torch.empty(bsz, h, l, p, dtype=x.dtype, device=dev)
    work = torch.empty(_workspace(bsz, h, l, p, n), dtype=torch.float32,
                       device=dev)
    lib = _lib()
    with _build.on_device(dev):
        rc = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), work.data_ptr(), bsz, h, l, p, n,
            x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2), _DTYPE_CODES[x.dtype],
            _build.raw_stream(dev))
    ssd_scan.launches += rc & 15
    if rc >> 4:
        raise RuntimeError(
            f"ssd_scan_fwd launch failed: CUDA error {rc >> 4} "
            f"({lib.ssd_scan_error_string(rc >> 4).decode()})")
    return y


ssd_scan.launches = 0  # kernel launches, counted only where they happen
