"""Public wrapper of the grouped expert GEMM kernel.

On CUDA tensors it launches the hand-written Hopper kernel
(``csrc/moe_gmm.cu``) or raises; on CPU tensors it computes the plain
PyTorch version (``ref.moe_gmm_ref``).  The device of the tensors decides:
there is no flag and no fallback.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "moe_gmm.cu"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANT_CODES = {"f32": 0, "mma_sync": 0, "wgmma": 1, "wgmma_swap": 1}
WGMMA_MIN_C = 64  # below, a 64-row tile would be mostly padding: swap-AB


def gmm_variant(dtype, c: int, f: int, x_strides, x_ptr: int,
                w_ptr: int) -> str:
    """Which of the kernel's variants a call takes (csrc/moe_gmm.cu):
    "f32" (CUDA cores) for f32; for bf16 where TMA can address the operands
    (16-byte-aligned bases and x row and expert strides, f a multiple of 8)
    "wgmma" (128 x 256 tiles) from ``WGMMA_MIN_C`` tokens on and
    "wgmma_swap" (swap-AB, decode's few slots) below; else "mma_sync"."""
    if dtype == torch.float32:
        return "f32"
    sxe, sxc = x_strides[0], x_strides[1]
    if x_ptr % 16 or w_ptr % 16 or f % 8 or sxc % 8 or sxe % 8:
        return "mma_sync"
    return "wgmma" if c >= WGMMA_MIN_C else "wgmma_swap"


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.moe_gmm.argtypes = [p, p, p, i, i, i, i, ll, ll, i, i, p]
    lib.moe_gmm.restype = i
    lib.moe_gmm_error_string.argtypes = [i]
    lib.moe_gmm_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, w) -> None:
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or \
            x.shape[2] != w.shape[1]:
        raise ValueError(f"want x (E,C,d), w (E,d,f); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if min(x.shape) < 1 or w.shape[2] < 1:
        raise ValueError(f"empty operand: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"want x and w both f32 or both bf16; got {x.dtype}, "
                        f"{w.dtype}")
    # x may be the tokens expanded over experts (expert stride 0) or any
    # row-strided view with a unit stride along d; w is contiguous
    if x.stride(2) != 1:
        raise ValueError(f"x must have a unit stride along d; strides "
                         f"{x.stride()}")
    if not w.is_contiguous():
        raise ValueError("w must be contiguous in the (E,d,f) layout")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")


def moe_gmm(x, w):
    """Grouped expert matmul: (E,C,d) x (E,d,f) -> (E,C,f) contiguous in x's
    dtype, accumulated in f32 (full f32 for f32 inputs, never TF32).

    x: unit stride along d; its expert stride may be 0 (every expert on the
    same tokens, as ``moe_dense`` computes) and C, d, f need not divide any
    tile."""
    _check(x, w)
    if x.device.type == "cpu":
        return moe_gmm_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no moe_gmm for device {x.device}")
    _build.refuse_grad("moe_gmm", "the grouped GEMM's backward (dx, dw; "
                       "ROADMAP item 4c)", x, w)
    e, c, d = x.shape
    f = w.shape[2]
    variant = gmm_variant(x.dtype, c, f, x.stride(), x.data_ptr(),
                          w.data_ptr())
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    lib = _lib()
    with _build.on_device(x.device):
        err = lib.moe_gmm(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d,
                          f, x.stride(0), x.stride(1), _DTYPE_CODES[x.dtype],
                          _VARIANT_CODES[variant],
                          _build.raw_stream(x.device))
    if err:
        raise RuntimeError(f"moe_gmm launch failed ({variant}): CUDA error "
                           f"{err} ({lib.moe_gmm_error_string(err).decode()})")
    moe_gmm.launches += 1
    moe_gmm.last_variant = variant
    return out


moe_gmm.launches = 0  # kernel launches, counted only where they happen
moe_gmm.last_variant = None  # the variant of the last launch
