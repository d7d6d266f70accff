"""Public wrapper of the flash-attention forward kernel.

On CUDA tensors it launches the hand-written Hopper kernel
(``csrc/flash_attn_fwd.cu``) or raises; on CPU tensors it computes the plain
PyTorch version (``ref.attention_ref``).  The device of the tensors decides:
there is no flag and no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attn_fwd.cu"

HEAD_DIMS = (32, 64, 80, 128)  # instantiated in the kernel
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attn_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i,
                                   ctypes.c_float, p]
    lib.flash_attn_fwd.restype = i
    lib.flash_attn_error_string.argtypes = [i]
    lib.flash_attn_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,H,Sq,D), k = v (B,KV,Sk,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[2] < 1:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if h % k.shape[1]:
        raise ValueError(f"H={h} is not a multiple of KV={k.shape[1]}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported; the kernel takes "
                         f"{HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"want f32 or bf16 for all of q, k, v; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous in the (B,H,S,D) layout")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """Flash attention forward with GQA, causal and sliding-window masks.

    q: (B, H, Sq, D); k, v: (B, KV, Sk, D), contiguous, f32 or bf16, with
    H % KV == 0 and D in ``HEAD_DIMS``.  Returns (B, H, Sq, D) in q's dtype.
    The causal mask is top-left aligned (qpos >= kpos from 0); the window
    keeps qpos - kpos < window.
    """
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, kv, sq, sk, d, int(bool(causal)),
            -1 if window is None else int(window), _DTYPE_CODES[q.dtype],
            1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(
            f"flash_attn_fwd launch failed: CUDA error {err} "
            f"({lib.flash_attn_error_string(err).decode()})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0  # kernel launches, counted only where they happen
