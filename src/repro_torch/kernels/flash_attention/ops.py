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
# the kernel's variant for each dtype (csrc/flash_attn_fwd.cu)
VARIANTS = {torch.float32: "f32", torch.bfloat16: "wgmma"}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    ll = ctypes.c_longlong
    lib.flash_attn_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                   *[ll] * 12, i, i, i, ctypes.c_float, p]
    lib.flash_attn_fwd.restype = i
    lib.flash_attn_error_string.argtypes = [i]
    lib.flash_attn_error_string.restype = ctypes.c_char_p
    return lib


_ALIGN = {torch.float32: 4, torch.bfloat16: 8}  # elements in 16 bytes


def kernel_strides(t) -> tuple:
    """The (B, heads, S) strides of a (B, heads, S, D) tensor as the kernel
    takes them, in elements; a dimension of size 1 is never stepped, so it
    gets the span of the others, which keeps their alignment."""
    st, n = t.stride(), t.shape
    if n[0] > 1 and n[1] > 1 and n[2] > 1:  # the common case, kept cheap
        return st[:3]
    span = max(a * b for a, b in zip(st, n) if b > 1)
    return tuple(a if b > 1 else span for a, b in zip(st[:3], n[:3]))


def _check(q, k, v, window) -> tuple:
    """Raises on what the kernel does not take; returns the kernel strides
    of q, k and v, nine numbers (kept cheap: it runs before every
    launch)."""
    qs, ks = q.shape, k.shape
    if len(qs) != 4 or len(ks) != 4 or ks != v.shape:
        raise ValueError(f"want q (B,H,Sq,D), k = v (B,KV,Sk,D); got "
                         f"{tuple(qs)}, {tuple(ks)}, {tuple(v.shape)}")
    b, h, _, d = qs
    if ks[0] != b or ks[3] != d or ks[2] < 1:
        raise ValueError(f"k/v {tuple(ks)} do not match q {tuple(qs)}")
    if h % ks[1]:
        raise ValueError(f"H={h} is not a multiple of KV={ks[1]}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported; the kernel takes "
                         f"{HEAD_DIMS}")
    dtype = q.dtype
    if dtype not in _DTYPE_CODES or k.dtype != dtype or v.dtype != dtype:
        raise TypeError(f"want f32 or bf16 for all of q, k, v; got "
                        f"{dtype}, {k.dtype}, {v.dtype}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError(f"q, k, v must have a unit stride along D; "
                         f"strides {q.stride()}, {k.stride()}, {v.stride()}")
    strides = (*kernel_strides(q), *kernel_strides(k), *kernel_strides(v))
    s0, s1, s2, s3, s4, s5, s6, s7, s8 = strides  # 16-byte multiples: OR
    if (s0 | s1 | s2 | s3 | s4 | s5 | s6 | s7 | s8) % _ALIGN[dtype]:
        raise ValueError(f"strides {q.stride()}, {k.stride()}, "
                         f"{v.stride()} are not multiples of 16 bytes")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    return strides


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """Flash attention forward with GQA, causal and sliding-window masks.

    q: (B, H, Sq, D); k, v: (B, KV, Sk, D), f32 or bf16, with H % KV == 0
    and D in ``HEAD_DIMS``; any strides with a unit stride along D and the
    others multiples of 16 bytes (the model passes (B,S,H,D) tensors
    transposed, without a copy); bf16 tensors on the card start on 16-byte
    boundaries.  Returns (B, H, Sq, D) in q's dtype and, where q is dense,
    in q's memory layout.  The causal mask is top-left aligned (qpos >=
    kpos from 0); the window keeps qpos - kpos < window.
    """
    strides = _check(q, k, v, window)
    device = q.device
    if device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if device.type != "cuda":
        raise ValueError(f"no flash_attention for device {device}")
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)  # q's layout where q is dense
    with _build.on_device(device):
        err = _lib().flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, kv, sq, sk, d, *strides, *kernel_strides(out),
            1 if causal else 0, -1 if window is None else int(window),
            _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(d),
            _build.raw_stream(device))
    if err:  # among them: bf16 operands off 16-byte boundaries
        raise RuntimeError(
            f"flash_attn_fwd launch failed ({VARIANTS[q.dtype]}): CUDA "
            f"error {err} ({_lib().flash_attn_error_string(err).decode()})")
    flash_attention.launches += 1
    flash_attention.last_variant = VARIANTS[q.dtype]
    return out


flash_attention.launches = 0  # kernel launches, counted only where they happen
flash_attention.last_variant = None  # the variant of the last launch
