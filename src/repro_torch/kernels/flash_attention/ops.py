"""Public wrappers of the flash-attention kernels, forward and backward.

On CUDA tensors they launch the hand-written Hopper kernels
(``csrc/flash_attn_fwd.cu``; its gradient ``csrc/flash_attn_bwd.cu``) or
raise; on CPU tensors they compute the plain PyTorch versions
(``ref.attention_ref``, which autograd differentiates, and
``ref.attention_bwd_ref``).  The device of the tensors decides: there is
no flag and no fallback.  Where autograd needs the gradient of a CUDA call,
``flash_attention`` goes through ``FlashAttention``, a
``torch.autograd.Function`` whose forward also writes the row statistics
and whose backward is the backward kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)

# devices whose tensors take the plain version: the host, and the meta
# device (shapes only: the dry-run, ``launch.dryrun``)
PLAIN_DEVICES = ("cpu", "meta")
# the plain version, by the name the JAX package's ops module gives it
reference = attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attn_fwd.cu"
BWD_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attn_bwd.cu"

HEAD_DIMS = (32, 64, 80, 128)  # instantiated in the kernels
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' variant for each dtype (csrc/flash_attn_fwd.cu, _bwd.cu)
VARIANTS = {torch.float32: "f32", torch.bfloat16: "wgmma"}
BWD_VARIANTS = {torch.float32: "f32", torch.bfloat16: "wgmma"}
# backward: D = rowsum(dO o O); dK and dV (bf16: per query head); dQ (bf16:
# and the sum of each KV head's partial dK, dV)
LAUNCHES_PER_CALL = 3


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    ll = ctypes.c_longlong
    lib.flash_attn_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                   *[ll] * 12, i, i, i, ctypes.c_float, p, p]
    lib.flash_attn_fwd.restype = i
    lib.flash_attn_error_string.argtypes = [i]
    lib.flash_attn_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load(BWD_SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attn_bwd.argtypes = [*[p] * 10, *[i] * 6, *[ll] * 24, i, i, i,
                                   ctypes.c_float, p]
    lib.flash_attn_bwd.restype = i
    lib.flash_attn_bwd_scratch.argtypes = [i] * 6
    lib.flash_attn_bwd_scratch.restype = ll
    lib.flash_attn_bwd_error_string.argtypes = [i]
    lib.flash_attn_bwd_error_string.restype = ctypes.c_char_p
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


def _launch_fwd(q, k, v, strides, causal, window, stats: bool):
    """K1 on CUDA tensors: (out, row statistics or None)."""
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"no flash_attention for device {device}")
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)  # q's layout where q is dense
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=device) \
        if stats else None
    with _build.on_device(device):
        err = _lib().flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, kv, sq, sk, d, *strides, *kernel_strides(out),
            1 if causal else 0, -1 if window is None else int(window),
            _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(d),
            lse.data_ptr() if stats else None, _build.raw_stream(device))
    if err:  # among them: bf16 operands off 16-byte boundaries
        raise RuntimeError(
            f"flash_attn_fwd launch failed ({VARIANTS[q.dtype]}): CUDA "
            f"error {err} ({_lib().flash_attn_error_string(err).decode()})")
    flash_attention.launches += 1
    flash_attention.last_variant = VARIANTS[q.dtype]
    return out, lse


class FlashAttention(torch.autograd.Function):
    """K1 with its gradient: the forward writes the row statistics beside
    the output and saves (q, k, v, o, statistics); the backward is
    ``flash_attention_bwd``.  On CUDA tensors both are kernels (this is
    what ``flash_attention`` records there); on CPU tensors both are the
    plain versions, which the CPU tests hold against autograd.  Under
    ``torch.utils.checkpoint`` the forward runs again in the backward, and
    the statistics read are those of that run."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention_stats(q, k, v, causal=causal,
                                         window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """Flash attention forward with GQA, causal and sliding-window masks.

    q: (B, H, Sq, D); k, v: (B, KV, Sk, D), f32 or bf16, with H % KV == 0
    and D in ``HEAD_DIMS``; any strides with a unit stride along D and the
    others multiples of 16 bytes (the model passes (B,S,H,D) tensors
    transposed, without a copy); bf16 tensors on the card start on 16-byte
    boundaries.  Returns (B, H, Sq, D) in q's dtype and, where q is dense,
    in q's memory layout.  The causal mask is top-left aligned (qpos >=
    kpos from 0); the window keeps qpos - kpos < window.  Differentiable:
    on CUDA tensors through ``FlashAttention`` where autograd records.
    """
    strides = _check(q, k, v, window)
    if q.device.type in PLAIN_DEVICES:
        return attention_ref(q, k, v, causal=causal, window=window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                    v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window)
    return _launch_fwd(q, k, v, strides, causal, window, stats=False)[0]


flash_attention.launches = 0  # kernel launches, counted only where they happen
flash_attention.last_variant = None  # the variant of the last launch


def flash_attention_stats(q, k, v, *, causal: bool = True, window=None):
    """The forward with its row statistics, not recorded by autograd: (out,
    lse), lse (B, H, Sq) f32 as ``ref.attention_lse_ref`` defines it (+inf
    for a row that keeps no key).  On CUDA tensors one launch of K1."""
    strides = _check(q, k, v, window)
    if q.device.type in PLAIN_DEVICES:
        return (attention_ref(q, k, v, causal=causal, window=window),
                attention_lse_ref(q, k, causal=causal, window=window))
    return _launch_fwd(q, k, v, strides, causal, window, stats=True)


def _taken(t) -> bool:
    """The backward kernel reads ``t`` through its strides: unit stride
    along D, the others and the address 16-byte aligned."""
    size = t.element_size()
    return t.stride(3) == 1 and t.data_ptr() % 16 == 0 and all(
        s * size % 16 == 0 for s in kernel_strides(t))


def flash_attention_bwd(q, k, v, o, lse, dout, *, causal: bool = True,
                        window=None):
    """Gradient of ``flash_attention``: (dq, dk, dv) in the inputs' dtype
    and, where they are dense, in their memory layout, accumulated in f32.

    q, k, v as the forward took them; o its output; lse its row statistics
    (``flash_attention_stats``); dout the output's gradient, copied where
    the kernel does not take its strides.  On CUDA tensors three launches
    (``LAUNCHES_PER_CALL``) and one f32 scratch buffer: D, and for bf16 the
    statistics padded to 64 rows and each query head's partial dK and dV,
    (2, B, H, Sk, D), summed per KV head in a fixed order; on CPU tensors
    ``ref.attention_bwd_ref``."""
    _check(q, k, v, window)
    if o.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and dout {tuple(dout.shape)} "
                         f"must have q's shape {tuple(q.shape)}")
    if o.dtype != q.dtype or dout.dtype != q.dtype:
        raise TypeError(f"o and dout must have q's dtype {q.dtype}; got "
                        f"{o.dtype}, {dout.dtype}")
    b, h, sq, d = q.shape
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 or \
            not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous f32 {(b, h, sq)}; got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if q.device.type in PLAIN_DEVICES:
        return attention_bwd_ref(q, k, v, o, lse, dout, causal=causal,
                                 window=window)
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"no flash_attention_bwd for device {device}")
    q, k, v, o, dout = (t if _taken(t) else t.contiguous()
                        for t in (q, k, v, o, dout))
    kv, sk = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    code = _DTYPE_CODES[q.dtype]
    scratch = torch.empty(_bwd_lib().flash_attn_bwd_scratch(b, h, sq, sk, d,
                                                            code),
                          dtype=torch.float32, device=device)
    strides = [s for t in (q, k, v, o, dout, dq, dk, dv)
               for s in kernel_strides(t)]
    with _build.on_device(device):
        err = _bwd_lib().flash_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, kv, sq, sk, d, *strides,
            1 if causal else 0, -1 if window is None else int(window),
            code, 1.0 / math.sqrt(d), _build.raw_stream(device))
    if err:
        raise RuntimeError(
            f"flash_attn_bwd launch failed ({BWD_VARIANTS[q.dtype]}): CUDA "
            f"error {err} "
            f"({_bwd_lib().flash_attn_bwd_error_string(err).decode()})")
    flash_attention_bwd.launches += LAUNCHES_PER_CALL
    flash_attention_bwd.last_variant = BWD_VARIANTS[q.dtype]
    return dq, dk, dv


flash_attention_bwd.launches = 0  # kernel launches, where they happen
flash_attention_bwd.last_variant = None  # the variant of the last launch
