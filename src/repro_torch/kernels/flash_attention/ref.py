"""Plain PyTorch versions of the flash-attention kernels.

``attention_ref`` is the port of ``repro.kernels.flash_attention.ref
.attention_ref``: the CPU path of the forward wrapper (autograd
differentiates it), and what the forward kernel is held against on the
card.  ``attention_lse_ref`` and ``attention_bwd_ref`` are the row
statistics and the gradient, step by step as the backward kernel computes
them; the JAX package has no backward kernel to port.  f64 inputs are
computed in f64 (the references of the tests), all others in f32.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _acc_dtype(x) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _mask(sq: int, sk: int, causal: bool, window, device) -> torch.Tensor:
    """(Sq, Sk) True where query qpos keeps key kpos: top-left causal
    (qpos >= kpos, both from 0) and the window qpos - kpos < window."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    return mask


def _scores(q, k, causal: bool, window):
    """Scaled scores (B, KV, G, Sq, Sk) with NEG_INF where masked, and the
    mask."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    acc = _acc_dtype(q)
    qg = q.reshape(b, kv, h // kv, sq, d)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg.to(acc),
                     k.to(acc)) / math.sqrt(float(d))
    mask = _mask(sq, sk, causal, window, q.device)
    # finite NEG_INF, never -inf: a fully masked row averages its keys
    # instead of turning into NaN, as in the JAX reference
    return torch.where(mask, s, torch.full_like(s, NEG_INF)), mask


def attention_ref(q, k, v, *, causal: bool = True, window=None):
    """q: (B, H, Sq, D); k, v: (B, KV, Sk, D). Materialized softmax.

    Head h reads KV head h // (H/KV).  The causal mask is top-left aligned:
    qpos >= kpos with both counted from 0, also when Sq != Sk.
    """
    b, h, sq, d = q.shape
    s, _ = _scores(q, k, causal, window)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p.to(v.dtype), v)
    return o.reshape(b, h, sq, d).to(q.dtype)


def attention_lse_ref(q, k, *, causal: bool = True, window=None):
    """The forward kernel's row statistics: (B, H, Sq) f32 (f64 for f64
    inputs), the natural-log log-sum-exp of each query row's scaled,
    masked scores; +inf for a row that keeps no key (a window with Sq >
    Sk), which the backward reads as "P = 1/Sk on every key, dS = 0"."""
    b, h, sq, _ = q.shape
    s, mask = _scores(q, k, causal, window)
    lse = torch.logsumexp(s, dim=-1)
    keyless = ~mask.any(dim=-1)  # (Sq,)
    lse = torch.where(keyless, torch.full_like(lse, math.inf), lse)
    return lse.reshape(b, h, sq)


def attention_bwd_ref(q, k, v, o, lse, dout, *, causal: bool = True,
                      window=None):
    """Gradient of ``attention_ref`` as the backward kernel computes it:
    (dq, dk, dv) in the inputs' dtype.

    P = exp(S * scale - L) from the row statistics ``lse``
    (``attention_lse_ref``), P = 1/Sk on a row that keeps no key;
    D = rowsum(dO o O); dS = P o (dP - D) on the kept pairs, 0 elsewhere;
    dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K, the G heads of a KV
    head summed.  Like the kernel, P and dS are rounded to the inputs'
    dtype before their products, which accumulate in f32 (f64 for f64)."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    acc, lo = _acc_dtype(q), q.dtype
    scale = 1.0 / math.sqrt(float(d))
    s, mask = _scores(q, k, causal, window)
    L = lse.reshape(b, kv, g, sq, 1).to(acc)
    keyless = torch.isinf(L)
    p = torch.exp(s - torch.where(keyless, torch.zeros_like(L), L))
    p = torch.where(mask, p, torch.zeros_like(p))
    p = torch.where(keyless, torch.full_like(p, 1.0 / sk), p)
    dog = dout.reshape(b, kv, g, sq, d).to(acc)
    delta = (dog * o.reshape(b, kv, g, sq, d).to(acc)).sum(-1, keepdim=True)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dog, v.to(acc))
    ds = torch.where(mask & ~keyless, p * (dp - delta), torch.zeros_like(p))
    p, ds = p.to(lo).to(acc), ds.to(lo).to(acc)
    qg = q.reshape(b, kv, g, sq, d).to(acc)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dog)
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qg) * scale
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, k.to(acc)) * scale
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
