"""Plain PyTorch version of the flash-attention kernel.

Port of ``repro.kernels.flash_attention.ref.attention_ref``: the CPU path of
the wrapper, and what the CUDA kernel is held against on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window=None):
    """q: (B, H, Sq, D); k, v: (B, KV, Sk, D). Materialized softmax.

    Head h reads KV head h // (H/KV).  The causal mask is top-left aligned:
    qpos >= kpos with both counted from 0, also when Sq != Sk.
    """
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, kv, g, sq, d)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg.float(),
                     k.float()) / math.sqrt(float(d))
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    # finite NEG_INF, never -inf: a fully masked row averages its keys
    # instead of turning into NaN, as in the JAX reference
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p.to(v.dtype), v)
    return o.reshape(b, h, sq, d).to(q.dtype)
