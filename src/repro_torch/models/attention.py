"""GQA self-attention (+RoPE, QKV bias, sliding window) for prefill and decode.

Port of the GQA part of ``repro.models.attention``.  Prefill attention on a
CUDA tensor goes to the hand-written flash-attention kernel whenever
Sq == Sk and the q and v head dims agree; on the CPU it takes the plain
einsum path.  The device decides; there is no flag.

Decode attends one new token against a KV cache; sliding-window caches are
ring buffers of ``window`` slots.  Unlike the JAX package, the cache is
updated in place (it is the largest state of a server) and returned.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.types import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.modules import apply_rope, dense_init

NEG_INF = -1e30  # finite: fully masked rows stay finite (never -inf)


def init_gqa(cfg: ModelConfig, dtype, device,
             generator: torch.Generator) -> dict:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    p = {
        "wq": dense_init(d, (cfg.num_heads, hd), dtype, device, generator),
        "wk": dense_init(d, (cfg.num_kv_heads, hd), dtype, device, generator),
        "wv": dense_init(d, (cfg.num_kv_heads, hd), dtype, device, generator),
        "wo": dense_init(cfg.num_heads * hd, (d,), dtype, device,
                         generator).reshape(cfg.num_heads, hd, d),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.num_heads, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((cfg.num_kv_heads, hd), dtype=dtype,
                              device=device)
        p["bv"] = torch.zeros((cfg.num_kv_heads, hd), dtype=dtype,
                              device=device)
    return p


def _group_q(q: torch.Tensor, num_kv: int) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, KV, G, hd): head h reads KV head h // G."""
    b, s, h, hd = q.shape
    return q.reshape(b, s, num_kv, h // num_kv, hd)


def _plain_attention(q, k, v, *, q_pos, k_pos, causal, window):
    """q: (B,Sq,KV,G,hd); k,v: (B,Sk,KV,hd).  Materializes the (Sq,Sk) f32
    scores."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqkgh,bskh->bqkgs", q.float(), k.float()) * scale
    mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    scores = torch.where(mask[None, :, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bqkgs,bskh->bqkgh", probs.to(v.dtype), v)


def kernel_attention(q, k, v, *, causal, window=None):
    """q: (B,S,H,hd); k, v: (B,S,KV,hd) -> (B,S,H,hd) through the kernel,
    which takes them as (B,H,S,D) views and reads them, and writes its
    output, through their strides: no copies."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, window=window)
    return out.transpose(1, 2)


def multihead_attention(q, k, v, *, q_pos, k_pos, causal, window=None):
    """q: (B,Sq,H,hd) ungrouped; k, v: (B,Sk,KV,hd).

    Dispatch rule of repro/models/attention.py:228-229 minus the TPU's
    Sq % 128 tiling condition: the CUDA kernel masks its own ragged edge.
    The kernel assumes contiguous positions 0..S-1, as prefill gives."""
    if q.is_cuda and q.shape[1] == k.shape[1] and \
            q.shape[-1] == v.shape[-1]:
        return kernel_attention(q, k, v, causal=causal, window=window)
    out = _plain_attention(_group_q(q, k.shape[2]), k, v, q_pos=q_pos,
                           k_pos=k_pos, causal=causal, window=window)
    b, s = q.shape[:2]
    return out.reshape(b, s, q.shape[2], v.shape[-1])


def _project_qkv(p: dict, cfg: ModelConfig, x):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias and "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def gqa_forward(p: dict, cfg: ModelConfig, x, positions, *, window=None):
    """x: (B,S,d); positions: (S,) absolute positions."""
    q, k, v = _project_qkv(p, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    win = window if window is not None else cfg.sliding_window
    out = multihead_attention(q, k, v, q_pos=positions, k_pos=positions,
                              causal=True, window=win)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device,
                  window=None) -> dict:
    """Slot axis first: k, v are (batch, slots, KV, hd)."""
    win = window if window is not None else cfg.sliding_window
    slots = min(max_len, win) if win else max_len
    shape = (batch, slots, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _pos_vec(pos, batch: int, device) -> torch.Tensor:
    """Normalize decode positions to a (B,) int64 vector (per-sequence
    positions enable continuous batching)."""
    pos = torch.as_tensor(pos, dtype=torch.int64, device=device)
    return pos.expand(batch) if pos.dim() == 0 else pos


def _ring_slot_positions(pos: torch.Tensor, slots: int) -> torch.Tensor:
    """Positions stored in each ring slot after the token at ``pos`` was
    inserted; -1 where the slot has never been written. pos: (B,).

    Floor modulo of possibly negative numbers: torch's ``%`` matches
    jnp.mod; ``torch.fmod`` would not."""
    s = torch.arange(slots, device=pos.device)
    p = pos[:, None] - ((pos[:, None] - s[None, :]) % slots)
    return torch.where(p >= 0, p, torch.full_like(p, -1))


def gqa_decode(p: dict, cfg: ModelConfig, x, cache: dict, pos, *,
               window=None):
    """x: (B,1,d); pos: int or (B,) position(s) of the new token.
    Writes the new K/V into ``cache`` in place; returns
    (out (B,1,d), cache)."""
    b = x.shape[0]
    pos = _pos_vec(pos, b, x.device)
    q, k, v = _project_qkv(p, cfg, x)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)

    slots = cache["k"].shape[1]
    slot = pos % slots
    bi = torch.arange(b, device=x.device)
    cache["k"][bi, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][bi, slot] = v[:, 0].to(cache["v"].dtype)

    slot_pos = _ring_slot_positions(pos, slots)  # (B, slots)
    win = window if window is not None else cfg.sliding_window
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    if win:
        valid &= pos[:, None] - slot_pos < win

    qg = _group_q(q, cache["k"].shape[2])  # (B,1,KV,G,hd)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqkgh,bskh->bqkgs", qg.float(),
                          cache["k"].float()) * scale
    scores = torch.where(valid[:, None, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bqkgs,bskh->bqkgh", probs.to(cache["v"].dtype),
                       cache["v"])
    out = out.reshape(b, 1, cfg.num_heads, -1).to(x.dtype)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache
