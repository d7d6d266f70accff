"""Attention flavours: GQA (+RoPE, QKV bias, sliding window), MLA and
cross-attention, for prefill and decode.

Port of ``repro.models.attention``.  Prefill and training attention on a
CUDA tensor goes to the hand-written flash-attention kernel whenever
Sq == Sk and the q and v head dims agree (its gradient to the backward
kernel); otherwise, and on the CPU, it takes the plain einsum path up to
``_PLAIN_ATTN_MAX_SEQ ** 2`` scores and the chunked online-softmax path
above, as the JAX package does.  The device decides; there is no flag.
So MLA (q head dim ``head_dim + qk_rope_head_dim``, v head dim
``v_head_dim``: 192 and 128 in deepseek-v2) always takes the plain or
chunked path, as in the JAX package, which calls no Pallas kernel for
MLA or cross-attention; cross-attention takes the kernel (non-causal)
only where the query and context lengths agree.

Decode attends one new token against a KV cache; sliding-window caches are
ring buffers of ``window`` slots; the MLA cache holds the compressed latent
and the shared rope key of every position; cross-attention K/V are
computed once from the context.  Unlike the JAX package, the caches are
updated in place (they are the largest state of a server) and returned.

Tensor parallelism (``ctx``, a context of ``ParallelCtx.tensor_parallel``):
GQA self-attention runs on this model rank's block of the query heads
where ``parallel.planner.tp_layout`` splits them (``wq``, ``bq`` and the
rows of ``wo``), the input through ``copy_to_model`` and the output's
partial sums through ``reduce_from_model``.  Where the KV heads split
too, ``wk``/``wv`` hold this rank's; where they do not (fewer KV heads
than ranks), every rank projects them all and attends with those of its
query heads: local query head i is global head r H/tp + i, whose KV head
is the global index over G = H / KV (``local_kv_heads``), and their
gradient is summed over the model ranks.  Where the query heads do not
split either, the attention is replicated and nothing is summed.  The
KV cache holds the KV heads of this rank's ``wk``.

Cross-attention splits the same way, its keys and values projected from
the context, which enters through ``copy_to_model`` (the encoder's
gradient is summed over the model ranks); ``tanh(gate_attn)`` scales the
output after ``reduce_from_model``, as the JAX package applies it after
``wo``, so that its gradient is the whole output's.  Its cache holds the
KV heads of this rank's ``wk`` (all of them where they do not split).
MLA computes its low-rank paths whole on every rank (``w_dq``,
``w_dkv`` and their norms stay replicated) and its heads on this rank's
block of ``w_uq``, ``w_uk``, ``w_uv`` and ``wo``: the normed query latent,
the KV latent and the rope key enter the heads through ``copy_to_model``,
where the replicated part meets the split part, so that every rank's
gradient of the replicated weights is all heads' (as Mamba's B and C).
Its decode cache (the latent) is whole on every rank.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.types import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.modules import (apply_rope, dense_init, init_norm,
                                        rms_norm, whole)
from repro_torch.parallel.planner import tp_layout
from repro_torch.parallel.tensor import copy_to_model, reduce_from_model

NEG_INF = -1e30  # finite: fully masked rows stay finite (never -inf)
_PLAIN_ATTN_MAX_SEQ = 2048  # above 2048^2 scores the CPU path goes chunked
_Q_CHUNK = 1024
_KV_CHUNK = 1024


def init_gqa(cfg: ModelConfig, dtype, device, generator: torch.Generator,
             cross: bool = False, cut=whole) -> dict:
    """GQA projections; ``cross``: a cross-attention block, whose output is
    scaled by ``tanh(gate_attn)``, the gate starting at 0 (Llama-3.2-Vision's
    gating): a fresh cross block adds nothing to the stream.  ``cut``: as
    ``modules.init_ffn``'s."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": cut("wq", dense_init(d, (h, hd), dtype, device, generator)),
        "wk": cut("wk", dense_init(d, (kv, hd), dtype, device, generator)),
        "wv": cut("wv", dense_init(d, (kv, hd), dtype, device, generator)),
        "wo": cut("wo", dense_init(h * hd, (d,), dtype, device,
                                   generator).reshape(h, hd, d)),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", h), ("bk", kv), ("bv", kv)):
            p[name] = cut(name, torch.zeros((n, hd), dtype=dtype,
                                            device=device))
    if cross:
        p["gate_attn"] = torch.zeros((), dtype=dtype, device=device)
    return p


def init_mla(cfg: ModelConfig, dtype, device,
             generator: torch.Generator, cut=whole) -> dict:
    """DeepSeek-V2's multi-head latent attention: queries through a
    low-rank ``w_dq`` (where ``q_lora_rank``), keys and values
    decompressed per head from one ``kv_lora_rank`` latent, plus one rope
    key shared by the heads.  ``cut``: as ``init_gqa``'s (it keeps the
    low-rank projections and their norms whole)."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim  # qk nope dim
    vhd = cfg.resolved_v_head_dim
    rhd = cfg.qk_rope_head_dim
    h = cfg.num_heads
    p = {}
    if cfg.q_lora_rank:
        p["w_dq"] = dense_init(d, (cfg.q_lora_rank,), dtype, device,
                               generator)
        p["norm_q"] = init_norm(cfg.q_lora_rank, dtype, device)
    q_in = cfg.q_lora_rank or d
    p["w_uq"] = cut("w_uq", dense_init(q_in, (h, hd + rhd), dtype, device,
                                       generator))
    p["w_dkv"] = dense_init(d, (cfg.kv_lora_rank + rhd,), dtype, device,
                            generator)
    p["norm_kv"] = init_norm(cfg.kv_lora_rank, dtype, device)
    p["w_uk"] = cut("w_uk", dense_init(cfg.kv_lora_rank, (h, hd), dtype,
                                       device, generator))
    p["w_uv"] = cut("w_uv", dense_init(cfg.kv_lora_rank, (h, vhd), dtype,
                                       device, generator))
    p["wo"] = cut("wo", dense_init(h * vhd, (d,), dtype, device,
                                   generator).reshape(h, vhd, d))
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


def _flash_attention_chunked(q, k, v, *, q_pos, k_pos, causal, window,
                             q_chunk=_Q_CHUNK, kv_chunk=_KV_CHUNK,
                             causal_skip: bool = False,
                             unroll: bool = False):
    """Flash-style online-softmax attention in plain PyTorch: port of the
    JAX package's ``_flash_attention_jnp``.  By default a uniform double
    loop over q and kv chunks, so every chunk pair is computed, as the
    double ``lax.scan`` (twice the causal FLOPs).  ``causal_skip`` (with
    ``causal``): each q chunk runs over the kv chunks it can see, from the
    first that its window reaches to the last that holds a key at or below
    its last position (exact-causal FLOPs, as the JAX package's Python loop
    over q chunks).  ``unroll``: both chunks 2048, the JAX package's
    dry-run cost mode (its loops are Python loops here anyway).

    q: (B,Sq,KV,G,hd); k, v: (B,Sk,KV,hd); q_pos (Sq,), k_pos (Sk,).
    Ragged tails are padded: padded keys get the largest int32 position
    (the causal mask drops them) and a validity mask (for the other masks);
    padded queries are cut from the output.  Scores and the running max,
    sum and accumulator are f32; the output takes q's dtype."""
    if unroll:
        q_chunk = kv_chunk = 2048
    b, sq, nkv, g, hd = q.shape
    sk = k.shape[1]
    vd = v.shape[-1]
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, sk)
    sq_pad = (-sq) % q_chunk
    sk_pad = (-sk) % kv_chunk
    if sq_pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 0, 0, sq_pad))
        q_pos = torch.nn.functional.pad(q_pos, (0, sq_pad))
    if sk_pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, sk_pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, sk_pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, sk_pad),
                                        value=torch.iinfo(torch.int32).max)
    k_valid = torch.arange(sk + sk_pad, device=q.device) < sk
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for i in range(0, sq + sq_pad, q_chunk):
        q_blk, qp = q[:, i:i + q_chunk].float(), q_pos[i:i + q_chunk]
        m = torch.full((b, q_chunk, nkv, g), NEG_INF, device=q.device)
        l = torch.zeros((b, q_chunk, nkv, g), device=q.device)
        acc = torch.zeros((b, q_chunk, nkv, g, vd), device=q.device)
        lo, hi = 0, sk + sk_pad
        if causal_skip and causal:
            if window is not None:
                lo = max(0, (i - int(window)) // kv_chunk * kv_chunk)
            hi = min(-(-(i + q_chunk) // kv_chunk) * kv_chunk, hi)
        for j in range(lo, hi, kv_chunk):
            kp = k_pos[j:j + kv_chunk]
            s = torch.einsum("bqkgh,bskh->bqkgs", q_blk,
                             k[:, j:j + kv_chunk].float()) * scale
            mask = k_valid[None, j:j + kv_chunk].expand(q_chunk, kv_chunk)
            if causal:
                mask = mask & (qp[:, None] >= kp[None, :])
            if window is not None:
                mask = mask & (qp[:, None] - kp[None, :] < window)
            s = torch.where(mask[None, :, None, None, :], s,
                            torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            v_blk = v[:, j:j + kv_chunk]
            acc = acc * corr[..., None] + torch.einsum(
                "bqkgs,bskh->bqkgh", p.to(v_blk.dtype).float(),
                v_blk.float())
            m = m_new
        outs.append((acc / l.clamp(min=1e-30)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=1)[:, :sq]


def kernel_attention(q, k, v, *, causal, window=None):
    """q: (B,S,H,hd); k, v: (B,S,KV,hd) -> (B,S,H,hd) through the kernel,
    which takes them as (B,H,S,D) views and reads them, and writes its
    output, through their strides: no copies."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, window=window)
    return out.transpose(1, 2)


def multihead_attention(q, k, v, *, q_pos, k_pos, causal, window=None,
                        causal_skip=False, unroll=False):
    """q: (B,Sq,H,hd) ungrouped; k, v: (B,Sk,KV,hd).

    Dispatch rule of repro/models/attention.py:228-243 minus the TPU's
    Sq % 128 tiling condition (the CUDA kernel masks its own ragged edge),
    with the device in place of ``use_pallas``.  The kernel assumes
    contiguous positions 0..S-1, as prefill and training give.
    ``causal_skip``, ``unroll``: the chunked path's (the kernel and the
    plain path ignore them, as in the JAX package)."""
    if q.is_cuda and q.shape[1] == k.shape[1] and \
            q.shape[-1] == v.shape[-1]:
        return kernel_attention(q, k, v, causal=causal, window=window)
    qg = _group_q(q, k.shape[2])
    if q.shape[1] * k.shape[1] <= _PLAIN_ATTN_MAX_SEQ ** 2:
        out = _plain_attention(qg, k, v, q_pos=q_pos, k_pos=k_pos,
                               causal=causal, window=window)
    else:
        out = _flash_attention_chunked(qg, k, v, q_pos=q_pos, k_pos=k_pos,
                                       causal=causal, window=window,
                                       causal_skip=causal_skip,
                                       unroll=unroll)
    b, s = q.shape[:2]
    return out.reshape(b, s, q.shape[2], v.shape[-1])


def _project_qkv(p: dict, cfg: ModelConfig, x, kv_x=None):
    kv_x = x if kv_x is None else kv_x
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", kv_x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", kv_x, p["wv"])
    if cfg.qkv_bias and "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def local_kv_heads(cfg: ModelConfig, heads: int, rank: int):
    """The KV heads of query heads ``rank heads .. (rank+1) heads - 1``
    (head h reads KV head h // G): a slice where each of them serves an
    equal run of those query heads, else a list, one a query head."""
    g = cfg.num_heads // cfg.num_kv_heads
    kv = [(rank * heads + i) // g for i in range(heads)]
    lo, n = kv[0], kv[-1] - kv[0] + 1
    if heads % n == 0 and kv == [lo + i // (heads // n)
                                 for i in range(heads)]:
        return slice(lo, lo + n)
    return kv


def _tp_heads(cfg: ModelConfig, ctx):
    """The layout of a tensor-parallel ``ctx`` whose query heads split,
    else ``None`` (the attention replicated)."""
    lay = tp_layout(cfg, ctx)
    return lay if lay is not None and lay.heads else None


def _tp_qkv(p: dict, cfg: ModelConfig, x, lay, ctx, kv_x=None):
    """q of this rank's query heads; k and v (from ``kv_x``, by default
    ``x``) of the KV heads they read (all of them from a replicated
    ``wk``/``wv``, whose gradient then sums over the model ranks) and the
    KV selection (``None``: all)."""
    xf = copy_to_model(x, ctx)
    if kv_x is None:
        kv_x, kvf = x, xf
    else:
        kvf = copy_to_model(kv_x, ctx)
    if lay.kv:
        q, k, v = _project_qkv(p, cfg, xf, kv_x=kvf)
        return q, k, v, None
    q, k, v = _project_qkv(p, cfg, xf, kv_x=kv_x)
    return q, copy_to_model(k, ctx), copy_to_model(v, ctx), \
        local_kv_heads(cfg, q.shape[2], lay.rank)


def gqa_forward(p: dict, cfg: ModelConfig, x, positions, *, window=None,
                ctx=None, causal_skip=False, unroll=False):
    """x: (B,S,d); positions: (S,) absolute positions.  ``ctx``: a
    tensor-parallel context (the module's docstring).  ``causal_skip``,
    ``unroll``: ``multihead_attention``'s."""
    lay = _tp_heads(cfg, ctx)
    if lay is None:
        q, k, v = _project_qkv(p, cfg, x)
    else:
        q, k, v, sel = _tp_qkv(p, cfg, x, lay, ctx)
        if sel is not None:
            k, v = k[:, :, sel], v[:, :, sel]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    win = window if window is not None else cfg.sliding_window
    out = multihead_attention(q, k, v, q_pos=positions, k_pos=positions,
                              causal=True, window=win,
                              causal_skip=causal_skip, unroll=unroll)
    return _out_proj(out, p, None if lay is None else ctx)


def _gated(p: dict, out: torch.Tensor) -> torch.Tensor:
    if "gate_attn" in p:
        out = out * torch.tanh(p["gate_attn"])
    return out


def _out_proj(out, p: dict, ctx):
    """``wo`` of the attention output (B, S, H or H/tp, hd), summed over
    the model ranks of ``ctx`` (``None``: the heads do not split)."""
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return out if ctx is None else reduce_from_model(out, ctx)


def cross_attention_forward(p: dict, cfg: ModelConfig, x, context,
                            ctx=None, unroll=False):
    """Cross-attention: queries from x (B,S,d), keys and values from the
    context (B,T,d).  No RoPE, no mask (Llama-3.2-Vision / enc-dec
    style).  ``ctx``: as ``gqa_forward``'s (the module's docstring)."""
    lay = _tp_heads(cfg, ctx)
    if lay is None:
        q, k, v = _project_qkv(p, cfg, x, kv_x=context)
    else:
        q, k, v, sel = _tp_qkv(p, cfg, x, lay, ctx, kv_x=context)
        if sel is not None:
            k, v = k[:, :, sel], v[:, :, sel]
    out = multihead_attention(
        q, k, v, q_pos=torch.arange(x.shape[1], device=x.device),
        k_pos=torch.arange(context.shape[1], device=x.device), causal=False,
        unroll=unroll)
    return _gated(p, _out_proj(out, p, None if lay is None else ctx))


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device,
                  window=None, kv_heads=None) -> dict:
    """Slot axis first: k, v are (batch, slots, KV, hd), ``kv_heads`` (by
    default the config's) KV heads: a tensor-parallel rank's are those of
    its ``wk``."""
    win = window if window is not None else cfg.sliding_window
    slots = min(max_len, win) if win else max_len
    shape = (batch, slots, kv_heads or cfg.num_kv_heads,
             cfg.resolved_head_dim)
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
               window=None, ctx=None):
    """x: (B,1,d); pos: int or (B,) position(s) of the new token.
    Writes the new K/V into ``cache`` in place; returns
    (out (B,1,d), cache).  ``ctx``: as ``gqa_forward``'s; the cache holds
    the KV heads this rank projects."""
    b = x.shape[0]
    pos = _pos_vec(pos, b, x.device)
    lay = _tp_heads(cfg, ctx)
    sel = None
    if lay is None:
        q, k, v = _project_qkv(p, cfg, x)
    else:
        q, k, v, sel = _tp_qkv(p, cfg, x, lay, ctx)
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

    ck, cv = cache["k"], cache["v"]
    if sel is not None:
        ck, cv = ck[:, :, sel], cv[:, :, sel]
    qg = _group_q(q, ck.shape[2])  # (B,1,KV,G,hd)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqkgh,bskh->bqkgs", qg.float(),
                          ck.float()) * scale
    scores = torch.where(valid[:, None, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bqkgs,bskh->bqkgh", probs.to(cv.dtype), cv)
    out = out.reshape(b, 1, q.shape[2], -1).to(x.dtype)
    return _out_proj(out, p, None if lay is None else ctx), cache


def init_cross_cache(p: dict, cfg: ModelConfig, context, dtype) -> dict:
    """Cross-attention K/V computed once from the (encoder or vision)
    context: (B, T, KV, hd) each, with no slot axis of their own (their
    batch is the context's); the KV heads of ``wk``, on a
    tensor-parallel rank its own (``parallel.planner.cache_specs``)."""
    k = torch.einsum("btd,dhk->bthk", context, p["wk"])
    v = torch.einsum("btd,dhk->bthk", context, p["wv"])
    if cfg.qkv_bias and "bk" in p:
        k = k + p["bk"]
        v = v + p["bv"]
    return {"k": k.to(dtype), "v": v.to(dtype)}


def cross_attention_decode(p: dict, cfg: ModelConfig, x, cross_cache: dict,
                           ctx=None):
    """x: (B,1,d) against the precomputed K/V of ``init_cross_cache``.
    ``ctx``: as ``cross_attention_forward``'s; the cache holds this rank's
    KV heads, or all of them where they do not split."""
    lay = _tp_heads(cfg, ctx)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if cfg.qkv_bias and "bq" in p:
        q = q + p["bq"]
    k, v = cross_cache["k"], cross_cache["v"]
    if lay is not None and not lay.kv:
        sel = local_kv_heads(cfg, q.shape[2], lay.rank)
        k, v = k[:, :, sel], v[:, :, sel]
    qg = _group_q(q, k.shape[2])
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqkgh,bskh->bqkgs", qg.float(), k.float()) * scale
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bqkgs,bskh->bqkgh", probs.to(v.dtype), v)
    out = out.reshape(x.shape[0], x.shape[1], q.shape[2], -1).to(x.dtype)
    return _gated(p, _out_proj(out, p, None if lay is None else ctx))


def _mla_q(p: dict, cfg: ModelConfig, x, positions, ctx=None):
    """(q_nope (B,S,H,hd), q_rope (B,S,H,rope)), q_rope rotated; ``ctx``
    (where the heads split): the heads of this rank's ``w_uq``, its input
    (the normed latent, or x) through ``copy_to_model``."""
    hd = cfg.resolved_head_dim
    if cfg.q_lora_rank:
        q_in = rms_norm(x @ p["w_dq"], p["norm_q"]["scale"], cfg.norm_eps)
    else:
        q_in = x
    if ctx is not None:
        q_in = copy_to_model(q_in, ctx)
    q = torch.einsum("bsr,rhk->bshk", q_in, p["w_uq"])
    return q[..., :hd], apply_rope(q[..., hd:], positions, cfg.rope_theta)


def _mla_latent(p: dict, cfg: ModelConfig, x, positions, ctx=None):
    """(c (B,S,kv_lora_rank) normed, k_rope (B,S,rope) rotated); ``ctx``
    (where the heads split): both through ``copy_to_model``."""
    ckv = x @ p["w_dkv"]
    r = cfg.kv_lora_rank
    c = rms_norm(ckv[..., :r], p["norm_kv"]["scale"], cfg.norm_eps)
    # k_rope is shared across heads: rotated as a single head
    k_rope = apply_rope(ckv[..., None, r:], positions,
                        cfg.rope_theta)[..., 0, :]
    if ctx is not None:
        c, k_rope = copy_to_model(c, ctx), copy_to_model(k_rope, ctx)
    return c, k_rope


def _tp_mla(cfg: ModelConfig, ctx):
    """``ctx`` where it splits MLA's heads, else ``None``."""
    return ctx if _tp_heads(cfg, ctx) is not None else None


def mla_forward(p: dict, cfg: ModelConfig, x, positions, *, window=None,
                ctx=None, causal_skip=False, unroll=False):
    """Decompressed MLA for train and prefill: per-head K/V materialized
    from the latent, then ``multihead_attention`` (whose scale is
    1/sqrt(head_dim + qk_rope_head_dim), the q head dim).  ``ctx``: this
    rank's heads (the module's docstring).  ``causal_skip``, ``unroll``:
    ``multihead_attention``'s (MLA always takes the plain or chunked
    path)."""
    tctx = _tp_mla(cfg, ctx)
    q_nope, q_rope = _mla_q(p, cfg, x, positions, tctx)
    c, k_rope = _mla_latent(p, cfg, x, positions, tctx)
    k_nope = torch.einsum("bsr,rhk->bshk", c, p["w_uk"])
    v = torch.einsum("bsr,rhk->bshk", c, p["w_uv"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        *k_nope.shape[:3], cfg.qk_rope_head_dim)], dim=-1)
    out = multihead_attention(q, k, v, q_pos=positions, k_pos=positions,
                              causal=True, window=window,
                              causal_skip=causal_skip, unroll=unroll)
    return _out_proj(out, p, tctx)


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> dict:
    """The latent and the shared rope key of every position, slot axis
    first: c (batch, max_len, kv_lora_rank), k_rope (batch, max_len,
    qk_rope_head_dim)."""
    return {"c": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                             dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                                  dtype=dtype, device=device)}


def mla_decode(p: dict, cfg: ModelConfig, x, cache: dict, pos, ctx=None):
    """Absorbed MLA decode: attends in the latent space (DeepSeek-V2's
    deployment form), ``w_uk`` absorbed into the query and ``w_uv``
    applied after the softmax.  x: (B,1,d); pos: int or (B,) positions.
    Writes the new latent and rope key into ``cache`` in place; positions
    above ``pos`` are masked, so a recycled slot needs no reset.  Returns
    (out (B,1,d), cache).  ``ctx``: this rank's heads, as
    ``mla_forward``'s; the latent cache is whole on every rank."""
    b = x.shape[0]
    pos = _pos_vec(pos, b, x.device)
    tctx = _tp_mla(cfg, ctx)
    q_nope, q_rope = _mla_q(p, cfg, x, pos[:, None], tctx)  # (B,1,H,*)
    c_new, k_rope_new = _mla_latent(p, cfg, x, pos[:, None])
    bi = torch.arange(b, device=x.device)
    cache["c"][bi, pos] = c_new[:, 0].to(cache["c"].dtype)
    cache["k_rope"][bi, pos] = k_rope_new[:, 0].to(cache["k_rope"].dtype)
    c, k_rope = cache["c"], cache["k_rope"]

    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"])
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim + cfg.qk_rope_head_dim)
    scores = (torch.einsum("bshr,blr->bshl", q_lat.float(), c.float())
              + torch.einsum("bshk,blk->bshl", q_rope.float(),
                             k_rope.float())) * scale
    valid = torch.arange(c.shape[1], device=x.device)[None, :] <= pos[:, None]
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    ctx_lat = torch.einsum("bshl,blr->bshr", probs.to(c.dtype), c)
    v = torch.einsum("bshr,rhk->bshk", ctx_lat.to(x.dtype), p["w_uv"])
    return _out_proj(v, p, tctx), cache
