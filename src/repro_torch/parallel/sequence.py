"""Decode on a cache whose slot axis is split over the data axes: the
long-context layout of ``parallel.planner.cache_specs`` (a batch that the
data axes do not divide, ``long_500k``'s batch of 1), the JAX package's
``kv_cache_seqsharded`` and ``mla_cache_seqsharded``.

Under those specs XLA keeps the JAX package's ``decode_step`` exact: it
writes the new token's K/V on the rank that owns its slot and combines the
per-rank softmax statistics across the ranks.  The port does both itself:

- ``models.init_cache(..., ctx=)`` allocates, where
  ``planner.slot_split`` says so, only this rank's block of each
  self-attention and MLA cache, a ``SlotBlock``: global slots
  [lo, lo + n) of a ring (of MLA, of positions) of ``slots``, n = slots /
  dp and lo = rank n, the rank its data rank as ``launch.mesh.mesh_groups``
  numbers it (``jax.make_mesh``'s row-major order, over ``("pod",
  "data")`` on the multi-pod mesh);
- ``models.attention.gqa_decode`` and ``mla_decode`` write the new token on
  its owner only (``write_owned``) and attend over the block:
  ``partial_softmax`` gives each query head's max m and exponentials, of
  which the sum l and the unnormalised output o follow, all in f32; a
  block with no valid slot yet gives m = -inf, l = 0 and o = 0;
- ``combine`` gathers (o, m, l) over the data group with
  ``ring_all_gather`` and merges them in rank order, as
  ``ParallelCtx.allsum`` sums, so that every data rank holds the same bits;
  ``combine_bytes`` is what that puts on the wire.

The Mamba conv histories and SSM state and the cross-attention K/V stay
whole on every data rank, which all compute the same update.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.ccl import primitives as prim
from repro_torch.core.types import ModelConfig
from repro_torch.parallel.planner import ParallelCtx, slot_split, tp_layout


class SlotBlock(dict):
    """One layer's self-attention (``k``, ``v``: (B, n, KV, hd)) or MLA
    (``c``, ``k_rope``: (B, n, r)) cache on a rank of a sequence-split
    layout: its tensors hold global slots [lo, lo + n) of ``slots``.  A
    dict of the tensors, so that the walkers of a cache tree see them as
    any layer's."""

    def __init__(self, tensors: dict, slots: int, lo: int):
        super().__init__(tensors)
        self.slots = slots
        self.lo = lo


def cache_slots(cfg: ModelConfig, max_len: int, window: Optional[int]
                ) -> int:
    """The slots of a self-attention layer's cache: the ring of
    ``window`` (by default the config's sliding window) where it is
    shorter than ``max_len``, else ``max_len``; MLA holds every
    position."""
    win = window if window is not None else cfg.sliding_window
    if cfg.attention == "mla" or not win:
        return max_len
    return min(max_len, win)


def block_of(cache: dict, ctx) -> Tuple[int, int]:
    """(lo, slots) of a layer's cache: its block's first global slot and
    the whole ring's slots; (0, n) for a whole cache.  A ``SlotBlock``
    needs the data-parallel ``ctx`` it was cut for."""
    if not isinstance(cache, SlotBlock):
        return 0, next(iter(cache.values())).shape[1]
    n = next(iter(cache.values())).shape[1]
    if ctx is None or ctx.dp * n != cache.slots:
        raise ValueError(f"a block of {n} of {cache.slots} slots needs the "
                         f"context of the data ranks it was cut for")
    return cache.lo, cache.slots


def write_owned(cache: dict, index: torch.Tensor, values: dict) -> None:
    """Write ``values[name]`` (B, ...) at local slot ``index`` (B,) of
    ``cache[name]``, in place, in each row whose index lies in this block;
    the other rows keep their slots (no sync with the host)."""
    n = next(iter(cache.values())).shape[1]
    mine = (index >= 0) & (index < n)
    at = index.clamp(0, n - 1)
    bi = torch.arange(index.shape[0], device=index.device)
    for name, v in values.items():
        t = cache[name]
        keep = t[bi, at]
        own = mine.view(-1, *([1] * (keep.dim() - 1)))
        t[bi, at] = torch.where(own, v.to(t.dtype), keep)


def partial_softmax(scores: torch.Tensor, valid: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """scores (..., n) f32 over a block's slots, ``valid`` broadcastable to
    them: (m (..., 1), e (..., n)), the max of the valid scores (-inf where
    none is) and exp(scores - m) at the valid slots, 0 elsewhere."""
    s = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    m = s.amax(dim=-1, keepdim=True)
    shift = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return m, torch.exp(s - shift)


def combine(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor, ctx
            ) -> torch.Tensor:
    """The attention output over every data rank's block, from this
    block's max ``m`` and sum of exponentials ``l`` (..., 1) and
    unnormalised output ``o`` (..., d), f32: one ``ring_all_gather`` of
    (o, m, l) over ``ctx.group``, then each rank's terms rescaled to the
    greatest max and summed in rank order.  Some rank holds a valid slot
    (the new token's owner), so the greatest max is finite."""
    got = prim.ring_all_gather(torch.cat([o, m, l], dim=-1), ctx.group)
    m_r, l_r = got[..., -2:-1], got[..., -1:]
    w = torch.exp(m_r - m_r.amax(dim=0))
    return (w * got[..., :-2]).sum(dim=0) / (w * l_r).sum(dim=0)


def combine_bytes(cfg: ModelConfig, dp: int, tp: int, batch: int,
                  max_len: int, window: Optional[int] = None) -> int:
    """Wire bytes a rank sends a decode step for ``combine``, on a mesh of
    ``dp`` data and ``tp`` model ranks, a global ``batch``: per
    self-attention or MLA layer whose cache ``slot_split`` splits,
    (dp - 1) B H_local (d_o + 2) 4, the f32 (o, m, l) of each of the
    rank's query heads (all of them where the model axis does not split
    them), d_o the head dim (MLA: its value head, after ``w_uv``)."""
    if not slot_split(batch, cache_slots(cfg, max_len, window), dp):
        return 0
    lay = tp_layout(cfg, ParallelCtx(tp=tp))
    heads = cfg.num_heads // tp if lay is not None and lay.heads \
        else cfg.num_heads
    d_o = cfg.resolved_v_head_dim if cfg.attention == "mla" \
        else cfg.resolved_head_dim
    layers = sum(spec.mixer == "attn" for spec in cfg.layer_specs())
    return layers * (dp - 1) * batch * heads * (d_o + 2) * 4
