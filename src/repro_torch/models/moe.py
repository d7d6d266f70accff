"""Mixture-of-Experts FFN with three execution paths (port of
``repro.models.moe``).

- ``moe_dense`` computes every expert on every token and masks by routing
  weight: exact, no capacity drops; the single-device path, and under
  data parallelism each rank's.
- ``moe_ep_train`` (training and prefill): the sequence sharded over the
  model axis, a capacity dispatch, one ``all_to_all`` to the experts'
  ranks, the three expert products, one ``all_to_all`` back, the weighted
  combine.
- ``moe_ep_decode``: every rank computes its own experts on the tokens
  routed to them, and a ring all-reduce over the model axis combines;
  ``moe_ep_decode_ws`` (weight-stationary) also keeps the ffn dim of the
  experts over the data axes and sums over both axes.

Every expert product runs the hand-written grouped-GEMM kernel K5 on CUDA
tensors, and its gradient the backward kernel K5-bwd, and the plain
einsum on the CPU; the wrapper decides by device.
The JAX package runs the expert-parallel bodies in a ``shard_map``; here
every rank of the mesh runs its shard, with the port's collectives over
the groups of a ``parallel.ParallelCtx`` (``make_ctx``), whose
``use_ep`` picks the path (``moe_apply``).  Routing runs on each rank's
whole activations (its data shard, replicated over the model axis), as in
the JAX package's pjit region; in training and prefill the pick
fractions of the load-balance loss are summed over the data ranks, so
that the ranks' losses add up to the loss of the global batch (decode
discards the loss and skips that sum).  The shared experts are a dense
FFN over the whole sequence: on a model axis each rank computes its
column block of them and the ranks' partial products are summed
(``_shared``, tensor parallelism beside the experts' expert parallelism,
as ``param_specs`` lays out a MoE config).
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.ccl import primitives as prim
from repro_torch.core.types import ModelConfig
from repro_torch.kernels.moe_gmm.ops import moe_gmm
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref
from repro_torch.models.modules import (_gelu, dense_init, ffn_apply,
                                        init_ffn, whole)
from repro_torch.parallel.planner import (expert_range, ffn_slice,
                                          sharded_experts, tp_layout)


def init_moe(cfg: ModelConfig, dtype, device,
             generator: torch.Generator, ctx=None, cut=whole) -> dict:
    """The MoE layer's parameters drawn from ``generator``.  With an
    expert-parallel ``ctx`` only this rank's part of each expert weight is
    kept (``parallel.shard_params``'s layout), but every expert is drawn,
    one at a time, so that the generator runs through the full sequence:
    the part is bit-equal to the slice of the full draw, and no rank
    holds all experts of a layer.  ``cut``: as ``modules.init_ffn``'s, on
    the shared experts (a tensor-parallel rank's column block)."""
    d = cfg.d_model
    ff = cfg.moe_d_ff or cfg.d_ff
    e = cfg.num_experts
    lo, hi = expert_range(e, ctx) if sharded_experts(ctx) else (0, e)

    def stack(name, in_dim, out_dim):
        if torch.device(device).type == "meta":  # shapes only: draw nothing
            w = torch.empty((hi - lo, in_dim, out_dim), dtype=dtype,
                            device=device)
            return ffn_slice(name, w, ctx) if sharded_experts(ctx) else w
        kept = []
        for i in range(e):
            w = dense_init(in_dim, (out_dim,), dtype, device, generator)
            if lo <= i < hi:
                kept.append(w)
        w = torch.stack(kept)
        return ffn_slice(name, w, ctx) if sharded_experts(ctx) else w

    p = {
        # f32 whatever the weights' dtype, as in the JAX package
        "router": dense_init(d, (e,), torch.float32, device, generator),
        "w_gate": stack("w_gate", d, ff),
        "w_up": stack("w_up", d, ff),
        "w_down": stack("w_down", ff, d),
    }
    if cfg.num_shared_experts:
        p["shared"] = init_ffn(cfg, ff * cfg.num_shared_experts, dtype,
                               device, generator, cut=cut)
    return p


def route(p: dict, cfg: ModelConfig, x: torch.Tensor, ctx=None):
    """x: (..., d). Returns (ids (...,k), weights (...,k) in x's dtype,
    aux_loss f32 scalar).  With a data-parallel ``ctx`` the pick fractions
    f are the global batch's (the mean of the ranks', which hold equal
    token counts) and the mean router probabilities this rank's: the ranks'
    losses average to the global batch's, and so do their gradients (f,
    taken from top-k ids, has none).

    ``jax.lax.top_k`` breaks ties toward the lower index and ``torch.topk``
    promises no order; the two agree wherever the probabilities differ."""
    logits = x.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, cfg.top_k, dim=-1)
    weights = weights / torch.clamp(weights.sum(dim=-1, keepdim=True),
                                    min=1e-9)
    # Switch-transformer load-balance loss: E * sum_e f_e * P_e / k, with
    # f_e the fraction of (token, rank) picks that went to expert e
    e = cfg.num_experts
    f = F.one_hot(ids.reshape(-1, cfg.top_k), e).float().mean(dim=0).sum(0)
    if ctx is not None and ctx.dp > 1:
        f = ctx.allsum(f) / ctx.dp
    pbar = probs.reshape(-1, e).mean(dim=0)
    aux = e * torch.sum(f * pbar) / cfg.top_k
    return ids, weights.to(x.dtype), aux


def _expert_ffn(p: dict, cfg: ModelConfig, x_e: torch.Tensor,
                gmm=moe_gmm, expanded: bool = False) -> torch.Tensor:
    """Batched-over-experts FFN. x_e: (E, T, d), or with ``expanded`` the
    (T, d) tokens that every expert reads -> (E, T, d); three grouped
    products (etd,edf->etf twice, etf,efd->etd), by K5 (``gmm``: its plain
    version for a reference)."""
    g = gmm(x_e, p["w_gate"], expanded=expanded)
    u = gmm(x_e, p["w_up"], expanded=expanded)
    act = F.silu if cfg.ffn_act == "swiglu" else _gelu  # repro moe.py:90
    return gmm(act(g) * u, p["w_down"])


def moe_dense(p: dict, cfg: ModelConfig, x: torch.Tensor, ctx=None,
              gmm=moe_gmm) -> Tuple[torch.Tensor, torch.Tensor]:
    """Computes every expert for every token, masks by routing weight.
    Exact (no capacity drops).  ``gmm``: the expert products (K5; its plain
    version for a reference)."""
    ids, weights, aux = route(p, cfg, x, ctx)
    shp = x.shape
    xt = x.reshape(-1, shp[-1])
    e = cfg.num_experts
    # every expert reads the same tokens: K5 takes them as a view of expert
    # stride 0, and its gradient sums over the experts, never materialized
    y_all = _expert_ffn(p, cfg, xt, gmm=gmm, expanded=True)
    w_full = torch.zeros((xt.shape[0], e), dtype=x.dtype, device=x.device)
    w_full.scatter_(1, ids.reshape(-1, cfg.top_k),
                    weights.reshape(-1, cfg.top_k))
    y = torch.einsum("te,etd->td", w_full, y_all)
    y = y + _shared(p, cfg, xt, ctx)
    return y.reshape(shp), aux


def _shared(p: dict, cfg: ModelConfig, xt: torch.Tensor,
            ctx=None) -> torch.Tensor:
    """The shared experts' FFN of ``xt`` (..., d) (zeros without them); on
    a model axis that splits their hidden dim (``tp_layout``'s
    ``shared``) a column / row split summed over the model ranks, as
    ``param_specs`` splits them (``ffn_col``/``ffn_row``)."""
    if "shared" not in p:
        return torch.zeros_like(xt)
    lay = tp_layout(cfg, ctx)
    return ffn_apply(p["shared"], xt, cfg.ffn_act,
                     ctx if lay is not None and lay.shared else None)


# ---------------------------------------------------------------------------
# Capacity-based dispatch helpers
# ---------------------------------------------------------------------------


def _slots(ids_flat: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Position of each (token, choice) within its expert's capacity queue:
    how many earlier dispatches of ``ids_flat`` (M,) target the same
    expert.  Returns (M,) slot indices (0-based)."""
    one_hot = F.one_hot(ids_flat, num_experts)
    cum = torch.cumsum(one_hot, dim=0) - one_hot  # exclusive
    return torch.gather(cum, 1, ids_flat[:, None])[:, 0]


def capacity_for(tokens: int, top_k: int, num_experts: int,
                 factor: float) -> int:
    """Slots an expert takes from one shard of ``tokens`` tokens: the mean
    load times ``factor``, rounded up to a multiple of 4, at least 4."""
    c = math.ceil(tokens * top_k / num_experts * factor)
    return max(4, ((c + 3) // 4) * 4)


def _dispatch(xt: torch.Tensor, k: int, index, shape) -> torch.Tensor:
    """(t, d) tokens, each repeated for its k choices in token-major order,
    scattered into a zero buffer of ``shape + (d,)`` at ``index``; rows
    sent to slot ``capacity`` (the last, overflow row) are dropped with it
    by the caller."""
    buf = xt.new_zeros((*shape, xt.shape[1]))
    return buf.index_put(index, xt.repeat_interleave(k, dim=0))


def _combine(y: torch.Tensor, index, w_f, ok, t: int, k: int):
    """Each dispatch's expert output, weighted (zero where dropped), summed
    over a token's k choices: (t, d).  ``y``'s last slot row is zero."""
    y_tok = y[index] * (w_f * ok)[:, None]
    return y_tok.reshape(t, k, -1).sum(dim=1)


def _pad_slot(y: torch.Tensor) -> torch.Tensor:
    """A zero row appended on the slot dim (-2): where dropped dispatches
    read."""
    pad = y.new_zeros((*y.shape[:-2], 1, y.shape[-1]))
    return torch.cat([y, pad], dim=-2)


# ---------------------------------------------------------------------------
# The sequence split over the model axis (differentiable)
# ---------------------------------------------------------------------------


def _seq_slice(x: torch.Tensor, ctx) -> torch.Tensor:
    s = x.shape[1] // ctx.tp
    return x[:, ctx.model_rank * s:(ctx.model_rank + 1) * s]


def _seq_gather(x: torch.Tensor, ctx) -> torch.Tensor:
    """Every model rank's (B, S/tp, ...) slice, concatenated on dim 1."""
    got = prim.ring_all_gather(x.contiguous(), ctx.model_group)
    return got.movedim(0, 1).flatten(1, 2)


class _SeqSplit(torch.autograd.Function):
    """This model rank's slice of the sequence of (x, routing weights),
    every model rank holding the whole; its backward all-gathers the
    slices' gradients, so every rank ends with the whole gradient
    (Megatron's sequence-parallel scatter)."""

    @staticmethod
    def forward(ctx, x, weights, pctx):
        ctx.pctx = pctx
        return _seq_slice(x, pctx), _seq_slice(weights, pctx)

    @staticmethod
    def backward(ctx, gx, gw):
        return (_seq_gather(gx, ctx.pctx), _seq_gather(gw, ctx.pctx), None)


class _SeqGather(torch.autograd.Function):
    """The inverse pair: all-gather of the slices' outputs forward, this
    rank's slice of the gradient backward."""

    @staticmethod
    def forward(ctx, y, pctx):
        ctx.pctx = pctx
        return _seq_gather(y, pctx)

    @staticmethod
    def backward(ctx, g):
        return _seq_slice(g, ctx.pctx).contiguous(), None


# ---------------------------------------------------------------------------
# Expert-parallel train / prefill path
# ---------------------------------------------------------------------------


def _ep_train_body(xt, ids, weights, p, *, cfg: ModelConfig, ctx,
                   capacity: int) -> torch.Tensor:
    """This rank's shard: xt (T_local, d); ids/weights (T_local, k); p's
    w_* this rank's experts (E_local, ...).  Returns (T_local, d)."""
    tp = ctx.tp
    e_local = p["w_gate"].shape[0]
    t, d = xt.shape
    k = cfg.top_k
    m = t * k

    ids_f = ids.reshape(m)
    w_f = weights.reshape(m)
    dest = ids_f // e_local          # destination shard on the EP axis
    le = ids_f % e_local             # local expert id on that shard
    # slot within (dest, le) capacity queue; same expert id => same queue
    slot = _slots(ids_f, cfg.num_experts)
    ok = slot < capacity
    slot_c = torch.where(ok, slot, capacity)  # the overflow row, dropped
    index = (dest, le, slot_c)
    buf = _dispatch(xt, k, index, (tp, e_local, capacity + 1))
    buf = buf[:, :, :capacity].contiguous()

    # ---- All-to-All #1: tokens -> expert shards ----
    recv = prim.AllToAll.apply(buf, ctx.model_group) if tp > 1 else buf
    # recv: (tp, E_local, C, d), dim0 = source shard
    h = recv.transpose(0, 1).reshape(e_local, tp * capacity, d)
    y = _expert_ffn(p, cfg, h)
    y = y.reshape(e_local, tp, capacity, d).transpose(0, 1).contiguous()

    # ---- All-to-All #2: results -> source shards ----
    back = prim.AllToAll.apply(y, ctx.model_group) if tp > 1 else y
    return _combine(_pad_slot(back), index, w_f, ok, t, k)


def _check_experts(p: dict, cfg: ModelConfig, ctx, ff_split: int) -> None:
    """The expert weights must be this rank's part: E/tp experts, the ffn
    dim over ``ff_split`` ranks (``parallel.shard_params``; a
    weight-stationary context's experts serve ``moe_ep_decode_ws``
    only)."""
    want = (cfg.num_experts // ctx.tp,
            (cfg.moe_d_ff or cfg.d_ff) // ff_split)
    got = (p["w_gate"].shape[0], p["w_gate"].shape[2])
    if got != want:
        raise ValueError(f"expert weights of (experts, ffn) {got}, want "
                         f"{want} on this mesh (parallel.shard_params)")


def moe_ep_train(p: dict, cfg: ModelConfig, x: torch.Tensor, ctx,
                 capacity_factor: float = 1.25
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B/dp, S, d), this rank's data shard, replicated over the model
    axis.  Each model rank takes its S/tp of the sequence; experts live on
    the model ranks; two All-to-Alls per MoE layer (dispatch + combine).
    Returns (y (B/dp, S, d), aux), the same on every model rank."""
    ids, weights, aux = route(p, cfg, x, ctx)
    b, s, d = x.shape
    if s % ctx.tp:
        raise ValueError(f"a sequence of {s} does not split over a model "
                         f"axis of {ctx.tp}")
    t_local = b * (s // ctx.tp)
    capacity = capacity_for(t_local, cfg.top_k, cfg.num_experts,
                            capacity_factor)
    _check_experts(p, cfg, ctx, 1)
    if ctx.tp > 1:
        x_l, w_l = _SeqSplit.apply(x, weights, ctx)
        ids_l = _seq_slice(ids, ctx)
    else:
        x_l, w_l, ids_l = x, weights, ids
    y = _ep_train_body(x_l.reshape(t_local, d),
                       ids_l.reshape(t_local, cfg.top_k),
                       w_l.reshape(t_local, cfg.top_k), p,
                       cfg=cfg, ctx=ctx, capacity=capacity)
    y = y.reshape(x_l.shape)
    if ctx.tp > 1:
        y = _SeqGather.apply(y, ctx)
    y = y + _shared(p, cfg, x.reshape(-1, d), ctx).reshape(x.shape)
    return y, aux


def moe_ep_train_ref(p: dict, cfg: ModelConfig, x: torch.Tensor, tp: int,
                     capacity_factor: float = 1.25, dp: int = 1):
    """The plain single-process version of ``moe_ep_train`` on a (dp, tp)
    mesh, with every expert's weights: the same shards, slots and capacity
    drops, the expert products one expert at a time in plain PyTorch
    (``moe_gmm_ref``, on the card too), no communication.
    x: (B, S, d), the global batch.  Returns (y, aux, the share of the
    (token, choice) dispatches dropped)."""
    ids, weights, aux = route(p, cfg, x)
    b, s, d = x.shape
    k = cfg.top_k
    bl, sl = b // dp, s // tp
    capacity = capacity_for(bl * sl, k, cfg.num_experts, capacity_factor)
    y = torch.empty_like(x)
    dropped = 0
    for i in range(dp):
        for j in range(tp):
            rows, cols = slice(i * bl, (i + 1) * bl), slice(j * sl,
                                                            (j + 1) * sl)
            xt = x[rows, cols].reshape(-1, d)
            ids_f = ids[rows, cols].reshape(-1)
            w_f = weights[rows, cols].reshape(-1)
            ok = _slots(ids_f, cfg.num_experts) < capacity
            dropped += int((~ok).sum())
            x_rep = xt.repeat_interleave(k, dim=0)
            out = torch.zeros_like(x_rep)
            for e in range(cfg.num_experts):
                sel = (ids_f == e) & ok
                if bool(sel.any()):
                    one = {n: p[n][e:e + 1] for n in ("w_gate", "w_up",
                                                      "w_down")}
                    out[sel] = _expert_ffn(one, cfg, x_rep[sel][None],
                                           gmm=moe_gmm_ref)[0]
            y_tok = out * (w_f * ok)[:, None]
            y[rows, cols] = y_tok.reshape(bl, sl, k, d).sum(dim=2)
    y = y + _shared(p, cfg, x.reshape(-1, d)).reshape(x.shape)
    return y, aux, dropped / ids.numel()


# ---------------------------------------------------------------------------
# Expert-parallel decode paths
# ---------------------------------------------------------------------------


def _ep_decode_body(xt, ids, weights, p, *, cfg: ModelConfig, rank: int,
                    capacity: int) -> torch.Tensor:
    """Every token on this rank; it computes only its own experts for the
    tokens routed to them (the ffn dim, weight-stationary, its slice of
    it): this rank's term of the output, (T, d), before the sums."""
    e_local = p["w_gate"].shape[0]
    t, d = xt.shape
    k = cfg.top_k
    m = t * k
    ids_f = ids.reshape(m)
    w_f = weights.reshape(m)
    le = ids_f - rank * e_local
    mine = (le >= 0) & (le < e_local)
    slot = _slots(ids_f, cfg.num_experts)
    ok = mine & (slot < capacity)
    le_c = torch.where(ok, le, 0)
    slot_c = torch.where(ok, slot, capacity)
    index = (le_c, slot_c)
    h = _dispatch(xt, k, index, (e_local, capacity + 1))[:, :capacity]
    y = _expert_ffn(p, cfg, h)
    return _combine(_pad_slot(y), index, w_f, ok, t, k)


def moe_ep_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, ctx,
                  capacity_factor: float = 4.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B_local, 1, d), this rank's tokens, replicated over the model
    axis: its 1/dp of the batch, or the whole batch where dp does not
    divide it (the JAX package replicates it then; the path is the same).
    Combine is an All-Reduce over the model axis (the ported ring: the same
    bits on every rank).

    The router loss is that of this rank's tokens alone, with no sum over
    the data ranks: decode discards it (``transformer._decode_layer``), as
    the JAX package's jitted decode drops its sum as dead code.  It is the
    JAX function's where the rank holds the whole batch."""
    _check_experts(p, cfg, ctx, 1)
    ids, weights, aux = route(p, cfg, x)
    b, s, d = x.shape
    t = b * s
    capacity = capacity_for(t, cfg.top_k, cfg.num_experts, capacity_factor)
    y = _ep_decode_body(x.reshape(t, d), ids.reshape(t, cfg.top_k),
                        weights.reshape(t, cfg.top_k), p, cfg=cfg,
                        rank=ctx.model_rank, capacity=capacity)
    if ctx.tp > 1:
        y = prim.ring_all_reduce(y, ctx.model_group)
    y = y.reshape(x.shape) + _shared(p, cfg, x.reshape(-1, d),
                                     ctx).reshape(x.shape)
    return y, aux


def moe_ep_decode_ws(p: dict, cfg: ModelConfig, x: torch.Tensor, ctx,
                     capacity_factor: float = 4.0, *,
                     whole_batch: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weight-stationary decode: the experts' ffn dim stays sharded over
    the data ranks ((E/tp, d, ff/dp) a rank), the tokens are replicated
    over every axis (a rank holding its 1/dp of the batch gathers the
    rest first, in one exchange; ``whole_batch``: every rank holds all of
    it already, the JAX package's decode of a batch that dp does not
    divide), each rank computes its experts' ffn-slice partial, and two
    ring all-reduces (model: the experts, data: the ffn partials) replace
    the weight gathers.  x and the router loss as ``moe_ep_decode``'s."""
    _check_experts(p, cfg, ctx, ctx.dp)
    ids, weights, aux = route(p, cfg, x)
    b, s, d = x.shape
    t, k = b * s, cfg.top_k
    xt, ids_t, w_t = x.reshape(t, d), ids.reshape(t, k), weights.reshape(t, k)
    gather = ctx.dp > 1 and not whole_batch
    if gather:
        xt, ids_t, w_t = _gather_rows(ctx.group, xt, ids_t, w_t)
    capacity = capacity_for(xt.shape[0], k, cfg.num_experts,
                            capacity_factor)
    out = _ep_decode_body(xt, ids_t, w_t, p, cfg=cfg, rank=ctx.model_rank,
                          capacity=capacity)
    if ctx.tp > 1:
        out = prim.ring_all_reduce(out, ctx.model_group)  # combine experts
    if ctx.dp > 1:
        out = prim.ring_all_reduce(out, ctx.group)  # combine ffn partials
    if gather:
        out = out[ctx.rank * t:(ctx.rank + 1) * t]
    y = out.reshape(x.shape) + _shared(p, cfg, x.reshape(-1, d),
                                       ctx).reshape(x.shape)
    return y, aux


def _gather_rows(group, *parts: torch.Tensor) -> List[torch.Tensor]:
    """``ring_all_gather`` over ``group`` of tensors with the same rows, in
    one exchange: each row's bytes packed side by side, split again after.
    Returns each gathered, (p * rows, ...) in rank order."""
    rows = parts[0].shape[0]
    packed = torch.cat([v.contiguous().view(rows, -1).view(torch.uint8)
                        for v in parts], dim=1)
    got = prim.ring_all_gather(packed, group).flatten(0, 1)
    out, at = [], 0
    for v in parts:
        n = v.numel() // rows * v.element_size()
        out.append(got[:, at:at + n].contiguous().view(v.dtype)
                   .reshape(-1, *v.shape[1:]))
        at += n
    return out


# ---------------------------------------------------------------------------
# Unified entry point
# ---------------------------------------------------------------------------


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *, ctx=None,
              decode: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, aux_loss).  ``ctx``: a ``parallel.ParallelCtx`` or ``None``;
    without expert parallelism (``ctx.use_ep``) every rank runs
    ``moe_dense`` on its own tokens, else ``moe_ep_train`` (training and
    prefill), ``moe_ep_decode`` or, with ``ctx.ep_weight_stationary``,
    ``moe_ep_decode_ws`` (``decode=True``), at the context's capacity
    factors."""
    if ctx is None or not ctx.use_ep:
        return moe_dense(p, cfg, x, ctx)
    if decode:
        if ctx.ep_weight_stationary:
            return moe_ep_decode_ws(p, cfg, x, ctx,
                                    ctx.decode_capacity_factor)
        return moe_ep_decode(p, cfg, x, ctx, ctx.decode_capacity_factor)
    return moe_ep_train(p, cfg, x, ctx, ctx.capacity_factor)
