"""Mixture-of-Experts FFN, the single-device part.

Port of ``repro.models.moe``: routing (softmax -> top-k -> renormalize) with
the Switch-style load-balance loss, and the dense path ``moe_dense``, which
computes every expert on every token and masks by routing weight.  Its three
expert products (gate, up, down) run the hand-written grouped-GEMM kernel on
CUDA tensors and the plain einsum on the CPU; the wrapper decides by device.

The expert-parallel paths of the JAX package (``moe_ep_train``,
``moe_ep_decode``, ``moe_ep_decode_ws``) are not ported (ROADMAP item 10);
``moe_apply`` raises for a context that asks for expert parallelism.  Under
data parallelism (a ``ParallelCtx`` of dp > 1) each rank routes its own
tokens and the ranks share the fractions of the load-balance loss, so that
the ranks' losses add up to the loss of the global batch.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.types import ModelConfig
from repro_torch.kernels.moe_gmm.ops import moe_gmm
from repro_torch.models.modules import _gelu, dense_init, ffn_apply, init_ffn


def init_moe(cfg: ModelConfig, dtype, device,
             generator: torch.Generator) -> dict:
    d = cfg.d_model
    ff = cfg.moe_d_ff or cfg.d_ff
    e = cfg.num_experts

    def stack(in_dim, out_dim):
        return torch.stack([dense_init(in_dim, (out_dim,), dtype, device,
                                       generator) for _ in range(e)])

    p = {
        # f32 whatever the weights' dtype, as in the JAX package
        "router": dense_init(d, (e,), torch.float32, device, generator),
        "w_gate": stack(d, ff),
        "w_up": stack(d, ff),
        "w_down": stack(ff, d),
    }
    if cfg.num_shared_experts:
        p["shared"] = init_ffn(cfg, ff * cfg.num_shared_experts, dtype,
                               device, generator)
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


def _expert_ffn(p: dict, cfg: ModelConfig, x_e: torch.Tensor) -> torch.Tensor:
    """Batched-over-experts FFN. x_e: (E, T, d) -> (E, T, d); three grouped
    products (etd,edf->etf twice, etf,efd->etd)."""
    g = moe_gmm(x_e, p["w_gate"])
    u = moe_gmm(x_e, p["w_up"])
    act = F.silu if cfg.ffn_act == "swiglu" else _gelu  # repro moe.py:90
    return moe_gmm(act(g) * u, p["w_down"])


def moe_dense(p: dict, cfg: ModelConfig, x: torch.Tensor, ctx=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Computes every expert for every token, masks by routing weight.
    Exact (no capacity drops)."""
    ids, weights, aux = route(p, cfg, x, ctx)
    shp = x.shape
    xt = x.reshape(-1, shp[-1])
    e = cfg.num_experts
    # every expert reads the same tokens: an expanded view (expert stride 0),
    # never materialized
    y_all = _expert_ffn(p, cfg, xt.expand(e, *xt.shape))
    w_full = torch.zeros((xt.shape[0], e), dtype=x.dtype, device=x.device)
    w_full.scatter_(1, ids.reshape(-1, cfg.top_k),
                    weights.reshape(-1, cfg.top_k))
    y = torch.einsum("te,etd->td", w_full, y_all)
    y = y + _shared(p, cfg, xt)
    return y.reshape(shp), aux


def _shared(p: dict, cfg: ModelConfig, xt: torch.Tensor) -> torch.Tensor:
    if "shared" in p:
        return ffn_apply(p["shared"], xt, cfg.ffn_act)
    return torch.zeros_like(xt)


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *, ctx=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device MoE FFN, prefill and decode alike: (y, aux_loss).
    ``ctx`` asking for expert parallelism raises: the expert-parallel paths
    are not ported (ROADMAP item 10)."""
    if ctx is not None and getattr(ctx, "use_ep", False):
        raise NotImplementedError(
            "expert-parallel MoE (moe_ep_train / moe_ep_decode) is not "
            "ported yet: ROADMAP item 10")
    return moe_dense(p, cfg, x, ctx)
