"""AdamW with global-norm clipping, on the port's parameter layout.

Port of ``repro.optim.adamw``: the optimizer state is {"m", "v", "step"},
m and v f32 trees shaped like the parameters (nested dicts and the
``params["layers"]`` list), step a 0-d int32 tensor.  Written as plain
functions (not ``torch.optim.AdamW``, and not ``clip_grad_norm_``, which
divides by norm + 1e-6): the clip scale is min(1, clip / max(|g|, 1e-9)),
the bias corrections use the incremented step, the update reads p as f32
and casts back to p's dtype.  Unlike the JAX package, parameters and
moments are updated in place (at full width that saves a copy of every
parameter and both moments); the functions still return them.

Under ZeRO-1 (``init_opt_state(params, ctx)``) m and v are flat f32 shards,
this rank's chunks of ``repro_torch.parallel.FlatLayout``;
``adamw_shard_update`` runs the same per-element arithmetic on a shard, and
``gather_opt_state`` returns the full moments in the port's layout.  Under
expert or tensor parallelism a rank's parameters, and so its m and v, hold
only its part of the leaves split over the model axis (its experts, its
blocks: ``parallel.shard_params``); the global norm counts the replicated
leaves once and sums the split leaves' squares over the model ranks.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.types import TrainConfig
from repro_torch.core.tree import param_leaves, tree_map
from repro_torch.parallel.planner import ParallelCtx, flat_layout


def init_opt_state(params: Any, ctx: Optional[ParallelCtx] = None
                   ) -> Dict[str, Any]:
    """Zero moments in f32 on each parameter's device, step 0, shaped like
    this rank's parameters (its part of the split leaves, under expert or
    tensor parallelism).
    With a ``ctx`` (ZeRO-1) m and v are this rank's flat shards of
    ``flat_layout(param_leaves(params), ctx)``: 1/dp of the state."""
    device = next(param_leaves(params)).device
    step = torch.zeros((), dtype=torch.int32, device=device)
    if ctx is not None:
        n = flat_layout(list(param_leaves(params)), ctx).shard_numel
        return {"m": torch.zeros(n, dtype=torch.float32, device=device),
                "v": torch.zeros(n, dtype=torch.float32, device=device),
                "step": step}

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": step}


def gather_opt_state(state: Dict[str, Any], ctx: ParallelCtx, params: Any
                     ) -> Dict[str, Any]:
    """The full m and v of a ZeRO-1 state, gathered from every data rank
    into the port's layout (trees shaped like ``params``, this rank's,
    which give the layout; under expert or tensor parallelism its part of
    the split leaves: ``parallel.gather_params`` gathers those): for
    checkpoints and tests.
    Every rank of the data group calls it and gets the same trees."""
    leaves = list(param_leaves(params))
    layout = flat_layout(leaves, ctx)
    out = {"step": state["step"]}
    for name in ("m", "v"):
        flat = iter(layout.unflatten(layout.all_gather(state[name],
                                                       ctx.group)))
        out[name] = tree_map(lambda _: next(flat), params)
    return out


def global_norm(tree, *, acc: torch.dtype = torch.float64,
                ctx: Optional[ParallelCtx] = None,
                split: Optional[Sequence[bool]] = None,
                sharded: bool = False) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, returned in f32.  Each
    leaf's norm accumulates in ``acc``, f64 by default: a departure from
    the JAX package, whose norm is f32 throughout.  PyTorch's f32 norm on
    the CPU drifts with the leaf's size (about 2e-4 on the 4.4M-value MLP
    matrices of a qwen2-0.5b step's first moments, 1e-4 in their global
    norm; ``chip_smoke.py``'s ``train_parity`` line measures it on the
    host), where the card's reductions stay within a few ulps, so the same
    step on the card and on the host would clip differently.  At the
    sizes of the JAX comparisons both accumulations agree with JAX's f32
    norm within 1e-5 (``tests/test_torch_train.py``).

    ``split``: one flag a leaf, set where the leaf is this model rank's
    part of a leaf split over the model axis (``parallel.model_flags``):
    those squares are summed over ``ctx``'s model ranks, the other leaves'
    (the same on every model rank) counted once.  ``sharded``: the leaves are this rank's
    ZeRO-1 shard, and the sum is taken over ``ctx``'s data ranks too."""
    leaves = tree if isinstance(tree, list) else list(param_leaves(tree))
    norms = torch.stack([_norm(t, acc) for t in leaves])
    if split is not None and ctx is not None and ctx.tp > 1:
        mask = torch.tensor(split, device=norms.device)
        squares = norms[~mask].square().sum() + ctx.model_allsum(
            norms[mask].square().sum())
    else:
        squares = norms.square().sum()
    if sharded:  # each rank's sum, then theirs
        squares = ctx.allsum(squares)
    return squares.sqrt().to(torch.float32)


# values of one piece of the update: the update holds four f32 temporaries
# of its piece (the clipped gradient, the denominator, the update, the
# parameters as f32), so a whole leaf at full width would not fit beside
# the state (dbrx-132b's embedding: 617M values, 9.9 GB of temporaries)
UPDATE_CHUNK = 1 << 26


def _norm(t: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """|t| accumulated in ``acc``; a leaf above ``UPDATE_CHUNK`` values in
    pieces of that many (the cast to ``acc`` copies its input), their
    squares summed."""
    if t.numel() <= UPDATE_CHUNK:
        return torch.linalg.vector_norm(t, dtype=acc)
    flat = t.reshape(-1)
    return torch.stack([torch.linalg.vector_norm(flat[a:a + UPDATE_CHUNK],
                                                 dtype=acc)
                        for a in range(0, flat.numel(), UPDATE_CHUNK)]
                       ).square().sum().sqrt()


def _pieces(flat_p, flat_g, m, v):
    """The update's work in groups of (p, g, m, v) of at most about
    ``UPDATE_CHUNK`` values: small leaves together, a larger leaf whose
    p, m and v are contiguous in flat slices (the arithmetic is per
    element, so the result does not depend on the cut)."""
    group, size = [], 0
    for p, g, mm, vv in zip(flat_p, flat_g, m, v):
        n = p.numel()
        if n > UPDATE_CHUNK and p.is_contiguous() and mm.is_contiguous() \
                and vv.is_contiguous():
            pf, gf, mf, vf = (p.view(-1), g.reshape(-1), mm.view(-1),
                              vv.view(-1))
            for a in range(0, n, UPDATE_CHUNK):
                cut = slice(a, a + UPDATE_CHUNK)
                yield [(pf[cut], gf[cut], mf[cut], vf[cut])]
            continue
        if group and size + n > UPDATE_CHUNK:
            yield group
            group, size = [], 0
        group.append((p, g, mm, vv))
        size += n
    if group:
        yield group


def _updates(flat_p: List[torch.Tensor], flat_g: Sequence[torch.Tensor],
             m: List[torch.Tensor], v: List[torch.Tensor],
             gnorm: torch.Tensor, step: torch.Tensor, tcfg: TrainConfig,
             lr: torch.Tensor
             ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Advances m and v in place and returns (p32, u): the parameters read
    as f32 and the updates, the new parameters being p32 - u: AdamW on the
    clipped gradient."""
    scale = torch.clamp(tcfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1, b2 = tcfg.beta1, tcfg.beta2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)
    g = torch._foreach_mul([t.float() for t in flat_g], scale)
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, g, alpha=1 - b1)
    torch._foreach_mul_(v, b2)
    torch._foreach_addcmul_(v, g, g, value=1 - b2)
    del g
    den = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, tcfg.eps)
    update = torch._foreach_div(m, bc1)
    torch._foreach_div_(update, den)
    del den
    p32 = [p.float() for p in flat_p]
    torch._foreach_add_(update, p32, alpha=tcfg.weight_decay)
    torch._foreach_mul_(update, lr)
    return p32, update


def adamw_update(params: Any, grads: Any, state: Dict[str, Any],
                 tcfg: TrainConfig, lr: torch.Tensor,
                 ctx: Optional[ParallelCtx] = None,
                 split: Optional[Sequence[bool]] = None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One clipped AdamW step.  ``grads``: a tree like ``params``, or the
    list of its leaves in order.  Updates params, m and v in place and
    returns (params, state, {"grad_norm": the norm before clipping}).
    ``ctx``, ``split``: a model-parallel rank's (``global_norm``)."""
    flat_p = list(param_leaves(params))
    flat_g: Sequence[torch.Tensor] = grads if isinstance(grads, list) \
        else list(param_leaves(grads))
    m, v = list(param_leaves(state["m"])), list(param_leaves(state["v"]))
    gnorm = global_norm(flat_g, ctx=ctx, split=split)
    step = state["step"] + 1
    with torch.no_grad():
        for group in _pieces(flat_p, flat_g, m, v):
            ps, gs, ms, vs = (list(t) for t in zip(*group))
            p32, update = _updates(ps, gs, ms, vs, gnorm, step, tcfg, lr)
            for p, p_f, u in zip(ps, p32, update):
                p.copy_(p_f - u)  # cast back to p's dtype
            del p32, update
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    return params, new_state, {"grad_norm": gnorm}


def adamw_shard_update(p_shard: torch.Tensor, g_shard: torch.Tensor,
                       state: Dict[str, Any], tcfg: TrainConfig,
                       lr: torch.Tensor, ctx: ParallelCtx,
                       split_ranges: Sequence[Tuple[int, int]] = ()
                       ) -> Tuple[torch.Tensor, Dict[str, Any],
                                  Dict[str, torch.Tensor]]:
    """One clipped AdamW step on this rank's ZeRO-1 shard: ``p_shard`` the
    parameters' chunks as f32, ``g_shard`` the reduced gradient's, m and v
    of ``state`` the moments' (updated in place).  The clip reads the
    global norm, summed over the ranks; ``split_ranges``, the ranges of
    the shard that hold this model rank's part of the split leaves
    (``FlatLayout.shard_ranges``), summed over the model ranks too.
    Returns (the updated parameter chunks in f32, state, {"grad_norm"})."""
    if split_ranges:
        pieces, flags = _cut(g_shard, split_ranges)
        gnorm = global_norm(pieces, ctx=ctx, split=flags, sharded=True)
    else:
        gnorm = global_norm([g_shard], ctx=ctx, sharded=True)
    step = state["step"] + 1
    with torch.no_grad():
        (p32,), (u,) = _updates([p_shard], [g_shard], [state["m"]],
                                [state["v"]], gnorm, step, tcfg, lr)
        new = p32 - u
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    return new, new_state, {"grad_norm": gnorm}


def _cut(flat: torch.Tensor, ranges: Sequence[Tuple[int, int]]
         ) -> Tuple[List[torch.Tensor], List[bool]]:
    """``flat`` cut at the [start, stop) ``ranges`` (sorted, disjoint):
    the pieces in order, and for each whether it is one of the ranges."""
    pieces, flags, at = [], [], 0
    for a, b in ranges:
        if a > at:
            pieces.append(flat[at:a])
            flags.append(False)
        pieces.append(flat[a:b])
        flags.append(True)
        at = b
    if at < flat.numel():
        pieces.append(flat[at:])
        flags.append(False)
    return pieces, flags
