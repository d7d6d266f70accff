"""Pipeline parallelism: a runnable GPipe stage pipeline and PTD-P's
interleaved schedule, with their analytics (port of
``repro.parallel.pipeline``, paper Sec. III-A).

Each rank of a process group (``group``, ``None`` for the default one) is
one pipeline stage, as each device of the JAX package's ``pipe`` mesh
axis is; stage boundaries are point-to-point sends, one
``ccl.primitives._permute`` a tick, so the port's counters see them.  The
JAX package runs every tick on every device under masks and gets the
backward from autodiff through the ``ppermute`` chain; here the schedule
(``schedule``) is computed on the host, a rank runs only its own work,
and ``_Pipeline``, a ``torch.autograd.Function``, runs the backward
schedule: the ticks in reverse, each stage's gradient from its saved
graph, the input gradients sent back along the reverse permutes.

The outputs of the last stage are summed over the ranks at the end (the
reference's ``psum``, a broadcast since only that stage holds them), so
every rank returns them all; as with ``parallel.tensor.reduce_from_model``
what follows is taken to be replicated, and the gradient of the outputs is
each rank's own copy of the one loss's.  A stage's parameter gradients are
its own; the input's, where it needs one, is summed over the ranks.

The analytic model reproduces PTD-P's central claim: with m microbatches
and interleave factor v the bubble shrinks from (p-1)/m to (p-1)/(m v), at
the cost of v times more boundary traffic.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from repro_torch.ccl import primitives as prim
from repro_torch.core.tree import param_leaves, tree_map

# ---------------------------------------------------------------------------
# Analytics (PTD-P Sec. 2.2)
# ---------------------------------------------------------------------------


def bubble_fraction(p: int, m: int, v: int = 1) -> float:
    """Fraction of the iteration spent idle in the pipeline bubble."""
    return (p - 1) / (m * v)


def iteration_time(p: int, m: int, v: int, t_chunk: float,
                   t_comm: float = 0.0) -> float:
    """1F1B schedule makespan: (m*v + p - 1) chunk slots of t_chunk, plus
    per-boundary comm (v times more boundaries when interleaved)."""
    slots = m * v + (p - 1)
    return slots * (t_chunk / v) + m * v * t_comm


# ---------------------------------------------------------------------------
# The schedule
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Job:
    """One stage's work at one tick: microbatch ``mb`` through the rank's
    ``chunk``; ``inject``: its input is the microbatch itself (stage 0),
    else what the left neighbour sent; ``done``: its output is the
    pipeline's (else it goes to the right neighbour)."""

    mb: int
    chunk: int
    inject: bool
    done: bool


def schedule(p: int, m: int, v: int = 1) -> List[List[Optional[Job]]]:
    """The ticks of the reference's schedules, each a ``Job`` (or
    ``None``: idle) per rank.  Virtual stage k runs on rank k % p with
    chunk k // p; an activation hops right every tick and is done after
    v p stages.  Rank 0 injects the next microbatch whenever it receives
    nothing (injections stall while a returning activation occupies it).
    With v = 1 this is GPipe: rank 0 injects microbatch t at tick t and
    the last stage finishes microbatch t - (p - 1)."""
    total = v * p
    held: List[Optional[tuple]] = [None] * p  # (mb, virtual stage)
    injected = finished = 0
    ticks = []
    while finished < m:
        row: List[Optional[Job]] = [None] * p
        sent: List[Optional[tuple]] = [None] * p
        for d in range(p):
            if d == 0 and injected < m and held[0] is None:
                (mb, vs), inject = (injected, 0), True
                injected += 1
            elif held[d] is not None:
                (mb, vs), inject = held[d], False
            else:
                continue
            done = vs + 1 == total
            row[d] = Job(mb, vs // p, inject, done)
            if done:
                finished += 1
            else:
                sent[d] = (mb, vs + 1)
        ticks.append(row)
        held = [sent[(d - 1) % p] for d in range(p)]
    return ticks


def _sends(row, p: int, backward: bool) -> list:
    """The permute after a tick: forward, each job not done to the right;
    backward, each job that received its input back to the left."""
    if backward:
        return [(d, (d - 1) % p) for d, job in enumerate(row)
                if job is not None and not job.inject]
    return [(d, (d + 1) % p) for d, job in enumerate(row)
            if job is not None and not job.done]


# ---------------------------------------------------------------------------
# The runnable pipeline
# ---------------------------------------------------------------------------


class _Pipeline(torch.autograd.Function):
    """The forward schedule, each stage's graph kept per tick (GPipe's
    memory), and the backward schedule in reverse."""

    @staticmethod
    def forward(ctx, stage_fn, chunk_of, params, group, v, x_mb, *leaves):
        me, p = prim._rank_size(group)
        ticks = schedule(p, x_mb.shape[0], v)
        mine = [t.detach().requires_grad_(t.requires_grad) for t in leaves]
        it = iter(mine)
        tree = tree_map(lambda _: next(it), params)
        template = torch.zeros_like(x_mb[0])
        outs = torch.zeros_like(x_mb)
        saved = []
        recv = None
        for row in ticks:
            job = row[me]
            y = None
            if job is not None:
                x = x_mb[job.mb] if job.inject else recv
                x = x.detach().requires_grad_(True)
                with torch.enable_grad():
                    y = stage_fn(chunk_of(tree, job.chunk), x)
                saved.append((x, y))
                if job.done:
                    outs[job.mb] = y.detach()
            perm = _sends(row, p, backward=False)
            got = prim._permute(
                [y.detach() if y is not None and not job.done else template],
                perm, group)
            recv = got[0] if got is not None else None
        ctx.state = (ticks, saved, mine, group, x_mb.shape)
        return prim.ring_all_reduce(outs, group)

    @staticmethod
    def backward(ctx, g):
        ticks, saved, mine, group, shape = ctx.state
        me, p = prim._rank_size(group)
        grads = [torch.zeros_like(t) for t in mine]
        gx_mb = torch.zeros(shape, dtype=g.dtype, device=g.device)
        template = torch.zeros_like(g[0])
        wants = [t.requires_grad for t in mine]
        recv = None
        for row in reversed(ticks):
            job = row[me]
            gx = None
            if job is not None:
                x, y = saved.pop()
                gy = g[job.mb] if job.done else recv
                inputs = [x] + [t for t, w in zip(mine, wants) if w]
                got = torch.autograd.grad(y, inputs, gy, allow_unused=True)
                gx = got[0]
                at = iter(got[1:])
                for i, w in enumerate(wants):
                    if w:
                        gi = next(at)
                        if gi is not None:
                            grads[i] += gi
                if job.inject:
                    gx_mb[job.mb] += gx
            perm = _sends(row, p, backward=True)
            send = gx if job is not None and not job.inject else template
            got = prim._permute([send], perm, group)
            recv = got[0] if got is not None else None
        ctx.state = None
        gx_mb = prim.ring_all_reduce(gx_mb, group) \
            if ctx.needs_input_grad[5] else None
        return (None, None, None, None, None, gx_mb,
                *[gr if w else None for gr, w in zip(grads, wants)])


def _run(stage_fn: Callable, params, chunk_of, x_mb: torch.Tensor, group,
         v: int) -> torch.Tensor:
    leaves = list(param_leaves(params))
    return _Pipeline.apply(stage_fn, chunk_of, params, group, v, x_mb,
                           *leaves)


def pipeline_apply(stage_fn: Callable, stage_params, x_mb: torch.Tensor,
                   group=None) -> torch.Tensor:
    """GPipe over the ranks of ``group``, rank i the i-th stage.

    stage_fn(params, x) -> x of the same shape; stage_params: this rank's
    stage parameters (a tensor or a tree of them); x_mb: (M, ...) the
    microbatches (read by stage 0).  Returns (M, ...), the last stage's
    outputs, on every rank."""
    return _run(stage_fn, stage_params, lambda tree, _: tree, x_mb, group,
                1)


def interleaved_pipeline_apply(stage_fn: Callable, chunk_params,
                               x_mb: torch.Tensor, group=None,
                               v: int = 2) -> torch.Tensor:
    """PTD-P's interleaved schedule over the ranks of ``group``: each rank
    holds ``v`` model chunks (every leaf of ``chunk_params`` stacked on a
    leading dim of v), virtual stage k runs on rank k % p with chunk
    k // p.  stage_fn(chunk_params_c, x) -> x; returns (M, ...) the
    outputs, on every rank."""
    return _run(stage_fn, chunk_params,
                lambda tree, c: tree_map(lambda a: a[c], tree), x_mb, group,
                v)


def make_pipeline_fn(stage_fn: Callable, group=None) -> Callable:
    """``pipeline_apply`` as a function of the stacked stage parameters
    (every leaf with a leading dim of the number of stages, the same on
    every rank) and the global microbatches (M, mb, ...): rank i runs
    stage i on its row, whose gradient is the only one it computes."""

    def global_fn(stage_params, x_mb):
        p = dist.get_world_size(group)
        me = dist.get_rank(group)
        for t in param_leaves(stage_params):
            if t.shape[0] != p:
                raise ValueError(f"stage parameters stacked over "
                                 f"{t.shape[0]} stages, the group has {p}")
        mine = tree_map(lambda a: a[me], stage_params)
        return pipeline_apply(stage_fn, mine, x_mb, group)

    return global_fn
