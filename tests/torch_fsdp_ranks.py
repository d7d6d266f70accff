"""Rank functions of the port's FSDP tests (``tests/test_torch_fsdp.py``),
run by ``repro_torch.launch.ranks.spawn_ranks``: torch and the port only
(no jax), every function at top level."""
import numpy as np
import torch

from repro_torch.bridge import params_from_jax, params_to_jax_layout
from repro_torch.configs import smoke_config
from repro_torch.core.types import MeshConfig, TrainConfig
from repro_torch.launch.mesh import mesh_groups
from repro_torch.models import decode_step, forward, init_cache
from repro_torch.optim import gather_opt_state, init_opt_state
from repro_torch.parallel import make_ctx
from repro_torch.parallel.fsdp import _dim, fsdp_gather, fsdp_shard
from repro_torch.parallel.planner import _with_paths, shard_params, tp_cut
from repro_torch.serve import make_prefill
from repro_torch.serve.step import full_logits
from repro_torch.train import make_train_step
from torch_dp_ranks import flatten, nest


def _jax_layout(cfg, tree, ctx) -> dict:
    return flatten(params_to_jax_layout(cfg, tree, ctx))


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _grad_shards_err(cfg, full_grads, shards, ctx, params_full) -> float:
    """The largest difference between each FSDP gradient shard and its
    slice of the whole-batch gradient (the model rank's block, then the
    data rank's block of the FSDP dim)."""
    full = [tp_cut(path, g, cfg, ctx) if ctx.tp > 1 else g
            for (path, _), g in zip(_with_paths(params_full), full_grads)]
    worst = 0.0
    for (path, _), g, s in zip(_with_paths(params_full), full, shards):
        dim = _dim(ctx, path)
        if dim is not None:
            n = g.shape[dim] // ctx.dp
            g = g.narrow(dim, ctx.rank * n, n)
        worst = max(worst, _max_err(s, g) / max(1e-30, float(
            g.abs().max())))
    return worst


def fsdp_cases(rank: int, world: int, mesh_shape, inputs_path: str,
               cases: dict) -> dict:
    """Every FSDP case of ``tests/test_torch_fsdp.py`` on this rank of a
    (dp, tp) mesh.  ``inputs_path``: an .npz of the JAX package's initial
    parameters (``<arch>|<path>``) and the batch (``batch|tokens``,
    ``batch|labels``).  Per case: the FSDP step's metrics, its gradient
    shards against the whole-batch gradient, and the ZeRO-1 step's
    metrics; rank 0 adds both steps' parameters, m and v in the JAX
    layout; ``serve`` cases the prefill and decode logits against the
    single rank's."""
    data = np.load(inputs_path)
    mesh = MeshConfig(tuple(mesh_shape))
    dgroup, mgroup = mesh_groups(mesh)
    batch = {k: data[f"batch|{k}"] for k in ("tokens", "labels")}
    out = {}
    for name, case in cases.items():
        cfg = smoke_config(case["arch"])
        tree = nest({k.split("|", 1)[1]: data[k] for k in data.files
                     if k.startswith(case["arch"] + "|")})
        tcfg = TrainConfig(**case["tcfg"])
        res = out[name] = {}
        ctx = make_ctx(dgroup, mesh, model_group=mgroup, cfg=cfg,
                       remat=tcfg.remat, fsdp=True)
        if case.get("serve"):
            res.update(_serve(cfg, tree, ctx, batch["tokens"]))
            continue
        # the whole batch on one process: the reference gradient
        full = params_from_jax(cfg, tree, "cpu")
        seen: dict = {}
        make_train_step(cfg, tcfg)(
            full, init_opt_state(full), batch,
            grad_hook=lambda s, g: seen.setdefault("full", list(g)))
        params = fsdp_shard(params_from_jax(cfg, tree, "cpu", ctx=ctx), ctx)
        opt = init_opt_state(params)
        params, opt, metrics = make_train_step(cfg, tcfg, ctx)(
            params, opt, batch,
            grad_hook=lambda s, g: seen.__setitem__(s, list(g)))
        res["metrics"] = {k: float(v) for k, v in metrics.items()}
        res["grad_shard_err"] = _grad_shards_err(
            cfg, seen["full"], seen["synced"], ctx,
            params_from_jax(cfg, tree, "cpu"))
        gathered = fsdp_gather(params, ctx)
        res["params_checksum"] = float(sum(
            t.double().sum() for _, t in _with_paths(gathered)))
        p_jax = _jax_layout(cfg, gathered, ctx)
        m_jax = _jax_layout(cfg, fsdp_gather(opt["m"], ctx), ctx)
        v_jax = _jax_layout(cfg, fsdp_gather(opt["v"], ctx), ctx)
        # the port's ZeRO-1 step on the same mesh
        ctx0 = make_ctx(dgroup, mesh, model_group=mgroup, cfg=cfg,
                        remat=tcfg.remat)
        p0 = params_from_jax(cfg, tree, "cpu", ctx=ctx0)
        o0 = init_opt_state(p0, ctx0)
        p0, o0, m0 = make_train_step(cfg, tcfg, ctx0)(p0, o0, batch)
        res["zero1_metrics"] = {k: float(v) for k, v in m0.items()}
        full0 = gather_opt_state(o0, ctx0, p0)
        z = {"params": _jax_layout(cfg, p0, ctx0),
             "m": _jax_layout(cfg, full0["m"], ctx0),
             "v": _jax_layout(cfg, full0["v"], ctx0)}
        if rank == 0:
            res.update(params=p_jax, m=m_jax, v=v_jax, zero1=z)
    return out


def _serve(cfg, tree, ctx, tokens) -> dict:
    """Prefill logits of this data rank's rows and a replay of them through
    ``decode_step`` on the FSDP shards, against the single rank's on the
    same rows (max abs differences)."""
    rows = slice(ctx.rank * (tokens.shape[0] // ctx.dp),
                 (ctx.rank + 1) * (tokens.shape[0] // ctx.dp))
    tok = torch.from_numpy(np.asarray(tokens[rows], np.int64))
    whole = params_from_jax(cfg, tree, "cpu")
    params = fsdp_shard(params_from_jax(cfg, tree, "cpu", ctx=ctx), ctx)
    with torch.no_grad():
        got = make_prefill(cfg, ctx)(params, tok)
        want, _ = forward(cfg, whole, tok)
        steps = 8
        cache = init_cache(cfg, params, len(tokens), steps, ctx=ctx)
        ref_cache = init_cache(cfg, whole, tok.shape[0], steps)
        dec = 0.0
        for t in range(steps):
            a, cache = decode_step(cfg, params, cache, tok[:, t:t + 1], t,
                                   ctx=ctx)
            b, ref_cache = decode_step(cfg, whole, ref_cache,
                                       tok[:, t:t + 1], t)
            dec = max(dec, _max_err(full_logits(cfg, a, ctx), b))
    return {"prefill_err": _max_err(got, want), "decode_err": dec,
            "shard_bytes": sum(t.numel() * t.element_size()
                               for _, t in _with_paths(params)),
            "whole_bytes": sum(t.numel() * t.element_size()
                               for _, t in _with_paths(
                                   shard_params(whole, ctx, cfg)))}
