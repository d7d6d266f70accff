"""Rank functions of the port's tensor-parallel tests
(``tests/test_torch_tp.py``, ``tests/test_torch_launch.py``,
``tests/test_torch_cuda.py``), run by
``repro_torch.launch.ranks.spawn_ranks``.  A spawned rank imports this
module by name, so it imports torch and the port only (no jax), and every
function here is at top level."""
import dataclasses

import numpy as np
import torch

from repro_torch.bridge import params_from_jax, params_to_jax_layout
from repro_torch.ccl.primitives import _permute
from repro_torch.configs import smoke_config
from repro_torch.core.tree import param_leaves
from repro_torch.core.types import MeshConfig, TrainConfig
from repro_torch.launch.mesh import mesh_groups
from repro_torch.launch.train import checksum
from repro_torch.models import (decode_step, encode, forward, init_cache,
                                init_params)
from repro_torch.models import attention as attn
from repro_torch.models import moe, ssm
from repro_torch.models.modules import rms_norm
from repro_torch.optim import gather_opt_state, init_opt_state
from repro_torch.parallel import gather_params, make_ctx, model_flags
from repro_torch.parallel.planner import _unflatten_like
from repro_torch.parallel.tensor import copy_to_model, reduce_from_model
from repro_torch.serve.step import full_logits
from repro_torch.train import make_train_step
from torch_dp_ranks import flatten, nest

# qwen2-0.5b's smoke config with the full config's 14 query heads: at tp 4
# its attention is replicated, as qwen2-0.5b's is at tp 4 and 16
REPLICATED_ATTN = "qwen2-0.5b-14h"
# dbrx-132b's smoke config with 6 experts: a model axis of 4 does not
# divide them, and ``param_specs`` replicates them (``guarded``)
REPLICATED_EXPERTS = "dbrx-132b-e6"
# name -> (the arch whose smoke config it changes, the fields changed)
VARIANTS = {REPLICATED_ATTN: ("qwen2-0.5b", {"num_heads": 14}),
            REPLICATED_EXPERTS: ("dbrx-132b", {"num_experts": 6})}


def tp_config(name: str):
    """The smoke config of ``name`` (or of one of the ``VARIANTS``)."""
    if name in VARIANTS:
        arch, fields = VARIANTS[name]
        return dataclasses.replace(smoke_config(arch), name=name, **fields)
    return smoke_config(name)


def tp_ctx(world: int, mesh_shape, cfg, remat: bool = False, use_ep=None):
    """This rank's context on the mesh: tensor parallelism, and for a MoE
    config expert parallelism beside it (unless ``use_ep`` is False:
    ``moe_dense`` on the rank's experts) at capacity factor E (the number
    of experts: no dispatch is dropped, so the single-rank run, which
    drops none, is the reference)."""
    mcfg = MeshConfig(tuple(mesh_shape))
    if mcfg.num_devices != world:
        raise ValueError(f"mesh {mesh_shape} on {world} ranks")
    dgroup, mgroup = mesh_groups(mcfg)
    kw = {}
    if cfg.is_moe:
        kw = dict(capacity_factor=float(cfg.num_experts),
                  decode_capacity_factor=float(cfg.num_experts))
    return make_ctx(dgroup, mcfg, model_group=mgroup, remat=remat, cfg=cfg,
                    use_ep=use_ep, **kw)


def tp_context(data, arch: str, cfg, params, ctx=None, rows=slice(None)):
    """The context of ``arch``'s forward and cache from the inputs (key
    ``context|<arch>``, the stub frames or patches, numpy): the encoder's
    output of the frames (``encode`` on this rank, ``ctx``), the patches
    as they are; ``None`` for a config without one."""
    key = f"context|{arch}"
    if key not in data:
        return None
    c = torch.from_numpy(np.asarray(data[key])[rows])
    if cfg.is_encoder_decoder:
        with torch.no_grad():
            return encode(cfg, params, c, ctx=ctx)
    return c


def tp_batch(data, arch: str) -> dict:
    """The training batch: ``tokens``, ``labels`` and, for a config with a
    context, the stub frames or patches (the step encodes the frames)."""
    batch = {"tokens": data["tokens"], "labels": data["labels"]}
    if f"context|{arch}" in data:
        batch["context"] = data[f"context|{arch}"]
    return batch


def _rows(n: int, ctx) -> slice:
    b = n // ctx.dp
    return slice(ctx.rank * b, (ctx.rank + 1) * b)


def _params(data, name: str, cfg, ctx, device="cpu"):
    """The JAX package's parameters of ``name`` from the inputs (key
    ``params|<name>|<path>``), this rank's part of them; where the inputs
    have none, the port's own draw from seed 0."""
    prefix = f"params|{name}|"
    flat = {k[len(prefix):]: data[k] for k in data.files
            if k.startswith(prefix)}
    if not flat:
        return init_params(cfg, torch.Generator(device=device).manual_seed(
            0), device=device, ctx=ctx)
    return params_from_jax(cfg, nest(flat), device, ctx)


def tp_cases(rank: int, world: int, mesh_shape, inputs_path: str,
             cases: dict) -> dict:
    """Every tensor-parallel case of ``tests/test_torch_tp.py`` on this
    rank of a (data, model) mesh.  ``inputs_path``: an .npz of the JAX
    package's parameters (``params|<arch>|<path>``) and the ``tokens`` and
    ``labels`` (B, S).  ``cases``: name -> {"kind": "model" | "init" |
    "bytes" | "fault", "arch", ...; "use_ep": ``tp_ctx``'s, optional}.
    Returns name -> this rank's results as numpy."""
    data = np.load(inputs_path)
    tokens = torch.from_numpy(data["tokens"]).long()
    labels = torch.from_numpy(data["labels"]).long()
    out = {}
    for name, case in cases.items():
        cfg = tp_config(case["arch"])
        ctx = tp_ctx(world, mesh_shape, cfg, use_ep=case.get("use_ep"))
        kind = case["kind"]
        if kind == "model":
            out[name] = _model(data, case, cfg, ctx, tokens, labels)
        elif kind == "init":
            params = init_params(cfg, torch.Generator().manual_seed(
                case["seed"]), device="cpu", ctx=ctx)
            out[name] = {"params": flatten(params_to_jax_layout(
                cfg, params, ctx)), "own": checksum(params)}
        elif kind == "bytes":
            out[name] = _bytes(data, case, cfg, ctx, tokens, labels)
        elif kind == "fault":
            out[name] = _fault(data, case, cfg, ctx, tokens)
        elif kind == "grad_fault":
            out[name] = _grad_fault(data, case, cfg, ctx)
        elif kind == "batcher":
            params = _params(data, case["arch"], cfg, ctx)
            out[name] = tp_batcher(cfg, params, case, ctx, tp_context(
                data, case["arch"], cfg, params, ctx, slice(0, 2)))
        else:
            raise KeyError(kind)
    return out


def tp_batcher(cfg, params, case: dict, ctx=None, context=None) -> dict:
    """A ``ContinuousBatcher`` of 2 slots over ``case["requests"]`` (the
    third admitted mid-flight) at ``case["temperature"]``, seed 5, over
    ``context`` (2 rows, for a config with one): every request's
    tokens."""
    from repro_torch.serve.batcher import ContinuousBatcher
    batcher = ContinuousBatcher(cfg, params, max_slots=2, max_len=24,
                                temperature=case["temperature"], seed=5,
                                ctx=ctx, context=context)
    for rid, prompt in enumerate(case["requests"]):
        batcher.submit(prompt, 6, rid)
    done = batcher.run()
    return {"out": {r.rid: r.out for r in done},
            "admitted": {r.rid: r.t_admit for r in done}}


def _decode(cfg, params, tokens, steps: int, ctx, context=None
            ) -> np.ndarray:
    cache = init_cache(cfg, params, tokens.shape[0], steps, context=context)
    logits = []
    with torch.no_grad():
        for t in range(steps):
            lg, cache = decode_step(cfg, params, cache, tokens[:, t:t + 1],
                                    t, ctx=ctx)
            logits.append(full_logits(cfg, lg, ctx)[:, 0])
    return torch.stack(logits, 1).numpy()


def _model(data, case, cfg, ctx, tokens, labels) -> dict:
    """Forward logits (gathered), ``steps`` decode steps (gathered
    logits), the cache's shapes, and one training step (``tcfg``): its
    metrics, this rank's gradient gathered (the hook's "local" stage) and
    the updated parameters and moments gathered, in the JAX layout."""
    params = _params(data, case["arch"], cfg, ctx)
    context = tp_context(data, case["arch"], cfg, params, ctx)
    res = {}
    with torch.no_grad():
        logits, _ = forward(cfg, params, tokens, context=context, ctx=ctx)
        res["local_vocab"] = logits.shape[-1]
        res["logits"] = full_logits(cfg, logits, ctx).numpy()
    res["decode"] = _decode(cfg, params, tokens, case["steps"], ctx,
                            context)
    cache = init_cache(cfg, params, tokens.shape[0], case["steps"],
                       context=context)
    res["cache_shapes"] = [tuple(t.shape) for t in param_leaves(cache)]
    tcfg = TrainConfig(**case["tcfg"])
    zero1 = tcfg.zero1 and ctx.dp > 1
    opt = init_opt_state(params, ctx if zero1 else None)
    seen = {}

    def hook(stage, grads):
        if stage == "local":
            seen["local"] = [g.detach().clone() for g in grads]

    step = make_train_step(cfg, tcfg, ctx)
    params, opt, m = step(params, opt, tp_batch(data, case["arch"]),
                          grad_hook=hook)
    res["metrics"] = {k: float(v) for k, v in m.items()}
    grads = _unflatten_like(params, seen["local"])
    res["grads"] = flatten(params_to_jax_layout(cfg, grads, ctx))
    res["params"] = flatten(params_to_jax_layout(cfg, params, ctx))
    full = gather_opt_state(opt, ctx, params) if zero1 else opt
    for k in ("m", "v"):
        res[k] = flatten(params_to_jax_layout(cfg, full[k], ctx))
    res["split"] = sum(model_flags(params, ctx, cfg))
    res["replicated_checksum"] = checksum([t for t, f in zip(
        param_leaves(params), model_flags(params, ctx, cfg)) if not f])
    return res


def _bytes(data, case, cfg, ctx, tokens, labels) -> dict:
    """Wire bytes this rank sends in a forward on its data rank's rows (no
    gather of the logits) and, with one data rank, in a training step:
    the model group's ring."""
    params = _params(data, case["arch"], cfg, ctx)
    rows = _rows(tokens.shape[0], ctx)
    s0 = _permute.sent_bytes
    with torch.no_grad():
        forward(cfg, params, tokens[rows], ctx=ctx)
    s1 = _permute.sent_bytes
    if ctx.dp > 1:
        return {"forward": s1 - s0}
    tcfg = TrainConfig(**case["tcfg"])
    opt = init_opt_state(params)
    step = make_train_step(cfg, tcfg, ctx)
    s2 = _permute.sent_bytes
    step(params, opt, {"tokens": data["tokens"], "labels": data["labels"]})
    return {"forward": s1 - s0, "step": _permute.sent_bytes - s2}


def _fault(data, case, cfg, ctx, tokens) -> dict:
    """The forward logits with a planted fault: "wo_all_reduce", an
    all-reduce after the output projection of a replicated attention;
    "local_norm", Mamba's gated norm over this rank's channels only."""
    params = _params(data, case["arch"], cfg, ctx)
    if case["fault"] == "wo_all_reduce":
        module, name, real = attn, "gqa_forward", attn.gqa_forward

        def planted(p, cfg_, x, positions, *, window=None, ctx=None):
            out = real(p, cfg_, x, positions, window=window, ctx=ctx)
            return reduce_from_model(out, ctx)
    elif case["fault"] == "local_norm":
        module, name, real = ssm, "_gated_norm", ssm._gated_norm

        def planted(p, cfg_, y, z, lay, ctx_):
            if lay is None:
                raise AssertionError("the fault needs split SSM heads")
            lo, hi = lay.block(cfg_.ssm_d_inner)
            return rms_norm(y * torch.nn.functional.silu(z),
                            p["norm"]["scale"][lo:hi], cfg_.norm_eps)
    else:
        raise KeyError(case["fault"])
    setattr(module, name, planted)
    try:
        with torch.no_grad():
            logits, _ = forward(cfg, params, tokens, ctx=ctx)
    finally:
        setattr(module, name, real)
    return {"logits": full_logits(cfg, logits, ctx).numpy()}


def _mla_x_only(real):
    """MLA with ``copy_to_model`` on its input only: the normed query
    latent, the KV latent and the rope key enter the heads without it, so
    each rank's gradient of ``w_dq``, ``w_dkv`` and their norms is only
    its own heads' share."""
    def planted(p, cfg_, x, positions, *, window=None, ctx=None):
        attn.copy_to_model = lambda t, c: t
        try:
            return real(p, cfg_, copy_to_model(x, ctx), positions,
                        window=window, ctx=ctx)
        finally:
            attn.copy_to_model = copy_to_model
    return planted


def _gate_before_reduce(real):
    """Cross-attention with ``tanh(gate_attn)`` applied to each rank's
    partial sums before ``reduce_from_model``: the same forward, but each
    rank's gradient of the gate is its own heads' share."""
    def planted(p, cfg_, x, context, ctx=None):
        lay = attn._tp_heads(cfg_, ctx)
        if lay is None:
            raise AssertionError("the fault needs split heads")
        q, k, v, sel = attn._tp_qkv(p, cfg_, x, lay, ctx, kv_x=context)
        if sel is not None:
            k, v = k[:, :, sel], v[:, :, sel]
        out = attn.multihead_attention(
            q, k, v, q_pos=torch.arange(x.shape[1]),
            k_pos=torch.arange(context.shape[1]), causal=False)
        out = attn._gated(p, torch.einsum("bshk,hkd->bsd", out, p["wo"]))
        return reduce_from_model(out, ctx)
    return planted


def _weights_no_copy(real):
    """``moe_dense``'s combine weights cut to the rank's columns without
    ``copy_to_model``: each rank's gradient of the router is then only its
    own experts' share of the combine."""
    def planted(w_full, lay, ctx):
        lo, hi = lay.block(w_full.shape[1])
        return w_full[:, lo:hi]
    return planted


def _router_copy(real):
    """The router reading the tokens through ``copy_to_model``: the
    router's part of their gradient, whole on every rank, is then summed
    over the model ranks."""
    def planted(p, cfg_, x, ctx=None):
        return real(p, cfg_, copy_to_model(x, ctx), ctx)
    return planted


# name -> (module, the function replaced, its planted version of it)
GRAD_FAULTS = {"mla_x_only": (attn, "mla_forward", _mla_x_only),
               "gate_before_reduce": (attn, "cross_attention_forward",
                                      _gate_before_reduce),
               "weights_no_copy": (moe, "_rank_weights", _weights_no_copy),
               "router_copy": (moe, "route", _router_copy)}


def _grad_fault(data, case, cfg, ctx) -> dict:
    """This rank's gradient (gathered, the JAX layout) of one training
    step with a planted fault (``GRAD_FAULTS``), the function restored
    after it."""
    module, name, make = GRAD_FAULTS[case["fault"]]
    params = _params(data, case["arch"], cfg, ctx)
    seen = {}

    def hook(stage, grads):
        if stage == "local":
            seen["local"] = [g.detach().clone() for g in grads]

    tcfg = TrainConfig(**case["tcfg"])
    opt = init_opt_state(params, ctx if tcfg.zero1 and ctx.dp > 1 else None)
    real = getattr(module, name)
    setattr(module, name, make(real))
    try:
        make_train_step(cfg, tcfg, ctx)(
            params, opt, tp_batch(data, case["arch"]), grad_hook=hook)
    finally:
        setattr(module, name, real)
    return {"grads": flatten(params_to_jax_layout(
        cfg, _unflatten_like(params, seen["local"]), ctx))}


def tp_launch_ckpt(rank: int, world: int, arch: str, mesh_shape,
                   ckpt_path: str) -> dict:
    """Restores the checkpoint at ``ckpt_path`` (the JAX layout, written
    whole) onto this rank of a tensor-parallel mesh and gathers it back:
    the restored parameters and moments' checksums, and this rank's part
    against the same part cut from the whole."""
    from repro_torch.checkpoint import restore_checkpoint
    cfg = smoke_config(arch)
    ctx = tp_ctx(world, mesh_shape, cfg)
    template = init_params(cfg, torch.Generator().manual_seed(1),
                           device="cpu", ctx=ctx)
    opt_t = init_opt_state(template)
    params, opt, step = restore_checkpoint(cfg, ckpt_path, template, opt_t,
                                           ctx=ctx)
    whole = gather_params(params, ctx, cfg)
    return {"step": step, "params": checksum(whole),
            "m": checksum(gather_params(opt["m"], ctx, cfg)),
            "v": checksum(gather_params(opt["v"], ctx, cfg)),
            "shapes": [tuple(t.shape) for t in param_leaves(params)]}


def tp_on_card(rank: int, world: int, arch: str, mesh_shape,
               seed: int) -> dict:
    """``arch``'s smoke config in f32 on a (data, model) mesh, every rank
    on the card (``rank_device``), a MoE config's experts expert-parallel
    beside the rest (``tp_ctx``): this rank's blocks of the CPU draw from
    ``seed`` (the cross-attention gates opened, ``card_params``) moved to
    the card, the prefill logits of ``card_tokens`` over ``card_context``
    (encoded on the ranks for the encoder-decoder; gathered) and one
    training step on them (``TrainConfig(remat=False)``), its metrics and
    the updated parameters and first moments gathered, with the kernel
    launches of each."""
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.ranks import rank_device
    from repro_torch.models import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = rank_device("cuda")
    cfg = smoke_config(arch)
    ctx = tp_ctx(world, mesh_shape, cfg)
    params = tree_map(lambda t: t.to(device), card_params(cfg, seed, ctx))
    tokens = card_tokens(cfg)
    frames = card_context(cfg)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    with torch.no_grad():
        n0 = launch_counts()
        context = None
        if frames is not None:
            batch["context"] = frames
            context = torch.from_numpy(frames).to(device)
            if cfg.is_encoder_decoder:
                context = encode(cfg, params, context, ctx=ctx)
        logits, _ = forward(cfg, params, tokens.to(device), context=context,
                            ctx=ctx)
        logits = full_logits(cfg, logits, ctx)
        torch.cuda.synchronize()
        n1 = launch_counts()
    step = make_train_step(cfg, TrainConfig(remat=False), ctx)
    params, opt, m = step(params, init_opt_state(params), batch)
    torch.cuda.synchronize()
    n2 = launch_counts()
    return {"device": str(device),
            "logits": logits.cpu().numpy(),
            "params": [t.cpu().numpy() for t in param_leaves(
                gather_params(params, ctx, cfg))],
            "m": [t.cpu().numpy() for t in param_leaves(
                gather_params(opt["m"], ctx, cfg))],
            "metrics": {k: float(v) for k, v in m.items()},
            "prefill_launches": {k: n1[k] - n0[k] for k in n1
                                 if n1[k] != n0[k]},
            "step_launches": {k: n2[k] - n1[k] for k in n2
                              if n2[k] != n1[k]}}


def card_params(cfg, seed: int, ctx=None):
    """The CPU draw from ``seed`` (this rank's part under ``ctx``), every
    ``gate_attn`` opened to 0.8 plus 0.1 a block (``open_gates``)."""
    from torch_context import open_gates
    return open_gates(init_params(cfg, torch.Generator().manual_seed(seed),
                                  device="cpu", ctx=ctx))


def card_tokens(cfg) -> torch.Tensor:
    """The prompt of ``tp_on_card``: B 4 x S 64 from a seed."""
    return torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (4, 64)))


def card_context(cfg):
    """The stub frames or patches of ``tp_on_card``'s 4 rows (numpy), or
    ``None``."""
    from torch_context import stub_context
    return stub_context(cfg, 4, seed=12)


def _stage(w, x):
    return torch.tanh(x @ w)


def pipeline_cases(rank: int, world: int, inputs_path: str) -> dict:
    """``parallel.collective_matmul`` and ``parallel.pipeline`` on this
    rank of a 1-D group of ``world``: ``ag_matmul`` of this rank's rows of
    ``cmm|x`` against its columns of ``cmm|w`` (and the bulk all-gather
    then a product), ``matmul_rs`` of its contraction block of ``cmm|x2``
    against its rows of ``cmm|w2``; the GPipe pipeline of tanh(x @ w_i)
    stages (``pipe|w`` (p, D, D), ``pipe|x`` (M, mb, D)) through
    ``make_pipeline_fn``, and the interleaved one (``ipipe|w`` (p, v, D,
    D), ``ipipe|x``), each's outputs, the gradient of sum(y^2) for this
    rank's parameters (and the interleaved input's), and the wire bytes
    of the forward and of the backward."""
    from repro_torch.ccl import primitives as prim
    from repro_torch.parallel.collective_matmul import ag_matmul, matmul_rs
    from repro_torch.parallel.pipeline import (interleaved_pipeline_apply,
                                               make_pipeline_fn)
    data = {k: torch.from_numpy(v) for k, v in np.load(inputs_path).items()}
    out = {}
    x, w = data["cmm|x"], data["cmm|w"]
    mb, nb = x.shape[0] // world, w.shape[1] // world
    xl, wl = x[rank * mb:(rank + 1) * mb], w[:, rank * nb:(rank + 1) * nb]
    s0 = _permute.sent_bytes
    out["ag"] = ag_matmul(xl, wl).numpy()
    out["ag_bytes"] = _permute.sent_bytes - s0
    out["ag_bulk"] = (prim.ring_all_gather(xl).flatten(0, 1) @ wl).numpy()
    x2, w2 = data["cmm|x2"], data["cmm|w2"]
    kb = x2.shape[1] // world
    s0 = _permute.sent_bytes
    out["rs"] = matmul_rs(x2[:, rank * kb:(rank + 1) * kb],
                          w2[rank * kb:(rank + 1) * kb]).numpy()
    out["rs_bytes"] = _permute.sent_bytes - s0
    for name, v in (("pipe", 1), ("ipipe", 2)):
        w = data[f"{name}|w"].clone().requires_grad_(True)
        x = data[f"{name}|x"].clone().requires_grad_(True)
        s0 = _permute.sent_bytes
        if v == 1:
            y = make_pipeline_fn(_stage)(w, x)
        else:
            y = interleaved_pipeline_apply(_stage, w[rank], x, v=v)
        s1 = _permute.sent_bytes
        (y ** 2).sum().backward()
        out[f"{name}|y"] = y.detach().numpy()
        out[f"{name}|grad_w"] = w.grad[rank].numpy()
        out[f"{name}|grad_x"] = x.grad.numpy()
        out[f"{name}|bytes"] = (s1 - s0, _permute.sent_bytes - s1)
    return out


def tp_eval(rank: int, world: int, mesh_shape, archs, inputs: dict) -> dict:
    """``make_eval_step(cfg, ctx)`` of each of ``archs`` on this rank of the
    mesh, over the port's draw from seed 0 (this rank's part of it, gates
    opened) and ``inputs[arch]`` (the batch, numpy): the mean
    cross-entropy."""
    from repro_torch.train import make_eval_step
    from torch_context import open_gates
    out = {}
    for arch in archs:
        cfg = tp_config(arch)
        ctx = tp_ctx(world, mesh_shape, cfg)
        params = open_gates(init_params(
            cfg, torch.Generator().manual_seed(0), device="cpu", ctx=ctx))
        out[arch] = float(make_eval_step(cfg, ctx)(params, inputs[arch]))
    return out
