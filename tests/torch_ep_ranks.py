"""Rank functions of the port's expert-parallel tests
(``tests/test_torch_moe_ep.py``, ``tests/test_torch_cuda.py``), run by
``repro_torch.launch.ranks.spawn_ranks``.  A spawned rank imports this module
by name, so it imports torch and the port only (no jax), and every function
here is at top level."""
import dataclasses

import numpy as np
import torch

from repro_torch.bridge import params_from_jax, params_to_jax_layout
from repro_torch.ccl import primitives as prim
from repro_torch.configs import smoke_config
from repro_torch.core.types import MeshConfig, TrainConfig
from repro_torch.launch.mesh import mesh_groups
from repro_torch.launch.train import checksum
from repro_torch.models import (attention as attn, decode_step, forward,
                                init_cache, init_params, moe, param_leaves)
from repro_torch.optim import gather_opt_state, init_opt_state
from repro_torch.parallel import (expert_flags, gather_params, make_ctx,
                                  model_flags, shard_params)
from repro_torch.serve.step import full_logits
from repro_torch.train import make_train_step
from torch_dp_ranks import flatten, nest

ARCH = "dbrx-132b"
FUNCTIONS = {"train": moe.moe_ep_train, "decode": moe.moe_ep_decode,
             "decode_ws": moe.moe_ep_decode_ws}


def moe_config():
    """dbrx-132b's smoke config without shared experts
    (tests/test_moe.py's EP_SCRIPT)."""
    return dataclasses.replace(smoke_config(ARCH), num_shared_experts=0)


def _mesh(world: int, mesh_shape):
    mcfg = MeshConfig(tuple(mesh_shape))
    if mcfg.num_devices != world:
        raise ValueError(f"mesh {mesh_shape} on {world} ranks")
    return mcfg, mesh_groups(mcfg)


def _rows(n: int, ctx) -> slice:
    """This rank's rows of a batch of ``n``."""
    b = n // ctx.dp
    return slice(ctx.rank * b, (ctx.rank + 1) * b)


def ep_cases(rank: int, world: int, mesh_shape, inputs_path: str,
             cases: dict) -> dict:
    """Every expert-parallel case of ``tests/test_torch_moe_ep.py`` on this
    rank of a (data, model) mesh.  ``inputs_path``: an .npz of the JAX
    package's MoE parameters (``moe|<name>``) and model parameters
    (``params|<path>``, dbrx's smoke config), the activations ``x``, the
    all-to-all payloads ``a2a|x``, ``a2a|c`` (one a rank), the tokens
    ``tokens`` and ``labels``.  ``cases``: name -> {"kind": "a2a" |
    "moe" | "forward" | "decode" | "train", ...}.  Returns name -> this
    rank's results as numpy."""
    data = np.load(inputs_path)
    mcfg, (dgroup, mgroup) = _mesh(world, mesh_shape)
    out = {}
    for name, case in cases.items():
        kind = case["kind"]
        ws = case.get("fn") == "decode_ws"
        ctx = make_ctx(dgroup, mcfg, model_group=mgroup, use_ep=True,
                       remat=False, ep_weight_stationary=ws)
        if kind == "a2a":
            out[name] = _a2a(data, rank, ctx)
        elif kind == "moe":
            out[name] = _moe(data, case, ctx)
        elif kind == "forward":
            out[name] = _forward(data, ctx)
        elif kind == "decode":
            out[name] = _decode(data, case, ctx)
        elif kind == "train":
            out[name] = _train(data, case, ctx)
        elif kind == "bf16_decode":
            out[name] = _bf16_decode(data, case, ctx)
        else:
            raise KeyError(kind)
    return out


def _a2a(data, rank: int, ctx) -> dict:
    x = torch.from_numpy(data["a2a|x"][rank]).requires_grad_(True)
    c = torch.from_numpy(data["a2a|c"][rank])
    y = prim.AllToAll.apply(x, ctx.model_group)
    (y * c).sum().backward()
    plain = prim.all_to_all(x.detach(), ctx.model_group)
    return {"y": y.detach().numpy(), "grad": x.grad.numpy(),
            "plain": plain.numpy()}


def _moe(data, case, ctx) -> dict:
    cfg = moe_config()
    full = {k.split("|", 1)[1]: torch.from_numpy(data[k])
            for k in data.files if k.startswith("moe|")}
    p = shard_params(full, ctx, cfg)
    x = torch.from_numpy(data["x"])
    if case["fn"] != "train":
        x = x[:case.get("batch", x.shape[0]), :1]
    kw = {}
    if case.get("replicated"):  # every rank holds the whole batch
        if case["fn"] == "decode_ws":
            kw["whole_batch"] = True
    else:
        x = x[_rows(x.shape[0], ctx)]
    y, aux = FUNCTIONS[case["fn"]](p, cfg, x, ctx, case["factor"], **kw)
    return {"y": y.numpy(), "aux": float(aux)}


def _model_params(data, ctx):
    cfg = smoke_config(ARCH)
    tree = nest({k.split("|", 1)[1]: data[k] for k in data.files
                 if k.startswith("params|")})
    return cfg, params_from_jax(cfg, tree, "cpu", ctx)


def _forward(data, ctx) -> dict:
    cfg, params = _model_params(data, ctx)
    tokens = torch.from_numpy(data["tokens"]).long()
    with torch.no_grad():
        logits, aux = forward(cfg, params, tokens[_rows(len(tokens), ctx)],
                              ctx=ctx)
        logits = full_logits(cfg, logits, ctx)  # the vocabulary's blocks
    return {"logits": logits.numpy(), "aux": float(aux)}


def _decode(data, case, ctx) -> dict:
    cfg, params = _model_params(data, ctx)
    tokens = torch.from_numpy(data["tokens"]).long()
    tokens = tokens[_rows(len(tokens), ctx), :case["steps"]]
    cache = init_cache(cfg, params, tokens.shape[0], case["steps"])
    logits = []
    with torch.no_grad():
        for t in range(case["steps"]):
            lg, cache = decode_step(cfg, params, cache, tokens[:, t:t + 1],
                                    t, ctx=ctx)
            logits.append(full_logits(cfg, lg, ctx)[:, 0])
    return {"logits": torch.stack(logits, 1).numpy()}


def bf16_decode(cfg, params, tokens, steps: int, ctx=None) -> torch.Tensor:
    """``steps`` decode steps of ``tokens`` (B, >= steps) teacher-forced
    into a bf16 cache, the logits of each gathered over the vocabulary:
    (B, steps, V_pad) f32."""
    cache = init_cache(cfg, params, tokens.shape[0], steps,
                       dtype=torch.bfloat16)
    out = []
    with torch.no_grad():
        for t in range(steps):
            lg, cache = decode_step(cfg, params, cache, tokens[:, t:t + 1],
                                    t, ctx=ctx)
            out.append(full_logits(cfg, lg, ctx)[:, 0].float())
    return torch.stack(out, 1)


class SkipAttentionReduce:
    """A planted fault: the attention's ``reduce_from_model`` skipped on
    the first of every ``every`` calls (with ``every`` the attention
    layers of a decode step: the first layer's), each rank going on with
    its own heads' partial output."""

    def __init__(self, every: int):
        self.every, self.calls = every, 0
        self.real = attn.reduce_from_model

    def __call__(self, x, ctx):
        self.calls += 1
        return x if (self.calls - 1) % self.every == 0 else \
            self.real(x, ctx)

    def __enter__(self):
        attn.reduce_from_model = self
        return self

    def __exit__(self, *exc):
        attn.reduce_from_model = self.real


def _bf16_decode(data, case, ctx) -> dict:
    """dbrx's smoke config drawn in bf16 from ``case["seed"]`` (this
    rank's part), ``bf16_decode`` of this data rank's rows of the tokens:
    sound, and with ``SkipAttentionReduce`` planted."""
    cfg = smoke_config(ARCH)
    params = init_params(cfg, torch.Generator().manual_seed(case["seed"]),
                         dtype=torch.bfloat16, device="cpu", ctx=ctx)
    tokens = torch.from_numpy(data["tokens"]).long()
    tokens = tokens[_rows(len(tokens), ctx)]
    out = {"logits": bf16_decode(cfg, params, tokens, case["steps"],
                                 ctx).numpy()}
    n_attn = sum(s.mixer == "attn" for s in cfg.layer_specs())
    with SkipAttentionReduce(n_attn):
        out["fault"] = bf16_decode(cfg, params, tokens, case["steps"],
                                   ctx).numpy()
    return out


def _train(data, case, ctx) -> dict:
    cfg, params = _model_params(data, ctx)
    tcfg = TrainConfig(**case["tcfg"])
    zero1 = tcfg.zero1 and ctx.dp > 1
    opt = init_opt_state(params, ctx if zero1 else None)
    batch = {k: data[k] for k in ("tokens", "labels")}
    step = make_train_step(cfg, tcfg, ctx)
    metrics = []
    for _ in range(case.get("steps", 1)):
        params, opt, m = step(params, opt, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    full = gather_opt_state(opt, ctx, params) if zero1 else opt
    res = {"metrics": metrics,
           "params": flatten(params_to_jax_layout(cfg, params, ctx)),
           "own": checksum(params),
           "dense": checksum([t for t, e in zip(
               param_leaves(params), model_flags(params, ctx, cfg))
               if not e])}
    res["checksum"] = checksum([torch.from_numpy(v)
                                for v in res["params"].values()])
    for k in ("m", "v"):
        res[k] = flatten(params_to_jax_layout(cfg, full[k], ctx))
    return res


def ep_on_card(rank: int, world: int, seed: int, steps: int) -> dict:
    """dbrx's smoke config in f32 on a (1, world) mesh, every rank on the
    card (``rank_device``), at capacity factor 4 (no dispatch dropped):
    this rank's expert part drawn from ``seed`` on the card (checksummed),
    the prefill logits of ``card_tokens`` through ``moe_ep_train`` (the
    attention on this rank's heads), the logits of ``steps`` decode steps
    through ``moe_ep_decode``, both gathered over the vocabulary, and the
    kernel launches of each."""
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.ranks import rank_device
    from repro_torch.models import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    device = rank_device("cuda")
    cfg = smoke_config(ARCH)
    mcfg, (dgroup, mgroup) = _mesh(world, (1, world))
    ctx = make_ctx(dgroup, mcfg, model_group=mgroup, capacity_factor=4.0,
                   decode_capacity_factor=4.0)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        seed), device=device, ctx=ctx)
    tokens = card_tokens(cfg).to(device)
    with torch.no_grad():
        n0 = launch_counts()
        logits, _ = forward(cfg, params, tokens, ctx=ctx)
        logits = full_logits(cfg, logits, ctx)
        torch.cuda.synchronize()
        n1 = launch_counts()
        cache = init_cache(cfg, params, tokens.shape[0], steps)
        dec = []
        for t in range(steps):
            lg, cache = decode_step(cfg, params, cache, tokens[:, t:t + 1],
                                    t, ctx=ctx)
            dec.append(full_logits(cfg, lg, ctx)[:, 0])
        torch.cuda.synchronize()
        n2 = launch_counts()
    experts = [t for t, e in zip(param_leaves(params), expert_flags(params))
               if e]
    return {"logits": logits.cpu().numpy(),
            "decode": torch.stack(dec, 1).cpu().numpy(),
            "experts": [t.cpu().numpy() for t in experts],
            "device": str(device),
            "prefill_launches": {k: n1[k] - n0[k] for k in n1
                                 if n1[k] != n0[k]},
            "decode_launches": {k: n2[k] - n1[k] for k in n2
                                if n2[k] != n1[k]}}


def card_tokens(cfg) -> torch.Tensor:
    """The prompt of ``ep_on_card``: B 2 x S 64 from a seed."""
    return torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 64)))


def ep_train_on_card(rank: int, world: int, mesh_shape, seed: int,
                     tcfg: dict, device: str = "cuda") -> dict:
    """One f32 training step of dbrx's smoke config on the card over a
    (data, model) mesh of gloo ranks, every MoE layer through
    ``moe_ep_train`` at capacity factor 16 (no dispatch dropped), K5 and
    its backward kernel on this rank's experts, the attention on its
    heads: the step's metrics, the first moments after it gathered from
    the model ranks, and the kernel launches of the step (none on the CPU,
    where ``device`` "cpu" rehearses it)."""
    from repro_torch.data import make_batches
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.ranks import rank_device
    from repro_torch.models import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    device = rank_device(device)
    cfg = smoke_config(ARCH)
    mcfg, (dgroup, mgroup) = _mesh(world, mesh_shape)
    ctx = make_ctx(dgroup, mcfg, model_group=mgroup, use_ep=True,
                   remat=False, capacity_factor=16.0)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        seed), device=device, ctx=ctx)
    batch = next(make_batches(cfg, 4, 64, seed=1))
    step = make_train_step(cfg, TrainConfig(**tcfg), ctx)
    n0 = launch_counts()
    _, opt, m = step(params, init_opt_state(params), batch)
    if device.type == "cuda":
        torch.cuda.synchronize()
    n1 = launch_counts()
    return {"metrics": {k: float(v) for k, v in m.items()},
            "m": [t.cpu().numpy() for t in param_leaves(
                gather_params(opt["m"], ctx, cfg))],
            "launches": {k: n1[k] - n0[k] for k in n1 if n1[k] != n0[k]}}
