"""Carries parameters and optimizer state between the JAX package and the
port.

The caller converts the JAX pytrees to nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``), so the port itself never imports
jax.  Weights are shared by value: ``jax.random`` is not re-implemented.
``params_to_jax_layout`` goes the other way, into numpy, so that tests
compare updated parameters and moments leaf for leaf.  Under expert
parallelism a rank holds its part of each expert weight
(``parallel.shard_params``): ``params_from_jax(..., ctx=)`` cuts it out,
``params_to_jax_layout(..., ctx=)`` gathers the parts back (every rank
calls it).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.types import ModelConfig
from repro_torch.core.tree import tree_map
from repro_torch.models.transformer import check_ported
from repro_torch.parallel.planner import gather_params, shard_params


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(cfg: ModelConfig, tree: dict, device="cuda",
                    ctx=None) -> dict:
    """JAX ``init_params`` tree (as numpy) -> the port's parameter dict,
    with an expert-parallel ``ctx`` this rank's shard of it.

    Each ``group{gi}/pos{i}/...`` leaf is stacked over the group's repeats
    (``jax.vmap`` in ``_init_group``); it is unstacked into per-layer
    tensors in the JAX layer order: group by group, repeat by repeat,
    period position by period position."""
    check_ported(cfg)
    dev = resolve_device(device)
    params = {"embed": _tensor(tree["embed"], dev),
              "final_norm": tree_map(lambda a: _tensor(a, dev),
                                     tree["final_norm"])}
    if "lm_head" in tree:
        params["lm_head"] = _tensor(tree["lm_head"], dev)
    layers = []
    for gi, (period, repeats) in enumerate(cfg.layer_groups()):
        group = tree[f"group{gi}"]
        for r in range(repeats):
            for i in range(len(period)):
                layers.append(tree_map(lambda a, r=r: _tensor(a[r], dev),
                                       group[f"pos{i}"]))
    params["layers"] = layers
    return shard_params(params, ctx)


def opt_state_from_jax(cfg: ModelConfig, state: dict, device="cuda",
                       ctx=None) -> dict:
    """JAX ``init_opt_state`` tree (as numpy) -> the port's optimizer state:
    m and v unstacked (and sharded) like the parameters
    (``params_from_jax``), step a 0-d int32 tensor."""
    dev = resolve_device(device)
    return {"m": params_from_jax(cfg, state["m"], dev, ctx),
            "v": params_from_jax(cfg, state["v"], dev, ctx),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=dev)}


def params_to_jax_layout(cfg: ModelConfig, params: dict, ctx=None) -> dict:
    """The port's parameter tree (or m or v) -> numpy in the JAX package's
    layout: each ``group{gi}/pos{i}`` leaf stacked over the group's repeats
    in the JAX layer order; bf16 leaves as f32 (exact).  With an
    expert-parallel ``ctx`` the tree is this rank's shard, and the expert
    weights are gathered from the ranks first (every rank calls it)."""
    params = gather_params(params, ctx)

    def arr(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    tree = {"embed": arr(params["embed"]),
            "final_norm": tree_map(arr, params["final_norm"])}
    if "lm_head" in params:
        tree["lm_head"] = arr(params["lm_head"])
    layers = iter(params["layers"])
    for gi, (period, repeats) in enumerate(cfg.layer_groups()):
        reps = [[next(layers) for _ in period] for _ in range(repeats)]
        tree[f"group{gi}"] = {
            f"pos{i}": _stack([reps[r][i] for r in range(repeats)], arr)
            for i in range(len(period))}
    return tree


def _stack(layers: list, arr) -> dict:
    """Nested dicts of tensors, one per repeat -> the same dicts of numpy
    arrays stacked along a new first axis."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([lp[k] for lp in layers], arr) for k in first}
    return np.stack([arr(t) for t in layers])
