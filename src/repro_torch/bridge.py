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
    period position by period position.  An encoder-decoder tree's
    ``encoder/group0/pos0`` stack becomes ``encoder["layers"]`` and its
    ``cross`` stack (one block per decoder layer) the list ``cross``."""
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
                layers.append(_unstack(group[f"pos{i}"], r, dev))
    params["layers"] = layers
    if "encoder" in tree:
        enc = tree["encoder"]
        params["encoder"] = {
            "layers": [_unstack(enc["group0"]["pos0"], r, dev)
                       for r in range(cfg.encoder_layers)],
            "final_norm": tree_map(lambda a: _tensor(a, dev),
                                   enc["final_norm"])}
        params["cross"] = [_unstack(tree["cross"], r, dev)
                           for r in range(cfg.num_layers)]
    return shard_params(params, ctx)


def _unstack(stacked: dict, r: int, dev: torch.device) -> dict:
    """Entry ``r`` of each leaf of a tree stacked over layers."""
    return tree_map(lambda a: _tensor(a[r], dev), stacked)


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
    in the JAX layer order (and the encoder's layers and the cross blocks
    over theirs); bf16 leaves as f32 (exact).  With an
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
    if "encoder" in params:
        tree["encoder"] = {
            "group0": {"pos0": _stack(params["encoder"]["layers"], arr)},
            "final_norm": tree_map(arr, params["encoder"]["final_norm"])}
        tree["cross"] = _stack(params["cross"], arr)
    return tree


def _stack(layers: list, arr) -> dict:
    """Nested dicts of tensors, one per repeat -> the same dicts of numpy
    arrays stacked along a new first axis."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([lp[k] for lp in layers], arr) for k in first}
    return np.stack([arr(t) for t in layers])
