"""Carries parameters and optimizer state between the JAX package and the
port.

The caller converts the JAX pytrees to nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``), so the port itself never imports
jax.  Weights are shared by value: ``jax.random`` is not re-implemented.
``params_to_jax_layout`` goes the other way, into numpy, so that tests
compare updated parameters and moments leaf for leaf.  Under expert or
tensor parallelism a rank holds its part of each split leaf
(``parallel.shard_params``): ``params_from_jax(..., ctx=)`` cuts it out,
``params_to_jax_layout(..., ctx=)`` gathers the parts back (every rank
calls it).  ``to_jax_layout`` is the leaf mapping of the latter on any
tree of the port's layout (the specs of ``parallel.planner.param_specs``
too).
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
    return shard_params(params, ctx, cfg)


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
    expert- or tensor-parallel ``ctx`` the tree is this rank's shard, and
    the split leaves are gathered from the ranks first (every rank calls
    it)."""
    params = gather_params(params, ctx, cfg)

    def arr(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return to_jax_layout(cfg, params, arr, np.stack)


def to_jax_layout(cfg: ModelConfig, tree: dict, leaf, stack) -> dict:
    """The JAX package's layout of a tree in the port's (parameters, m, v
    or their specs): ``leaf(x)`` of each leaf, and of each leaf stacked
    over a layer group's repeats (the encoder's layers, the cross blocks)
    ``stack([leaf(x) for each repeat])``, in the JAX layer order."""
    out = {"embed": leaf(tree["embed"]),
           "final_norm": tree_map(leaf, tree["final_norm"])}
    if "lm_head" in tree:
        out["lm_head"] = leaf(tree["lm_head"])
    out.update(layers_to_jax_layout(cfg, tree["layers"], leaf, stack))
    if "encoder" in tree:
        out["encoder"] = {
            "group0": {"pos0": _stack(tree["encoder"]["layers"], leaf,
                                      stack)},
            "final_norm": tree_map(leaf, tree["encoder"]["final_norm"])}
        out["cross"] = _stack(tree["cross"], leaf, stack)
    return out


def layers_to_jax_layout(cfg: ModelConfig, layers: list, leaf,
                         stack) -> dict:
    """``to_jax_layout`` of the per-layer list alone (parameters or a
    decode cache's ``layers``): {"group{gi}": {"pos{i}": ...}}."""
    layers = iter(layers)
    out = {}
    for gi, (period, repeats) in enumerate(cfg.layer_groups()):
        reps = [[next(layers) for _ in period] for _ in range(repeats)]
        out[f"group{gi}"] = {
            f"pos{i}": _stack([reps[r][i] for r in range(repeats)], leaf,
                              stack)
            for i in range(len(period))}
    return out


def _stack(layers: list, leaf, stack) -> dict:
    """Nested dicts of leaves, one per repeat -> the same dicts of the
    repeats' leaves stacked."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([lp[k] for lp in layers], leaf, stack)
                for k in first}
    return stack([leaf(t) for t in layers])
