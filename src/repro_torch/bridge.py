"""Carries parameters of the JAX package into the port.

The caller converts the JAX parameter pytree to nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``), so the port itself never imports
jax.  Weights are shared by value: ``jax.random`` is not re-implemented.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.types import ModelConfig
from repro_torch.models.transformer import check_ported


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    return fn(x)


def params_from_jax(cfg: ModelConfig, tree: dict, device="cuda") -> dict:
    """JAX ``init_params`` tree (as numpy) -> the port's parameter dict.

    Each ``group{gi}/pos{i}/...`` leaf is stacked over the group's repeats
    (``jax.vmap`` in ``_init_group``); it is unstacked into per-layer
    tensors in the JAX layer order: group by group, repeat by repeat,
    period position by period position."""
    check_ported(cfg)
    dev = resolve_device(device)
    params = {"embed": _tensor(tree["embed"], dev),
              "final_norm": _tree(tree["final_norm"],
                                  lambda a: _tensor(a, dev))}
    if "lm_head" in tree:
        params["lm_head"] = _tensor(tree["lm_head"], dev)
    layers = []
    for gi, (period, repeats) in enumerate(cfg.layer_groups()):
        group = tree[f"group{gi}"]
        for r in range(repeats):
            for i in range(len(period)):
                layers.append(_tree(group[f"pos{i}"],
                                    lambda a, r=r: _tensor(a[r], dev)))
    params["layers"] = layers
    return params
