"""Checkpointing: save/restore of parameters and optimizer state with step
metadata (port of ``repro.checkpoint.io``).

Layout: <dir>/step_<n>/{manifest.msgpack, arrays.npz}, the JAX package's.
The trees are written in the JAX package's layout (``bridge.
params_to_jax_layout``: each layer group's leaves stacked over its repeats)
under its keys, ``params/<path>`` and ``opt_state/<path>`` with ``/``
between the dict keys, so a checkpoint written by either package restores
in the other.  bf16 leaves are written as f32 (exact) and restored in the
template's dtype.  The manifest is encoded by ``msgpack_lite``.  Under
expert or tensor parallelism the checkpoint still holds every leaf whole:
the ranks gather their parts first (``parallel.gather_params``, and
``optim.gather_opt_state`` under ZeRO-1), and a restore with the context
cuts each rank's part out again.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import (opt_state_from_jax, params_from_jax,
                                params_to_jax_layout)
from repro_torch.checkpoint import msgpack_lite
from repro_torch.core.tree import param_leaves, tree_map
from repro_torch.core.types import ModelConfig


def checkpoint_state_bytes(cfg: ModelConfig, param_bytes: int = 4,
                           moment_bytes: int = 4, moments: int = 2) -> int:
    """Bytes a tenant re-ingests on checkpoint-restore: f32 master params
    plus the optimizer moments (AdamW: two f32 tensors per param), 12
    bytes/param by default.  ZeRO-1 sharding changes who holds which
    shard, not the total that must cross the job's ingress links, so the
    estimate is sharding-independent.  Pure arithmetic over
    ``ModelConfig.param_counts()``."""
    total = cfg.param_counts()["total"]
    return int(total * (param_bytes + moments * moment_bytes))


def _flatten(tree: dict, prefix: str) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        out.update(_flatten(v, key) if isinstance(v, dict) else {key: v})
    return out


def _nest(flat: Dict[str, np.ndarray], prefix: str) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = value
    return tree


def save_checkpoint(cfg: ModelConfig, ckpt_dir: str, step: int, params: Any,
                    opt_state: Optional[Dict[str, Any]] = None,
                    extra: Optional[Dict] = None) -> str:
    """Writes ``params`` (and the full ``opt_state``: under ZeRO-1, gather
    it first with ``optim.gather_opt_state``, and under expert or tensor
    parallelism both with ``parallel.gather_params``) as step ``step`` under
    ``ckpt_dir``; returns the step's directory."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    blobs = _flatten(params_to_jax_layout(cfg, params), "params")
    manifest: Dict[str, Any] = {"step": step, "extra": extra or {},
                                "params_keys": sorted(k.split("/", 1)[1]
                                                      for k in blobs)}
    if opt_state is not None:
        if isinstance(opt_state["m"], torch.Tensor):
            raise ValueError("save_checkpoint takes the full optimizer "
                             "state: gather a ZeRO-1 shard first "
                             "(optim.gather_opt_state)")
        opt = {"m": params_to_jax_layout(cfg, opt_state["m"]),
               "v": params_to_jax_layout(cfg, opt_state["v"]),
               "step": np.asarray(int(opt_state["step"]), np.int32)}
        flat = _flatten(opt, "opt_state")
        manifest["opt_state_keys"] = sorted(k.split("/", 1)[1] for k in flat)
        blobs.update(flat)
    np.savez(os.path.join(path, "arrays.npz"), **blobs)
    with open(os.path.join(path, "manifest.msgpack"), "wb") as f:
        f.write(msgpack_lite.packb(manifest))
    return path


def restore_checkpoint(cfg: ModelConfig, path: str, params_template: Any,
                       opt_template: Optional[Dict[str, Any]] = None,
                       ctx=None
                       ) -> Tuple[Any, Optional[Dict[str, Any]], int]:
    """Reads the step directory ``path`` into the port's layout, each leaf
    on the device and in the dtype of its template's (the optimizer state
    only where ``opt_template`` is given); with an expert- or
    tensor-parallel ``ctx`` this rank's part of the split leaves (the
    templates are its shards).
    Returns (params, opt_state, step)."""
    with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
        manifest = msgpack_lite.unpackb(f.read())
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        flat = {k: npz[k] for k in npz.files}

    def like(tree, template):
        it = iter(param_leaves(template))
        return tree_map(lambda t: t.to(dtype=next(it).dtype), tree)

    device = next(param_leaves(params_template)).device
    params = like(params_from_jax(cfg, _nest(flat, "params"), device, ctx),
                  params_template)
    opt = None
    if opt_template is not None:
        opt = opt_state_from_jax(cfg, _nest(flat, "opt_state"), device, ctx)
        opt = {"m": like(opt["m"], opt_template["m"]),
               "v": like(opt["v"], opt_template["v"]), "step": opt["step"]}
    return params, opt, int(manifest["step"])
