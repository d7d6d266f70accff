"""Rank functions of ``tests/test_torch_tp_mamba_cache.py``: Mamba decode
on a model axis that keeps the SSM heads whole and splits the ``conv_x``
cache's channels (``TPLayout.conv_x``), run by
``repro_torch.launch.ranks.spawn_ranks``.  A spawned rank imports this
module by name, so it imports torch and the port only (no jax), and every
function here is at top level."""
import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.ccl.primitives import _permute
from repro_torch.configs import smoke_config
from repro_torch.models import decode_step, init_cache
from repro_torch.models import ssm
from repro_torch.serve.step import full_logits
from torch_tp_ranks import _params, tp_ctx

ARCH = "mamba2-130m"
# 2 heads of 256 over 512 channels: a model axis of 4 keeps the heads whole
# and splits ``conv_x`` into blocks of 128
HEAD_DIM = 256


def mamba_config():
    return dataclasses.replace(smoke_config(ARCH), ssm_head_dim=HEAD_DIM)


def _no_gather(x, ctx):
    """The fault ``no_gather``: each rank's own block of the conv outputs
    in place, zeros for the other ranks' blocks."""
    n = x.shape[-1]
    out = x.new_zeros((*x.shape[:-1], n * ctx.tp))
    lo = ctx.model_rank * n
    out[..., lo:lo + n] = x
    return out


def _wrong_block(params, cfg, ctx) -> None:
    """The fault ``wrong_block``: model rank 1 convolves its channels with
    rank 2's block of each layer's ``conv_x`` weights and bias."""
    if ctx.model_rank != 1:
        return
    lo, hi = ssm.conv_block(cfg, ctx)
    n = hi - lo
    for lp in params["layers"]:
        for name in ("conv_x", "conv_x_bias"):
            w = lp["mixer"][name]
            w[..., lo:hi] = w[..., hi:hi + n].clone()


@contextlib.contextmanager
def planted(fault, params, cfg, ctx):
    """The decode with ``fault`` planted (``None``: sound); the patched
    function restored after, so that the next case in the same rank
    process does not inherit it."""
    if fault == "wrong_block":
        _wrong_block(params, cfg, ctx)
    if fault != "no_gather":
        yield
        return
    sound = ssm.gather_from_model
    ssm.gather_from_model = _no_gather
    try:
        yield
    finally:
        ssm.gather_from_model = sound


def mamba_decode_run(cfg, params, tokens, ctx=None, fault=None) -> dict:
    """``tokens`` (B, steps) teacher-forced through ``decode_step`` from
    position 0: the logits over the whole vocabulary (B, steps, V_pad),
    each step's wire bytes (the logits' gather left out) and the cache
    after the last step, a dict of arrays a layer."""
    b, steps = tokens.shape
    cache = init_cache(cfg, params, b, steps, ctx=ctx)
    logits, sent = [], []
    with torch.no_grad(), planted(fault, params, cfg, ctx):
        for t in range(steps):
            n0 = _permute.sent_bytes
            lg, cache = decode_step(cfg, params, cache, tokens[:, t:t + 1],
                                    t, ctx=ctx)
            sent.append(_permute.sent_bytes - n0)
            logits.append(full_logits(cfg, lg, ctx)[:, 0])
    return {"logits": torch.stack(logits, 1).numpy(), "bytes": sent,
            "cache": [{k: t.numpy() for k, t in lc.items()}
                      for lc in cache["layers"]]}


def mamba_cases(rank: int, world: int, inputs_path: str, faults) -> dict:
    """The sound decode and each of ``faults`` on this rank of a (1,
    world) mesh.  ``inputs_path``: an .npz of the JAX package's parameters
    (``params|<arch>|<path>``) and the ``tokens`` (B, steps).  Returns
    "sound" and each fault -> this rank's ``mamba_decode_run``."""
    data = np.load(inputs_path)
    cfg = mamba_config()
    ctx = tp_ctx(world, (1, world), cfg)
    tokens = torch.from_numpy(data["tokens"]).long()
    out = {}
    for fault in (None, *faults):
        params = _params(data, ARCH, cfg, ctx)  # wrong_block edits them
        out[fault or "sound"] = mamba_decode_run(cfg, params, tokens, ctx,
                                                 fault)
    return out
