"""Rank functions of the port's sequence-split decode tests
(``tests/test_torch_seq_decode.py``), run by
``repro_torch.launch.ranks.spawn_ranks``.  A spawned rank imports this
module by name, so it imports torch and the port only (no jax), and every
function here is at top level."""
import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.ccl.primitives import _permute
from repro_torch.configs import smoke_config
from repro_torch.core.tree import param_leaves
from repro_torch.models import decode_step, init_cache
from repro_torch.parallel import sequence as seq
from repro_torch.parallel.planner import tp_layout
from repro_torch.serve.step import full_logits
from torch_tp_ranks import _params, tp_ctx

# name -> (the arch whose smoke config it changes, the fields changed)
SEQ_VARIANTS = {"qwen2-0.5b-swa16": ("qwen2-0.5b", {"sliding_window": 16})}


def seq_config(name: str):
    """The smoke config of ``name`` (or of one of the ``SEQ_VARIANTS``)."""
    if name in SEQ_VARIANTS:
        arch, fields = SEQ_VARIANTS[name]
        return dataclasses.replace(smoke_config(arch), name=name, **fields)
    return smoke_config(name)


def fill_cache(cache: dict, whole: list, cfg, ctx=None) -> None:
    """Copy ``whole`` (one dict of numpy arrays a layer, the whole cache of
    the global batch) into ``cache``, this rank's: a ``SlotBlock``'s slots
    [lo, lo + n), where the model axis splits the KV heads its block of
    them, every other leaf whole."""
    lay = tp_layout(cfg, ctx)
    for lc, wl in zip(cache["layers"], whole):
        for name, t in lc.items():
            w = torch.from_numpy(np.asarray(wl[name]))
            if isinstance(lc, seq.SlotBlock):
                w = w[:, lc.lo:lc.lo + t.shape[1]]
            if name in ("k", "v") and lay is not None and lay.kv:
                lo, hi = lay.block(cfg.num_kv_heads)
                w = w[:, :, lo:hi]
            t.copy_(w)


def whole_layers(data, name: str, cfg) -> list:
    """The case's whole cache from the inputs (``cache|<case>|<layer>|<leaf>``)
    as one dict of arrays a layer."""
    prefix = f"cache|{name}|"
    out = [dict() for _ in range(cfg.num_layers)]
    for k in data.keys():
        if k.startswith(prefix):
            layer, leaf = k[len(prefix):].split("|")
            out[int(layer)][leaf] = data[k]
    return out


def _write_everywhere(cache, index, values):
    """The fault ``write_all``: every rank writes the new token at its
    index modulo its own block, as a decode that takes the block for the
    whole ring does."""
    n = next(iter(cache.values())).shape[1]
    bi = torch.arange(index.shape[0])
    for name, v in values.items():
        cache[name][bi, index % n] = v.to(cache[name].dtype)


FAULTS = {"no_combine": ("combine", lambda m, l, o, ctx: o / l),
          "write_all": ("write_owned", _write_everywhere)}


@contextlib.contextmanager
def planted(fault):
    """``parallel.sequence`` with ``fault`` planted (``None``: sound),
    restored after: the next case in the same rank process must not
    inherit it."""
    if fault is None:
        yield
        return
    attr, fn = FAULTS[fault]
    sound = getattr(seq, attr)
    setattr(seq, attr, fn)
    try:
        yield
    finally:
        setattr(seq, attr, sound)


def seq_run(cfg, params, whole, case: dict, ctx=None) -> dict:
    """``case``'s decode steps (teacher-forced ``tokens`` (B, steps) at
    ``positions``, a position or one a row a step) on a cache of
    ``max_len`` (``init_window``) filled from ``whole``: the logits over
    the whole vocabulary (B, steps, V_pad), each step's wire bytes and the
    cache's local shapes, a dict a layer."""
    tokens = torch.as_tensor(case["tokens"]).long()
    b = tokens.shape[0]
    cache = init_cache(cfg, params, b, case["max_len"],
                       window=case.get("init_window"), ctx=ctx)
    fill_cache(cache, whole, cfg, ctx)
    logits, sent = [], []
    with torch.no_grad(), planted(case.get("fault")):
        for t, pos in enumerate(case["positions"]):
            n0 = _permute.sent_bytes
            lg, cache = decode_step(cfg, params, cache, tokens[:, t:t + 1],
                                    torch.as_tensor(pos), ctx=ctx,
                                    window=case.get("window"))
            sent.append(_permute.sent_bytes - n0)
            logits.append(full_logits(cfg, lg, ctx)[:, 0])
    return {"logits": torch.stack(logits, 1).numpy(), "bytes": sent,
            "shapes": [{k: tuple(t.shape) for k, t in lc.items()}
                       for lc in cache["layers"]],
            "blocks": [isinstance(lc, seq.SlotBlock)
                       for lc in cache["layers"]],
            "cache_bytes": sum(t.numel() * t.element_size()
                               for t in param_leaves(cache))}


def seq_cases(rank: int, world: int, mesh_shape, inputs_path: str,
              cases: dict) -> dict:
    """Every case of ``tests/test_torch_seq_decode.py`` on this rank of a
    (data, model) mesh.  ``inputs_path``: an .npz of the JAX package's
    parameters (``params|<config>|<path>``), each case's whole cache
    (``whole_layers``) and its ``tokens|<case>``.  ``cases``: name ->
    {"config", "max_len", "positions", "window", "init_window", "fault"}.
    Returns name -> this rank's ``seq_run``."""
    data = np.load(inputs_path)
    out = {}
    for name, case in cases.items():
        cfg = seq_config(case["config"])
        ctx = tp_ctx(world, mesh_shape, cfg)
        params = _params(data, case["config"], cfg, ctx)
        run = dict(case, tokens=data[f"tokens|{name}"])
        out[name] = seq_run(cfg, params, whole_layers(data, name, cfg), run,
                            ctx)
    return out
