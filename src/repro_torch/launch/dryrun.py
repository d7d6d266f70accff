"""The multi-pod dry-run of the port: what one rank of a production mesh
costs, for every architecture x input shape, counted on the host.

Counterpart of ``repro.launch.dryrun``.  The JAX package lowers and
compiles each combination on 256 or 512 forced host devices and reads
XLA's analyses.  Here ``build_dryrun`` returns a ``program`` that runs one
rank's train step, prefill or decode step once, eagerly, on meta tensors
of that rank's shards, as the rank of a ``fake`` world of the mesh's size
(``launch.mesh.production_world``: no device, no transport), under the
counters of ``launch.analysis``: the FLOPs, the bytes of every aten op,
the collectives the port places (``ccl.primitives``) and the memory a
rank holds.  It never asks for a card.

- The parameters are this rank's: its model-axis block
  (``init_params(..., ctx=)``), under FSDP its data-axis shard of that
  (``parallel.fsdp``), the decision and the notes computed as the JAX
  package computes them (bf16 parameters over ``tp`` above
  ``FSDP_THRESHOLD_BYTES``; ``param_specs``' notes in the JAX layout);
- the optimizer state is the port's: ZeRO-1's flat shard
  (``init_opt_state(params, ctx)``) or, under FSDP, m and v shaped like
  the shards;
- the batch: the train step takes the global batch on every rank and
  picks its rows (``parallel.microbatch_rows``); prefill and decode take
  the rank's rows where the data axes divide the batch, else all of them;
- the decode cache is the port's ``init_cache`` over the rank's
  parameters, its slots cut over the data axes where the batch is not
  (``long_500k``'s batch of 1: ``cache_specs``' sequence-sharded cache).

Eager counting visits every layer, so the full-depth run is exact;
``measure_costs`` keeps the JAX package's extrapolation from one and two
repeats of the last layer group (``_reduced``), which must agree with it.

    python -m repro_torch.launch.dryrun --arch dbrx-132b --shape train_4k
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import time
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.bridge import to_jax_layout
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import hw
from repro_torch.core.tree import param_leaves
from repro_torch.core.types import (INPUT_SHAPES, SHAPES_BY_NAME, MeshConfig,
                                    ModelConfig, ShapeConfig, TrainConfig)
from repro_torch.launch.analysis import (Account, cost_summary, measure,
                                         memory_summary)
from repro_torch.launch.mesh import fake_world, mesh_config, mesh_groups
from repro_torch.launch.specs import (cache_shapes, context_spec,
                                      decode_window, input_specs,
                                      uses_swa_variant)
from repro_torch.models.transformer import (decode_step, forward, init_cache,
                                            init_params)
from repro_torch.optim.adamw import init_opt_state
from repro_torch.parallel.fsdp import fsdp_shard
from repro_torch.parallel.planner import (_axis_size, _bspec, _leaf_rule,
                                          make_ctx, tp_dims)
from repro_torch.serve.step import make_prefill
from repro_torch.train.step import make_train_step

FSDP_THRESHOLD_BYTES = 4 * 2 ** 30  # params/device above this -> FSDP
RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun_torch")
META = torch.device("meta")


def _mesh_name(mcfg: MeshConfig) -> str:
    return "x".join(str(n) for n in mcfg.shape)


def _world(mcfg: MeshConfig, rank: int):
    """This process as ``rank`` of a fresh fake world of the mesh's size;
    returns (data group, model group)."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry-run needs a process of its own: "
                               "torch.distributed is initialised with "
                               f"{dist.get_backend()!r}")
        dist.destroy_process_group()
    fake_world(mcfg.num_devices, rank)
    return mesh_groups(mcfg)


def _jax_items(tree, prefix: str = ""):
    """(path, leaf) in the JAX package's flattening order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jax_items(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def reference_notes(cfg: ModelConfig, mcfg: MeshConfig, shapes=None) -> list:
    """The planner notes of the JAX package's ``param_specs`` on its own
    tree: the port's parameter shapes in the JAX layout (each leaf stacked
    over its group's repeats), each leaf's rule on its unstacked shape,
    leaves in JAX's order."""
    shapes = init_params(cfg, torch.Generator(), device=META) \
        if shapes is None else shapes
    tree = to_jax_layout(cfg, shapes, lambda t: tuple(t.shape),
                         lambda xs: (len(xs), *xs[0]))
    notes: list = []
    for path, shape in _jax_items(tree):
        stacked = bool(re.search(r"group\d+", path)) or "/cross/" in path
        _leaf_rule(path, shape[1:] if stacked else shape, cfg, mcfg, notes)
    return notes


def _rows(n: int, dp: int) -> int:
    return n // dp if n % dp == 0 else n


def _local_cache(cfg, shape: ShapeConfig, params, ctx, mcfg: MeshConfig):
    """This rank's decode cache: ``init_cache`` over its parameters and its
    rows of the batch, the slots of the self-attention and MLA caches cut
    over the data axes where the batch is not divisible."""
    dp = _axis_size(mcfg, _bspec(mcfg))
    b = shape.global_batch
    rows = _rows(b, dp)
    context = context_spec(cfg, rows, torch.bfloat16)
    cache = init_cache(cfg, params, rows, shape.seq_len, torch.bfloat16,
                       context=context, window=decode_window(cfg, shape),
                       ctx=ctx)
    if b % dp == 0:
        return cache

    def cut(t):
        n = t.shape[1]
        return t[:, :n // dp].clone() if n % dp == 0 else t
    cache["layers"] = [{k: cut(t) if k in ("k", "v", "c", "k_rope") else t
                        for k, t in lc.items()} for lc in cache["layers"]]
    return cache


def build_dryrun(arch: str, shape_name: str, *, multi_pod: bool = False,
                 fsdp: Optional[bool] = None, causal_skip: bool = False,
                 remat: Optional[bool] = None, unroll: bool = False,
                 microbatches: int = 1, grad_dtype: str = "f32",
                 pad_heads: bool = False, ws_decode: bool = False,
                 cfg_override: Optional[ModelConfig] = None,
                 extra_notes: Optional[list] = None,
                 mesh: Optional[MeshConfig] = None,
                 shape: Optional[ShapeConfig] = None, rank: int = 0,
                 gather_logits: bool = False):
    """One (arch x shape x mesh) combination.  Returns (program, meta):
    ``program()`` runs rank ``rank``'s step once on meta tensors and
    returns its ``launch.analysis.Account``; ``meta`` holds the JAX
    package's keys (``cache_bytes`` for decode).

    Beyond the JAX package's keywords: ``mesh`` and ``shape`` replace the
    production mesh and the named shape (smaller runs to hold against the
    card); ``gather_logits``: prefill through ``serve.step.make_prefill``,
    whose logits are gathered over the model ranks, instead of
    ``forward``, whose logits stay sharded (the JAX package's)."""
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = shape if shape is not None else SHAPES_BY_NAME[shape_name]
    mcfg = mesh if mesh is not None else mesh_config(multi_pod=multi_pod)
    if pad_heads:
        # pad query heads up to the TP degree so attention shards
        # (zero-init extra heads are function-preserving at init time)
        tp0 = mcfg.tp
        new_h = ((cfg.num_heads + tp0 - 1) // tp0) * tp0
        cfg = dataclasses.replace(cfg, num_heads=new_h,
                                  head_dim=cfg.resolved_head_dim)
    notes = extra_notes if extra_notes is not None else []
    full = init_params(cfg, torch.Generator(), dtype=torch.bfloat16,
                       device=META)
    notes.extend(reference_notes(cfg, mcfg, full))
    param_bytes = sum(t.numel() * t.element_size()
                      for t in param_leaves(full))
    tp = mcfg.tp
    if fsdp is None:
        fsdp = param_bytes / tp > FSDP_THRESHOLD_BYTES
    if fsdp:
        notes.append(f"fsdp=True (param_bytes/tp = "
                     f"{param_bytes / tp / 2**30:.1f} GiB)")
    if remat is None:
        remat = shape.kind == "train"
    meta: Dict[str, Any] = {
        "arch": arch, "shape": shape.name, "mesh": _mesh_name(mcfg),
        "kind": shape.kind, "fsdp": bool(fsdp),
        "swa_variant": uses_swa_variant(cfg, shape),
        "causal_skip": causal_skip,
        "param_bytes": param_bytes,
        "notes": list(notes),
    }
    if shape.kind == "decode":
        meta["cache_bytes"] = sum(
            t.numel() * t.element_size()
            for t in param_leaves(cache_shapes(cfg, shape, full)))
    del full

    def program() -> Account:
        dgroup, mgroup = _world(mcfg, rank)
        try:
            ctx = make_ctx(dgroup, mcfg, model_group=mgroup, remat=remat,
                           cfg=cfg, causal_skip=causal_skip,
                           unroll_layers=unroll, fsdp=bool(fsdp),
                           ep_weight_stationary=ws_decode)
            return _run(cfg, shape, mcfg, ctx, bool(fsdp), microbatches,
                        grad_dtype, remat, gather_logits)
        finally:
            dist.destroy_process_group()

    return program, meta


def _run(cfg, shape: ShapeConfig, mcfg: MeshConfig, ctx, fsdp: bool,
         microbatches: int, grad_dtype: str, remat: bool,
         gather_logits: bool) -> Account:
    if ctx.tensor_parallel:  # built once per config, outside the counts
        tp_dims(cfg, ctx)
    params = init_params(cfg, torch.Generator(), dtype=torch.bfloat16,
                         device=META, ctx=ctx)
    if fsdp:
        params = fsdp_shard(params, ctx)
    ins = input_specs(cfg, shape)
    args = list(param_leaves(params))
    if shape.kind == "train":
        tcfg = TrainConfig(microbatches=microbatches, grad_dtype=grad_dtype,
                           remat=remat)
        zero1 = ctx.dp > 1 and tcfg.zero1 and not fsdp
        opt = init_opt_state(params, ctx if zero1 else None)
        step = make_train_step(cfg, tcfg, ctx)
        args += list(param_leaves(opt)) + list(ins.values())
        return measure(lambda: step(params, opt, ins), args)
    rows = _rows(shape.global_batch, ctx.dp)
    if shape.kind == "prefill":
        tokens = ins["tokens"][:rows].clone()
        context = ins.get("context")
        context = None if context is None else context[:rows].clone()
        args += [tokens] + ([] if context is None else [context])
        if gather_logits:
            prefill = make_prefill(cfg, ctx)
            return measure(lambda: _no_grad(prefill, params, tokens,
                                            context), args)
        return measure(lambda: _no_grad(
            lambda p, t, c: forward(cfg, p, t, context=c, ctx=ctx)[0],
            params, tokens, context), args)
    cache = _local_cache(cfg, shape, params, ctx, mcfg)
    tokens = ins["tokens"][:rows].clone()
    args += list(param_leaves(cache)) + [tokens]
    win = decode_window(cfg, shape)
    return measure(lambda: _no_grad(
        lambda p, c, t: decode_step(cfg, p, c, t, shape.seq_len - 1,
                                    ctx=ctx, window=win)[0],
        params, cache, tokens), args)


def _no_grad(fn, *args):
    with torch.no_grad():
        return fn(*args)


# ---------------------------------------------------------------------------
# Cost accounting: the full-depth run, and the JAX package's extrapolation
# ---------------------------------------------------------------------------
#
# XLA's cost analysis visits a while-loop body once, so the JAX package
# compiles tiny unrolled variants (last layer group at 1 and 2 repeats;
# encoder at 1 and 2 layers) and extrapolates linearly.  Eager counting
# visits every layer; the extrapolation is kept and held against the
# full-depth count.


def _cost_vector(account: Account) -> Dict[str, float]:
    cost = cost_summary(account)
    coll = account.collectives
    vec = {"flops": cost["flops"], "bytes": cost["bytes"],
           "transcendentals": cost["transcendentals"],
           "collective_bytes": float(coll.total_bytes),
           "wire_bytes": float(coll.sent_bytes)}
    for k, v in coll.bytes_by_kind.items():
        vec[f"coll_{k}"] = float(v)
    for k, v in coll.count_by_kind.items():
        vec[f"count_{k}"] = float(v)
    return vec


def _vec_add(a, b, scale=1.0):
    keys = set(a) | set(b)
    return {k: a.get(k, 0.0) + scale * b.get(k, 0.0) for k in keys}


def _reduced(cfg: ModelConfig, last_repeats: int,
             encoder_layers: Optional[int] = None) -> ModelConfig:
    groups = cfg.layer_groups()
    assert all(r == 1 for _, r in groups[:-1]), \
        "cost extrapolation assumes only the last group repeats"
    n = sum(len(p) for p, _ in groups[:-1]) + len(groups[-1][0]) * last_repeats
    kw = {"num_layers": n}
    if cfg.is_encoder_decoder:
        kw["encoder_layers"] = (encoder_layers if encoder_layers is not None
                                else 1)
    return dataclasses.replace(cfg, **kw)


def _fsdp_default(cfg: ModelConfig, mcfg: MeshConfig) -> bool:
    full = init_params(cfg, torch.Generator(), dtype=torch.bfloat16,
                       device=META)
    pb = sum(t.numel() * t.element_size() for t in param_leaves(full))
    return pb / mcfg.tp > FSDP_THRESHOLD_BYTES


def measure_costs(arch: str, shape_name: str, *, multi_pod: bool = False,
                  fsdp: Optional[bool] = None, unroll: bool = True,
                  **kw) -> Dict[str, float]:
    """The whole-model cost vector from reduced-depth runs (the JAX
    package's ``unroll=True`` by default), extrapolated linearly."""
    cfg = kw.pop("cfg_override", None) or get_config(arch)
    mcfg = kw.get("mesh") or mesh_config(multi_pod=multi_pod)
    # pin fsdp from the full-size config so variants shard identically
    if fsdp is None:
        fsdp = _fsdp_default(cfg, mcfg)

    def run_cost(c):
        program, _ = build_dryrun(arch, shape_name, multi_pod=multi_pod,
                                  fsdp=fsdp, unroll=unroll, cfg_override=c,
                                  **kw)
        return _cost_vector(program())

    last_r = cfg.layer_groups()[-1][1]
    base = run_cost(_reduced(cfg, 1))
    total = dict(base)
    if last_r > 1:
        var = run_cost(_reduced(cfg, 2))
        per_layer = _vec_add(var, base, scale=-1.0)
        total = _vec_add(total, per_layer, scale=float(last_r - 1))
    if cfg.is_encoder_decoder and cfg.encoder_layers > 1:
        var_e = run_cost(_reduced(cfg, 1, encoder_layers=2))
        per_enc = _vec_add(var_e, base, scale=-1.0)
        total = _vec_add(total, per_enc, scale=float(cfg.encoder_layers - 1))
    return total


def analyse(meta, mem, costs) -> Dict[str, Any]:
    cfg = get_config(meta["arch"])
    shape = SHAPES_BY_NAME.get(meta["shape"])
    chips = math.prod(int(n) for n in meta["mesh"].split("x"))

    terms = hw.roofline_seconds(costs["flops"], costs["bytes"],
                                costs["collective_bytes"], chips=1)
    dominant = max(terms, key=terms.get)

    pc = cfg.param_counts()
    kind = meta["kind"]
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len if shape else 0
        model_flops = 6 * pc["active"] * tokens  # fwd+bwd
    elif kind == "prefill":
        tokens = shape.global_batch * shape.seq_len if shape else 0
        model_flops = 2 * pc["active"] * tokens
    else:
        tokens = shape.global_batch if shape else 0
        model_flops = 2 * pc["active"] * tokens
    useful_ratio = model_flops / max(costs["flops"] * chips, 1.0)

    return dict(
        meta,
        chips=chips,
        flops_per_device=costs["flops"],
        bytes_per_device=costs["bytes"],
        transcendentals=costs["transcendentals"],
        collective_bytes_per_device=costs["collective_bytes"],
        collectives_by_kind={k[5:]: v for k, v in costs.items()
                             if k.startswith("coll_")},
        collective_counts={k[6:]: v for k, v in costs.items()
                           if k.startswith("count_")},
        memory=mem,
        roofline=terms,
        dominant=dominant,
        model_flops=model_flops,
        useful_flops_ratio=useful_ratio,
    )


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            save: bool = True, verbose: bool = True, skip_costs: bool = False,
            **kw) -> Dict[str, Any]:
    """1) the full-depth run: the memory a rank, and (``skip_costs``) its
    counts as the cost vector; 2) otherwise the cost vector from the
    reduced-depth runs (``measure_costs``), as the JAX package takes it."""
    t0 = time.time()
    program, meta = build_dryrun(arch, shape_name, multi_pod=multi_pod, **kw)
    t1 = time.time()
    account = program()
    t2 = time.time()
    mem = memory_summary(account)
    if skip_costs:
        costs = _cost_vector(account)
    else:
        costs = measure_costs(arch, shape_name, multi_pod=multi_pod, **kw)
    t3 = time.time()
    result = analyse(meta, mem, costs)
    result["wire_bytes_per_device"] = costs.get("wire_bytes", 0.0)
    result["build_s"] = round(t1 - t0, 2)
    result["run_s"] = round(t2 - t1, 2)
    result["cost_measure_s"] = round(t3 - t2, 2)
    if verbose:
        r = result["roofline"]
        print(f"[{arch} x {shape_name} x {result['mesh']}] "
              f"fsdp={result['fsdp']} swa_variant={result['swa_variant']} "
              f"param_bytes={result['param_bytes']} "
              f"flops={costs['flops']:.6g} bytes={costs['bytes']:.6g} "
              f"collective={costs['collective_bytes']:.6g} "
              f"by_kind={json.dumps(result['collectives_by_kind'])} "
              f"compute={r['compute_s']*1e3:.3f}ms "
              f"memory={r['memory_s']*1e3:.3f}ms "
              f"collective={r['collective_s']*1e3:.3f}ms "
              f"dominant={result['dominant']} "
              f"useful={result['useful_flops_ratio']:.3f} "
              f"temp={mem['temp_size_in_bytes']/2**30:.2f}GiB "
              f"(build {result['build_s']}s run {result['run_s']}s "
              f"costs {result['cost_measure_s']}s)", flush=True)
    if save:
        os.makedirs(RESULTS_DIR, exist_ok=True)

        def _default(v):
            # identity-safe default check (True == 1 in Python!)
            return v is None or v is False or v == "f32" or \
                (v == 1 and v is not True)

        tag = f"{arch}_{shape_name}_{result['mesh']}"
        for k, v in sorted(kw.items()):
            if not _default(v):
                tag += f"_{k}-{v}"
        result["variant_kwargs"] = {k: v for k, v in kw.items()
                                    if not _default(v)}
        with open(os.path.join(RESULTS_DIR, tag + ".json"), "w") as f:
            json.dump(result, f, indent=1, default=str)
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry-run of the port "
                                             "(host only, meta tensors)")
    ap.add_argument("--arch", default=None, choices=ARCHS + [None])
    ap.add_argument("--shape", default=None,
                    choices=[s.name for s in INPUT_SHAPES] + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--causal-skip", action="store_true")
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--skip-costs", action="store_true",
                    help="the full-depth run only (its counts are the cost "
                         "vector; no reduced-depth extrapolation)")
    ap.add_argument("--resume", action="store_true",
                    help="skip combinations whose result JSON exists")
    args = ap.parse_args()

    archs = [args.arch] if args.arch else ARCHS
    shapes = [args.shape] if args.shape else [s.name for s in INPUT_SHAPES]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                if args.resume:
                    mesh_tag = "2x16x16" if mp else "16x16"
                    fp = os.path.join(RESULTS_DIR,
                                      f"{arch}_{shape}_{mesh_tag}.json")
                    if os.path.exists(fp):
                        print(f"skip (exists): {arch} x {shape} x {mesh_tag}")
                        continue
                try:
                    run_one(arch, shape, multi_pod=mp,
                            causal_skip=args.causal_skip,
                            skip_costs=args.skip_costs,
                            save=not args.no_save)
                except Exception as e:  # noqa: BLE001 — report and continue
                    failures.append((arch, shape, mp, repr(e)[:200]))
                    print(f"FAIL [{arch} x {shape} x mp={mp}]: {e!r}")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nall dry-runs passed")


if __name__ == "__main__":
    main()
