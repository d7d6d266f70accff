"""Rank functions of the port's data-parallel tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_cuda.py``), run by
``repro_torch.launch.ranks.spawn_ranks``.  A spawned rank imports this module
by name, so it imports torch and the port only (no jax), and every function
here is at top level."""
import numpy as np
import torch

from repro_torch.bridge import params_from_jax, params_to_jax_layout
from repro_torch.configs import smoke_config
from repro_torch.core.types import MeshConfig, TrainConfig
from repro_torch.launch.mesh import mesh_groups
from repro_torch.launch.train import checksum
from repro_torch.models import param_leaves
from repro_torch.optim import gather_opt_state, init_opt_state
from repro_torch.parallel import make_ctx, planner
from repro_torch.train import make_train_step


def nest(flat: dict) -> dict:
    """{"a/b/c": x} -> {"a": {"b": {"c": x}}}."""
    tree: dict = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = value
    return tree


def flatten(tree: dict, prefix: str = "") -> dict:
    """The inverse of ``nest``."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(flatten(v, key) if isinstance(v, dict) else {key: v})
    return out


def _flat_grad(grads) -> np.ndarray:
    if isinstance(grads, torch.Tensor):
        return grads.float().numpy().copy()
    return torch.cat([g.reshape(-1).float() for g in grads]).numpy()


def dp_cases(rank: int, world: int, inputs_path: str, cases: dict) -> dict:
    """Every data-parallel case of ``tests/test_torch_parallel.py`` on this
    rank.  ``inputs_path``: an .npz of the JAX package's initial parameters
    (``<arch>|<path>``) and of the global batches (``batch|<name>|tokens``,
    ``...|labels``).  ``cases``: name -> {"arch", "tcfg" (TrainConfig
    fields), "impl", "steps", "batch", and where given "bucket_values",
    the gradient bucket in values (``planner.BUCKET_VALUES``)}.  Returns
    name -> this rank's metrics a step, parameter checksum and ZeRO-1
    shard size; rank 0 adds the parameters and the full m and v in the
    JAX layout; with a quantizing sync every rank adds its gradient before
    the sync ("local") and after it ("synced"), flat, of the first step."""
    data = np.load(inputs_path)
    mesh_cfg = MeshConfig((world, 1))
    out = {}
    default_bucket = planner.BUCKET_VALUES
    for name, case in cases.items():
        planner.BUCKET_VALUES = case.get("bucket_values", default_bucket)
        cfg = smoke_config(case["arch"])
        tree = nest({k.split("|", 1)[1]: data[k] for k in data.files
                     if k.startswith(case["arch"] + "|")})
        params = params_from_jax(cfg, tree, device="cpu")
        tcfg = TrainConfig(**case["tcfg"])
        ctx = make_ctx(mesh_groups(mesh_cfg)[0], mesh_cfg, remat=tcfg.remat,
                       grad_all_reduce=case.get("impl", "ring"))
        opt = init_opt_state(params, ctx if tcfg.zero1 else None)
        batch = {k: data[f"batch|{case['batch']}|{k}"]
                 for k in ("tokens", "labels")}
        step = make_train_step(cfg, tcfg, ctx)
        seen: dict = {}

        def hook(stage, grads):
            seen[stage] = _flat_grad(grads)

        metrics = []
        for s in range(case.get("steps", 1)):
            params, opt, m = step(params, opt, batch,
                                  grad_hook=hook if s == 0 else None)
            metrics.append({k: float(v) for k, v in m.items()})
        full = gather_opt_state(opt, ctx, params) if tcfg.zero1 else opt
        res = {"metrics": metrics, "checksum": checksum(params),
               "m_values": opt["m"].numel() if tcfg.zero1 else None}
        if case.get("impl", "ring").startswith("ring_q"):
            res.update(seen)
        if rank == 0:
            res["params"] = flatten(params_to_jax_layout(cfg, params))
            for k in ("m", "v"):
                res[k] = flatten(params_to_jax_layout(cfg, full[k]))
        out[name] = res
    return out


def dp_on_card(rank: int, world: int, arch: str, tcfg: dict, seed: int
               ) -> dict:
    """One f32 data-parallel step at smoke size with every rank on the
    card (``rank_device``), from the parameters of ``init_params`` drawn
    on the CPU from ``seed`` and the first batch of ``make_batches``.
    Returns the metrics, the parameter checksum, the kernel launches and
    the device; rank 0 adds the parameters and the full moments."""
    from repro_torch.data import make_batches
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.ranks import rank_device
    from repro_torch.models import init_params, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = rank_device("cuda")
    cfg = smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(seed),
                         device="cpu")
    params = tree_map(lambda t: t.to(device), params)
    tcfg = TrainConfig(**tcfg)
    mesh_cfg = MeshConfig((world, 1))
    ctx = make_ctx(mesh_groups(mesh_cfg)[0], mesh_cfg, remat=tcfg.remat)
    opt = init_opt_state(params, ctx if tcfg.zero1 else None)
    batch = next(make_batches(cfg, 4, 128, seed=1))
    n0 = launch_counts()
    params, opt, m = make_train_step(cfg, tcfg, ctx)(params, opt, batch)
    torch.cuda.synchronize()
    n1 = launch_counts()
    full = gather_opt_state(opt, ctx, params) if tcfg.zero1 else opt
    res = {"metrics": {k: float(v) for k, v in m.items()},
           "checksum": checksum(params), "device": str(device),
           "launches": {k: n1[k] - n0[k] for k in n1 if n1[k] != n0[k]}}
    if rank == 0:
        res["params"] = [t.cpu().numpy() for t in param_leaves(params)]
        for k in ("m", "v"):
            res[k] = [t.cpu().numpy() for t in param_leaves(full[k])]
    return res



def update_errors(p0: dict, got: dict, want: dict, m: dict, v: dict,
                  tcfg: dict, lr: float) -> dict:
    """The first AdamW step's parameters held two ways (flat dicts of
    arrays, one key a leaf; ``m``, ``v``: the run's own moments after the
    step):

    - "adamw": the largest |got - AdamW(p0, m, v)| over the rate, with
      AdamW written out in f64 (step 1's bias corrections, decoupled weight
      decay), every element of every leaf: a skipped, mis-signed or
      mis-corrected update of any shard shows here;
    - "update": the largest ||(got - p0) - (want - p0)|| / ||want - p0||
      over the leaves, and the leaf ("worst_leaf"): the update against the
      reference's.

    Element by element the update cannot be held to the reference at a
    visible rate: at the first step it is lr * g / (|g| + eps), which
    turns the rounding of a gradient near eps, or a sign that rounding
    flips, into a change of up to 2 lr."""
    t = TrainConfig(**tcfg)
    adamw, update, worst = 0.0, 0.0, None
    for k, p in p0.items():
        p = p.astype(np.float64)
        mh = m[k].astype(np.float64) / (1 - t.beta1)
        vh = v[k].astype(np.float64) / (1 - t.beta2)
        ref = p - lr * (mh / (np.sqrt(vh) + t.eps) + t.weight_decay * p)
        adamw = max(adamw, float(np.abs(got[k] - ref).max()) / lr)
        du = np.linalg.norm(want[k].astype(np.float64) - p)
        err = np.linalg.norm(got[k] - want[k].astype(np.float64))
        r = float(err / du) if du else 0.0 if err == 0 else float("inf")
        if r >= update:
            update, worst = r, k
    return {"adamw": adamw, "update": update, "worst_leaf": worst}
