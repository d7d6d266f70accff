"""The port's data-parallel training step (plain DP and ZeRO-1 over the
ported ring collectives) against the JAX package's, at smoke size on the
CPU.

For each N in (2, 4): one ``spawn_ranks`` of N gloo ranks computes every
case (``torch_dp_ranks.dp_cases``), and one JAX subprocess on N forced host
devices runs the JAX step on an (N, 1) mesh whose axes are Auto (under the
default Explicit axes of jax 0.9.0 the ctx's sharding constraints raise:
ROADMAP R5), with the planner's parameter specs and, for ZeRO-1, its
``zero1_spec`` optimizer-state specs; dbrx's context has ``use_ep=False``
(with EP, JAX's ``moe_ep_train`` drops tokens by capacity).  The initial
parameters are the JAX package's (``init_params``, key 0), the batches
numpy from a seed.  Tolerances are ``tests/test_torch_train.py``'s:
1e-5; the bf16 gradient cast's m and v 2e-2; mamba2's grad_norm 5e-5.
The step runs at a rate that moves every parameter visibly (lr 1e-3 from
the first step), and the parameters are held through their update
(``torch_dp_ranks.update_errors``).
"""
import functools
import json

import jax
import numpy as np
import pytest

from helpers import run_multidevice
from repro.configs import smoke_config as jax_smoke_config
from repro.models import init_params as jax_init_params
from repro_torch.bridge import params_from_jax, params_to_jax_layout
from repro_torch.configs import smoke_config
from repro_torch.core.types import MeshConfig, TrainConfig
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.optim import init_opt_state
from repro_torch.parallel import make_ctx
from repro_torch.parallel.planner import BUCKET_VALUES
from repro_torch.train import make_train_step
from torch_ccl_ranks import (compressed_ring_emulation,
                             compressed_ring_final_scale)
from torch_dp_ranks import dp_cases, flatten, nest, update_errors

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
# With bf16 gradients each rank rounds its share to bf16 before the sync,
# which then sums in bf16 (the cast the JAX step's comment intends: it
# halves the sync's bytes); XLA's all-reduce sums in f32 and rounds once.
# So the norm of the synced gradient moves by a few bf16 roundings of its
# elements: held to one bf16 ulp (2^-8) of relative error.
BF16_NORM_RTOL = 2.0 ** -8
ARCHS = ("qwen2-0.5b", "mamba2-130m", "dbrx-132b")
BATCH, SEQ = 8, 32
# the first step at lr 1e-3 (no warmup), a hundred times the 1e-5 of the
# comparisons, so that an update that is skipped or wrong shows; AdamW's
# first update is about lr x sign(g)
BASE = dict(remat=False, learning_rate=1e-3, warmup_steps=1)
# the parameters after one step: within ADAMW_TOL x lr of AdamW written out
# from the run's own m and v, element by element (f32 rounding of p: about
# 6e-5 x lr at |p| = 1), and each leaf's update within UPDATE_RTOL of the
# reference's (f32: measured up to 4.9e-3, the rounding of gradients near
# eps; bf16: up to 6.0e-2 at DP-4, elements whose sign the bf16 sum of the
# ranks' shares flips against XLA's f32 sum).  A shard's update skipped
# gives >= 0.5, a flipped sign 2.
ADAMW_TOL = 1e-3
UPDATE_RTOL = 1e-2
BF16_UPDATE_RTOL = 0.125


def _case(arch="qwen2-0.5b", impl="ring", steps=1, batch="plain",
          jax_side=True, bucket_values=None, **tcfg):
    case = {"arch": arch, "impl": impl, "steps": steps, "batch": batch,
            "jax": jax_side, "tcfg": {**BASE, **tcfg}}
    if bucket_values:
        case["bucket_values"] = bucket_values
    return case


CASES = {
    "zero1": _case(zero1=True),
    "dp": _case(zero1=False),
    "zero1_mb2": _case(zero1=True, microbatches=2),
    "dp_mb2": _case(zero1=False, microbatches=2),
    "zero1_bf16": _case(zero1=True, grad_dtype="bf16"),
    "dp_bf16": _case(zero1=False, grad_dtype="bf16"),
    "zero1_remat_mb2_bf16": _case(zero1=True, remat=True, microbatches=2,
                                  grad_dtype="bf16"),
    "dp_remat": _case(zero1=False, remat=True),
    "mamba2_zero1": _case("mamba2-130m", zero1=True),
    "mamba2_dp": _case("mamba2-130m", zero1=False),
    "dbrx_zero1": _case("dbrx-132b", zero1=True),
    "dbrx_dp_mb2": _case("dbrx-132b", zero1=False, microbatches=2),
    # qwen2's smoke gradient (1.1M values) fits one 64 MiB bucket: these
    # cut it into 12 ragged buckets, each padded to the ranks
    "zero1_buckets": _case(zero1=True, bucket_values=99_991),
    "dp_buckets": _case(zero1=False, bucket_values=99_991),
    "ignore_zero1": _case(batch="ignore", zero1=True),
    "ignore_dp_mb2": _case(batch="ignore", zero1=False, microbatches=2),
    # lossless syncs against the port's single-process step
    "bidir_ring": _case(impl="bidir_ring", zero1=False, jax_side=False),
    "recursive_doubling": _case(impl="recursive_doubling", zero1=False,
                                jax_side=False),
    # quantizing syncs: the synced gradient against JAX's make_all_reduce
    "ring_q8": _case(impl="ring_q8", zero1=False, jax_side=False),
    "ring_q4": _case(impl="ring_q4", zero1=False, jax_side=False),
    "zero1_two_steps": _case(zero1=True, steps=2, jax_side=False),
    "dp_two_steps": _case(zero1=False, steps=2, jax_side=False),
}
LOSSLESS = ("dp", "bidir_ring", "recursive_doubling")


def _batches() -> dict:
    tok = np.random.default_rng(0).integers(
        0, 512, (BATCH, SEQ)).astype(np.int32)  # smoke vocab: 512
    labels = np.roll(tok, -1, 1)
    ignore = labels.copy()
    ignore[0, :30] = -1   # rank 0 of 2 and of 4 keeps 34 of 64 labels
    ignore[1, 3:20] = -1
    ignore[5, ::3] = -1
    ignore[6] = -1        # a row with none
    return {"plain": {"tokens": tok, "labels": labels},
            "ignore": {"tokens": tok, "labels": ignore}}


_JAX_SCRIPT = """
import json, sys
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.ccl.primitives import make_all_reduce
from repro.configs import smoke_config
from repro.core.types import MeshConfig, TrainConfig
from repro.models import init_params
from repro.optim.adamw import init_opt_state
from repro.parallel.planner import make_ctx, param_specs, zero1_spec
from repro.train.step import make_train_step

inputs, cases_json, out_path = sys.argv[1:4]
data = np.load(inputs)
cases = json.loads(cases_json)
n = len(jax.devices())
mesh = jax.make_mesh((n, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
mcfg = MeshConfig((n, 1))
is_p = lambda x: isinstance(x, P)
shard = lambda sp: NamedSharding(mesh, sp)

def flat(tree, prefix):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {prefix + "|" + "/".join(str(k.key) for k in kp): np.asarray(
        leaf, np.float32) for kp, leaf in leaves}

out = {}
for name, case in cases.items():
    if case["jax"]:
        cfg = smoke_config(case["arch"])
        tc = dict(case["tcfg"])
        remat = tc.pop("remat")
        tcfg = TrainConfig(**tc)
        ctx = make_ctx(mesh, mcfg, remat=remat, use_ep=False)
        specs = param_specs(cfg, mcfg)
        params = jax.device_put(init_params(cfg, jax.random.PRNGKey(0)),
                                jax.tree.map(shard, specs, is_leaf=is_p))
        opt = init_opt_state(params)
        if tcfg.zero1:
            ospec = {k: jax.tree.map(
                lambda sp, a: zero1_spec(sp, a.shape, mcfg), specs, opt[k],
                is_leaf=is_p) for k in ("m", "v")}
            ospec["step"] = P()
            opt = jax.device_put(opt, jax.tree.map(shard, ospec,
                                                   is_leaf=is_p))
        batch = jax.device_put(
            {k: data["batch|" + case["batch"] + "|" + k]
             for k in ("tokens", "labels")}, shard(P("data", None)))
        step = jax.jit(make_train_step(cfg, tcfg, ctx))
        params, opt, metrics = step(params, opt, batch)
        out.update(flat(params, name + "|params"))
        out.update(flat(opt["m"], name + "|m"))
        out.update(flat(opt["v"], name + "|v"))
        for k, v in metrics.items():
            out[name + "|metric|" + k] = np.asarray(v, np.float32)
    if name + "|local" in data.files:
        mesh1 = jax.make_mesh((n,), ("data",))
        out[name + "|synced"] = np.asarray(make_all_reduce(
            case["impl"], mesh1, "data")(jnp.asarray(data[name + "|local"])))
np.savez(out_path, **out)
print("OK")
"""


@functools.lru_cache(maxsize=None)
def _initial(arch: str) -> dict:
    """The JAX package's initial parameters of ``arch`` (key 0), flat."""
    jp = jax_init_params(jax_smoke_config(arch), jax.random.PRNGKey(0))
    return flatten(jax.tree.map(np.asarray, jp))


def _inputs(tmp) -> str:
    data = {}
    for arch in ARCHS:
        data.update({f"{arch}|{k}": v for k, v in _initial(arch).items()})
    for name, b in _batches().items():
        for k, v in b.items():
            data[f"batch|{name}|{k}"] = v
    path = str(tmp / "inputs.npz")
    np.savez(path, **data)
    return path


@pytest.fixture(scope="module", params=[2], ids=["dp2"])
def runs(request, tmp_path_factory):
    """Every case on 2 ranks and on JAX's 2 devices (4 of each:
    ``tests/test_torch_parallel_dp4.py``)."""
    return dp_runs(request.param, tmp_path_factory)


def dp_runs(n: int, tmp_path_factory):
    """Every case on N ranks and, where it has one, its JAX twin on N
    devices: (N, the ranks' results, JAX's arrays)."""
    tmp = tmp_path_factory.mktemp(f"dp{n}")
    inputs = _inputs(tmp)
    ranks = spawn_ranks(dp_cases, n, inputs, CASES, timeout_s=300)
    data = dict(np.load(inputs))
    for name in CASES:
        if "local" in ranks[0][name]:
            data[f"{name}|local"] = np.stack([r[name]["local"]
                                              for r in ranks])
    np.savez(tmp / "with_grads.npz", **data)
    run_multidevice(
        f"import sys; sys.argv = ['', {str(tmp / 'with_grads.npz')!r}, "
        f"{json.dumps(CASES)!r}, {str(tmp / 'jax.npz')!r}]\n"
        + _JAX_SCRIPT, num_devices=n, timeout=300)
    return n, ranks, dict(np.load(tmp / "jax.npz"))


def _close(got: dict, want: dict, prefix: str, **tol):
    keys = sorted(k for k in want if k.startswith(prefix + "|"))
    assert sorted(f"{prefix}|{k}" for k in got) == keys
    for k in keys:
        np.testing.assert_allclose(got[k.split("|", 2)[2]], want[k],
                                   err_msg=k, **tol)


JAX_CASES = [name for name, c in CASES.items() if c["jax"]]


@pytest.mark.parametrize("name", JAX_CASES)
def test_dp_step_matches_jax(runs, name):
    """One step on N ranks against JAX's DP or ZeRO-1 step on N devices:
    the global loss, ce, aux, lr and grad_norm, the updated parameters and
    the (gathered) moments, leaf for leaf in the JAX layout."""
    n, ranks, jax_out = runs
    case = CASES[name]
    got = ranks[0][name]
    ssm = case["arch"] == "mamba2-130m"
    bf16 = case["tcfg"].get("grad_dtype") == "bf16"
    for k in ("loss", "ce", "aux", "lr", "grad_norm"):
        rel = 1e-5
        if k == "grad_norm":
            rel = BF16_NORM_RTOL if bf16 else 5e-5 if ssm else 1e-5
        assert got["metrics"][0][k] == pytest.approx(
            float(jax_out[f"{name}|metric|{k}"]), rel=rel, abs=1e-7), k
    want = {k.split("|", 2)[2]: v for k, v in jax_out.items()
            if k.startswith(f"{name}|params|")}
    assert sorted(want) == sorted(got["params"])
    err = update_errors(_initial(case["arch"]), got["params"], want,
                        got["m"], got["v"], case["tcfg"],
                        got["metrics"][0]["lr"])
    assert err["adamw"] <= ADAMW_TOL, err
    assert err["update"] <= (BF16_UPDATE_RTOL if bf16 else UPDATE_RTOL), err
    for k in ("m", "v"):
        _close(got[k], jax_out, f"{name}|{k}", **(BF16_TOL if bf16 else TOL))


@pytest.mark.parametrize("name", LOSSLESS)
def test_lossless_dp_equals_single_process_step(runs, name):
    """A lossless sync (ring, bidir_ring, recursive doubling) on N ranks
    gives the port's single-process step on the whole batch: the metrics,
    m and v within 1e-5, the parameters through their update."""
    n, ranks, _ = runs
    case = CASES[name]
    cfg = smoke_config(case["arch"])
    p0 = _initial(case["arch"])
    params = params_from_jax(cfg, nest(p0), "cpu")
    params, opt, m = make_train_step(cfg, TrainConfig(**case["tcfg"]))(
        params, init_opt_state(params), _batches()[case["batch"]])
    got = ranks[0][name]
    for k, v in m.items():
        assert got["metrics"][0][k] == pytest.approx(float(v), rel=1e-5,
                                                     abs=1e-7), k
    for name_ in ("m", "v"):
        want = flatten(params_to_jax_layout(cfg, opt[name_]))
        assert sorted(want) == sorted(got[name_])
        for k in want:
            np.testing.assert_allclose(got[name_][k], want[k], err_msg=k,
                                       **TOL)
    want = flatten(params_to_jax_layout(cfg, params))
    err = update_errors(p0, got["params"], want, got["m"], got["v"],
                        case["tcfg"], got["metrics"][0]["lr"])
    assert err["adamw"] <= ADAMW_TOL, err
    assert err["update"] <= UPDATE_RTOL, err


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_sync_matches_jax_and_its_envelope(runs, bits):
    """``ring_q8`` / ``ring_q4``: the synced gradient the hook sees is
    bit-equal to the JAX package's hop algebra in IEEE f32
    (``compressed_ring_emulation``, applied bucket by bucket in the step's
    ``FlatLayout``), the same on every rank, and within p * absmax / qmax
    of the exact sum (tests/test_ccl_primitives.py:100-103).  Against
    JAX's jitted ``make_all_reduce(impl)`` on the same per-rank gradients:
    within 1e-6 everywhere but at most 1e-5 of the elements, each of those
    at most one quantization step of its bucket's final scale off.  That
    is D1 (ROADMAP Queue 3): under jit XLA computes the scale as
    absmax * (1/qmax), 1 ulp from the true quotient that the port and the
    eager reference compute, so a value on a rounding boundary takes the
    neighbouring q (at DP-2, q8: 1 of 1,115,904 elements, 1.1993e-4)."""
    n, ranks, jax_out = runs
    name = f"ring_q{bits}"
    local = np.stack([r[name]["local"] for r in ranks])
    synced = ranks[0][name]["synced"]
    for r in ranks:
        np.testing.assert_array_equal(r[name]["synced"], synced)
    want = np.empty_like(synced)
    step = np.empty_like(synced)
    for lo in range(0, synced.size, BUCKET_VALUES):
        hi = min(lo + BUCKET_VALUES, synced.size)
        want[lo:hi] = compressed_ring_emulation(local[:, lo:hi], bits)[0]
        step[lo:hi] = compressed_ring_final_scale(local[:, lo:hi], bits)
    np.testing.assert_array_equal(synced, want)
    diff = np.abs(synced - jax_out[f"{name}|synced"][0])
    off = diff > 1e-6
    count = int(off.sum())
    assert count <= 1e-5 * synced.size, \
        f"{count} of {synced.size} elements beyond 1e-6 of JAX's"
    assert (diff[off] <= step[off] * (1 + 1e-6)).all(), \
        f"{count} of {synced.size} elements beyond 1e-6 of JAX's, by up " \
        f"to {diff.max()}, beyond one quantization step"
    qmax = 2 ** (bits - 1) - 1
    bound = n * np.abs(local).max() / qmax
    assert np.abs(synced - local.sum(0)).max() <= bound


def test_zero1_holds_a_shard_of_the_moments(runs):
    """Each ZeRO-1 rank keeps 1/N of m and v (chunks padded to N values a
    bucket), and the gathered moments are the whole state (held against
    JAX's in ``test_dp_step_matches_jax``)."""
    n, ranks, _ = runs
    total = sum(v.size for v in ranks[0]["zero1"]["m"].values())
    for r in ranks:
        assert total <= n * r["zero1"]["m_values"] < total + n
        assert r["dp"]["m_values"] is None


@pytest.mark.parametrize("name", ["zero1_two_steps", "dp_two_steps"])
def test_ranks_identical_after_two_steps(runs, name):
    n, ranks, _ = runs
    assert len({r[name]["checksum"] for r in ranks}) == 1
    assert len({json.dumps(r[name]["metrics"]) for r in ranks}) == 1
    first, second = ranks[0][name]["metrics"]
    assert np.isfinite([first["loss"], second["loss"]]).all()


def test_model_axis_and_expert_parallel_raise():
    """A model axis > 1 runs every layer tensor-parallel and the MoE
    layers' experts expert-parallel beside it (tests/test_torch_tp.py,
    tests/test_torch_moe_ep.py), or without expert parallelism
    ``moe_dense`` on the rank's experts
    (tests/test_torch_tp_moe_dense.py): ``make_ctx`` picks EP for a MoE
    config and builds the context without it where asked; its layout
    splits the experts over the model axis, and ``ep_weight_stationary``
    means nothing there.  What raises is a mesh that the group does not
    match."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import fake_world, mesh_groups
    from repro_torch.parallel.planner import sharded_experts, tp_layout
    mcfg = MeshConfig((1, 2))
    fake_world(2, rank=1)
    try:
        dgroup, mgroup = mesh_groups(mcfg)
        for arch in ("dbrx-132b", "deepseek-v2-236b"):
            cfg = smoke_config(arch)
            assert make_ctx(dgroup, mcfg, model_group=mgroup, cfg=cfg).use_ep
            ctx = make_ctx(dgroup, mcfg, model_group=mgroup, use_ep=False,
                           ep_weight_stationary=True, cfg=cfg)
            assert not ctx.use_ep and ctx.tensor_parallel
            assert ctx.model_rank == 1 and not sharded_experts(ctx)
            assert tp_layout(cfg, ctx).experts
        with pytest.raises(ValueError, match="model group"):
            make_ctx(dgroup, mcfg, use_ep=False, cfg=cfg)
    finally:
        dist.destroy_process_group()


def test_zero1_without_sharded_state_raises():
    """A ZeRO-1 step given full moments says what it needs (checked with
    a stand-in context of two ranks, before any communication)."""
    from repro_torch.parallel import ParallelCtx
    cfg = smoke_config("qwen2-0.5b")
    jp = jax_init_params(jax_smoke_config("qwen2-0.5b"),
                         jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jp), "cpu")
    ctx = ParallelCtx(dp=2, remat=False)
    step = make_train_step(cfg, TrainConfig(**BASE), ctx)
    batch = _batches()["plain"]
    with pytest.raises(ValueError, match="sharded state"):
        step(params, init_opt_state(params), batch)
