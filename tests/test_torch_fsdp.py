"""FSDP as a path (``repro_torch.parallel.fsdp``, ``make_ctx(...,
fsdp=True)``) against the JAX package's step under ``apply_fsdp``
shardings, against the port's ZeRO-1 step and the single rank, at smoke
size on the CPU, f32.

For each mesh, (2, 1) and (2, 2): one ``spawn_ranks`` of its gloo ranks
runs every case (``tests/torch_fsdp_ranks.py``) while one JAX subprocess
on as many forced host devices runs the JAX step on an Auto-axis mesh
(ROADMAP R5) with ``apply_fsdp`` parameter specs and their ``zero1_spec``
optimizer-state specs.  The initial parameters are the JAX package's
(``init_params``, key 0), the batch numpy from a seed; the tolerances and
the update check are ``tests/test_torch_parallel.py``'s."""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import concurrent.futures
import functools
import json

import jax
import numpy as np
import pytest

from helpers import run_multidevice
from repro.configs import smoke_config as jax_smoke_config
from repro.models import init_params as jax_init_params
from repro_torch.launch.ranks import spawn_ranks
from torch_dp_ranks import flatten, update_errors
from torch_fsdp_ranks import fsdp_cases

TOL = dict(atol=1e-5, rtol=1e-5)
ADAMW_TOL = 1e-3
UPDATE_RTOL = 1e-2
BATCH, SEQ = 8, 32
BASE = dict(learning_rate=1e-3, warmup_steps=1)
CASES = {
    "fsdp": {"arch": "qwen2-0.5b", "tcfg": dict(BASE, remat=False)},
    "fsdp_remat_mb2": {"arch": "qwen2-0.5b",
                       "tcfg": dict(BASE, remat=True, microbatches=2)},
    "fsdp_mamba2": {"arch": "mamba2-130m", "tcfg": dict(BASE, remat=False)},
    "serve": {"arch": "qwen2-0.5b", "tcfg": dict(BASE, remat=False),
              "serve": True},
}
STEPS = [n for n, c in CASES.items() if not c.get("serve")]

_JAX_SCRIPT = """
import json, sys
import jax
import numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import smoke_config
from repro.core.types import MeshConfig, TrainConfig
from repro.models import init_params
from repro.optim.adamw import init_opt_state
from repro.parallel.planner import apply_fsdp, make_ctx, param_specs, zero1_spec
from repro.train.step import make_train_step

inputs, cases_json, out_path, dp, tp = sys.argv[1:6]
data = np.load(inputs)
cases = json.loads(cases_json)
mesh = jax.make_mesh((int(dp), int(tp)), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
mcfg = MeshConfig((int(dp), int(tp)))
is_p = lambda x: isinstance(x, P)
shard = lambda sp: NamedSharding(mesh, sp)

def flat(tree, prefix):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {prefix + "|" + "/".join(str(k.key) for k in kp): np.asarray(
        leaf, np.float32) for kp, leaf in leaves}

out = {}
for name, case in cases.items():
    if case.get("serve"):
        continue
    cfg = smoke_config(case["arch"])
    tc = dict(case["tcfg"])
    remat = tc.pop("remat")
    tcfg = TrainConfig(**tc)
    ctx = make_ctx(mesh, mcfg, remat=remat, use_ep=False)
    params = init_params(cfg, jax.random.PRNGKey(0))
    specs = apply_fsdp(param_specs(cfg, mcfg), params, mcfg)
    params = jax.device_put(params, jax.tree.map(shard, specs, is_leaf=is_p))
    opt = init_opt_state(params)
    ospec = {k: jax.tree.map(lambda sp, a: zero1_spec(sp, a.shape, mcfg),
                             specs, opt[k], is_leaf=is_p) for k in ("m", "v")}
    ospec["step"] = P()
    opt = jax.device_put(opt, jax.tree.map(shard, ospec, is_leaf=is_p))
    batch = jax.device_put({k: data["batch|" + k]
                            for k in ("tokens", "labels")},
                           shard(P("data", None)))
    params, opt, metrics = jax.jit(make_train_step(cfg, tcfg, ctx))(
        params, opt, batch)
    out.update(flat(params, name + "|params"))
    out.update(flat(opt["m"], name + "|m"))
    out.update(flat(opt["v"], name + "|v"))
    for k, v in metrics.items():
        out[name + "|metric|" + k] = np.asarray(v, np.float32)
np.savez(out_path, **out)
print("OK")
"""


@functools.lru_cache(maxsize=None)
def _initial(arch: str) -> dict:
    jp = jax_init_params(jax_smoke_config(arch), jax.random.PRNGKey(0))
    return flatten(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module", params=[(2, 1), (2, 2)], ids=["2x1", "2x2"])
def runs(request, tmp_path_factory):
    """Every case on the mesh's ranks, and the JAX step beside them."""
    dp, tp = request.param
    tmp = tmp_path_factory.mktemp(f"fsdp{dp}x{tp}")
    data = {}
    for arch in {c["arch"] for c in CASES.values()}:
        data.update({f"{arch}|{k}": v for k, v in _initial(arch).items()})
    tok = np.random.default_rng(0).integers(0, 512, (BATCH, SEQ)) \
        .astype(np.int32)
    data["batch|tokens"], data["batch|labels"] = tok, np.roll(tok, -1, 1)
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **data)
    script = (f"import sys; sys.argv = ['', {inputs!r}, "
              f"{json.dumps(CASES)!r}, {str(tmp / 'jax.npz')!r}, "
              f"'{dp}', '{tp}']\n" + _JAX_SCRIPT)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(run_multidevice, script, num_devices=dp * tp,
                              timeout=300)
        ranks = spawn_ranks(fsdp_cases, dp * tp, (dp, tp), inputs, CASES,
                            timeout_s=300)
        jax_run.result()
    return (dp, tp), ranks, dict(np.load(tmp / "jax.npz"))


def _tree(out: dict, name: str, kind: str) -> dict:
    pre = f"{name}|{kind}|"
    return {k[len(pre):]: v for k, v in out.items() if k.startswith(pre)}


@pytest.mark.parametrize("name", STEPS)
def test_fsdp_step_matches_jax(runs, name):
    """One FSDP step against JAX's step under ``apply_fsdp``: the metrics
    within 1e-5 (grad_norm 5e-5 for mamba2), the parameters through their
    AdamW update, m and v within 1e-5, leaf for leaf in the JAX layout."""
    _, ranks, jax_out = runs
    case = CASES[name]
    got = ranks[0][name]
    for k in ("loss", "ce", "aux", "lr", "grad_norm"):
        rel = 5e-5 if k == "grad_norm" and "mamba" in case["arch"] else 1e-5
        assert got["metrics"][k] == pytest.approx(
            float(jax_out[f"{name}|metric|{k}"]), rel=rel, abs=1e-7), k
    want = _tree(jax_out, name, "params")
    assert sorted(want) == sorted(got["params"])
    err = update_errors(_initial(case["arch"]), got["params"], want,
                        got["m"], got["v"], case["tcfg"],
                        got["metrics"]["lr"])
    assert err["adamw"] <= ADAMW_TOL, err
    assert err["update"] <= UPDATE_RTOL, err
    for kind in ("m", "v"):
        w = _tree(jax_out, name, kind)
        for k in w:
            np.testing.assert_allclose(got[kind][k], w[k], err_msg=k, **TOL)


@pytest.mark.parametrize("name", STEPS)
def test_fsdp_step_matches_zero1(runs, name):
    """The FSDP step against the port's ZeRO-1 step on the same ranks: the
    metrics within 1e-5, m and v within 1e-5 of their largest value, the
    parameters through their update; the gathered parameters the same bits
    on every data rank of a model index."""
    _, ranks, _ = runs
    got = ranks[0][name]
    z = got["zero1"]
    for k in ("loss", "ce", "aux", "lr", "grad_norm"):
        assert got["metrics"][k] == pytest.approx(
            got["zero1_metrics"][k], rel=1e-5, abs=1e-7), k
    for kind in ("m", "v"):
        for k, w in z[kind].items():
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(got[kind][k] - w).max()) <= 1e-5 * scale, k
    err = update_errors(_initial(CASES[name]["arch"]), got["params"],
                        z["params"], got["m"], got["v"],
                        CASES[name]["tcfg"], got["metrics"]["lr"])
    assert err["adamw"] <= ADAMW_TOL, err
    assert err["update"] <= UPDATE_RTOL, err
    tp = runs[0][1]
    for m in range(tp):  # the data ranks of each model index
        sums = {r[name]["params_checksum"] for r in ranks[m::tp]}
        assert len(sums) == 1, (m, sums)


@pytest.mark.parametrize("name", STEPS)
def test_gradient_shards_are_slices_of_the_full_gradient(runs, name):
    """Each rank's gradient of each shard (after the gather's backward
    reduce-scattered it) equals its slice of the single process's
    whole-batch gradient, within 1e-5 of the leaf's largest entry."""
    _, ranks, _ = runs
    for r in ranks:
        assert r[name]["grad_shard_err"] <= 1e-5, r[name]["grad_shard_err"]


def test_fsdp_prefill_and_decode_match_single_rank(runs):
    """Prefill and an 8-token decode replay on the FSDP shards give the
    single rank's logits on the same rows; a rank holds 1/dp of its
    model-axis part of the parameters."""
    (dp, tp), ranks, _ = runs
    for r in ranks:
        got = r["serve"]
        assert got["prefill_err"] <= 1e-5, got
        assert got["decode_err"] <= 1e-5, got
        assert got["shard_bytes"] * dp == got["whole_bytes"], got
