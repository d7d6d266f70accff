"""The port's expert-parallel MoE (``repro_torch.models.moe``: the
all-to-all dispatch of ``moe_ep_train``, the all-reduce combine of
``moe_ep_decode``, the weight-stationary ``moe_ep_decode_ws``) and the
model, decode and training step over a data x model mesh, against the JAX
package at smoke size on the CPU.

For each mesh, (2, 2) and (1, 4): one ``spawn_ranks`` of 4 gloo ranks
computes every case (``torch_ep_ranks.ep_cases``), and, at the same time,
one JAX subprocess on 4 forced host devices computes the JAX package's on
a mesh of Auto axes (ROADMAP R5).  The inputs are the JAX package's
parameters (``init_moe``, ``init_params``, key 0) and numpy from seeds.
Tolerances: the MoE functions 2e-5 (tests/test_moe.py:69), the logits
``tests/test_torch_serve.py``'s, the training step
``tests/test_torch_parallel.py``'s.  At capacity factor 4 (the number of
experts) no dispatch is dropped and the paths equal ``moe_dense``; at 1.25
and 0.25 the drops are JAX's.
"""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import concurrent.futures
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import run_multidevice
from repro.configs import smoke_config as jax_smoke_config
from repro.models import init_params as jax_init_params
from repro.models import moe as jmoe
from repro_torch.configs import smoke_config
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.models import moe as tmoe
from torch_dp_ranks import flatten, update_errors
from torch_ep_ranks import bf16_decode, ep_cases, moe_config

ARCH = "dbrx-132b"
MESHES = [(2, 2), (1, 4)]
TOL = dict(atol=2e-5, rtol=0)  # tests/test_moe.py:69
LOGIT_TOL = dict(atol=5e-4, rtol=1e-3)  # tests/test_torch_serve.py
STEP_TOL = dict(atol=1e-5, rtol=1e-5)  # tests/test_torch_parallel.py
NO_DROP = 4.0  # the number of experts: every expert takes a whole shard
FACTORS = [NO_DROP, 1.25, 0.25]
X_SHAPE = (4, 32, 256)  # (B, S, d): a shard of 32 tokens on both meshes
TOKENS = (8, 32)
DECODE_STEPS = 6
# tests/test_torch_parallel.py's rate: every parameter moves visibly
BASE = dict(remat=False, learning_rate=1e-3, warmup_steps=1)
BF16_SEED = 5
# G2 at smoke size: about twice the worst sound bf16 EP decode's max
# |logit diff| against the single rank's, 1.11 (the (1, 4) mesh, one token
# whose top-2 experts are near a tie and flip in bf16; 0.04 elsewhere);
# the planted fault gives 3.79 and 5.14
BF16_BOUND = 2.25


def _cases(mesh) -> dict:
    cases = {"a2a": {"kind": "a2a"}, "forward": {"kind": "forward"},
             "decode": {"kind": "decode", "steps": DECODE_STEPS}}
    for fn in ("train", "decode", "decode_ws"):
        for f in FACTORS:
            cases[f"{fn}|{f}"] = {"kind": "moe", "fn": fn, "factor": f}
    # a batch of 3 does not split over 2 data ranks: every rank holds it
    # whole, as JAX replicates it (models/moe.py:275-277)
    for fn in ("decode", "decode_ws"):
        cases[f"{fn}|replicated"] = {"kind": "moe", "fn": fn,
                                     "factor": NO_DROP, "batch": 3,
                                     "replicated": True}
    cases["bf16_decode"] = {"kind": "bf16_decode", "seed": BF16_SEED,
                            "steps": DECODE_STEPS}
    # with one data rank (1 x 4) ZeRO-1 has nothing to shard: both run the
    # plain update there
    for name, zero1 in (("zero1", True), ("dp", False)):
        cases[f"train_{name}"] = {"kind": "train",
                                  "tcfg": {**BASE, "zero1": zero1}}
        cases[f"train_{name}_two_steps"] = {
            "kind": "train", "steps": 2, "tcfg": {**BASE, "zero1": zero1}}
    return cases


_JAX_SCRIPT = """
import dataclasses, json, sys
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import smoke_config
from repro.core.types import MeshConfig, TrainConfig
from repro.models import decode_step, forward, init_cache
from repro.models import moe as moe_mod
from repro.optim.adamw import init_opt_state
from repro.parallel.planner import make_ctx, param_specs
from repro.train.step import make_train_step

inputs, cases_json, mesh_json, out_path = sys.argv[1:5]
data = np.load(inputs)
cases = json.loads(cases_json)
dp, tp = json.loads(mesh_json)
mesh = jax.make_mesh((dp, tp), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
mcfg = MeshConfig((dp, tp))
cfg = smoke_config("dbrx-132b")
mcfg_moe = dataclasses.replace(cfg, num_shared_experts=0)
is_p = lambda x: isinstance(x, P)
shard = lambda sp: NamedSharding(mesh, sp)

def nest(flat):
    tree = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(value)
    return tree

def flat(tree, prefix):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {prefix + "|" + "/".join(str(k.key) for k in kp): np.asarray(
        leaf, np.float32) for kp, leaf in leaves}

pm = {k.split("|", 1)[1]: jnp.asarray(data[k]) for k in data.files
      if k.startswith("moe|")}
params = nest({k.split("|", 1)[1]: data[k] for k in data.files
               if k.startswith("params|")})
tokens = jnp.asarray(data["tokens"])
fns = {"train": moe_mod.moe_ep_train, "decode": moe_mod.moe_ep_decode,
       "decode_ws": moe_mod.moe_ep_decode_ws}
out = {}
for name, case in cases.items():
    kind = case["kind"]
    ctx = make_ctx(mesh, mcfg, remat=False)
    if kind == "a2a":
        ys, gs = [], []
        for d in range(dp):
            m1 = jax.make_mesh((tp,), ("model",), (AxisType.Auto,),
                               devices=jax.devices()[d * tp:(d + 1) * tp])
            a2a = jax.shard_map(
                lambda x: jax.lax.all_to_all(x, "model", 0, 0, tiled=False),
                mesh=m1, in_specs=P("model"), out_specs=P("model"))
            x = jnp.asarray(data["a2a|x"][d * tp:(d + 1) * tp]).reshape(
                tp * tp, *data["a2a|x"].shape[2:])
            c = jnp.asarray(data["a2a|c"][d * tp:(d + 1) * tp]).reshape(
                x.shape)
            ys.append(np.asarray(a2a(x)))
            gs.append(np.asarray(jax.grad(lambda v: (a2a(v) * c).sum())(x)))
        out[name + "|y"] = np.concatenate(ys).reshape(data["a2a|x"].shape)
        out[name + "|grad"] = np.concatenate(gs).reshape(
            data["a2a|x"].shape)
    elif kind == "moe":
        x = jnp.asarray(data["x"])
        if case["fn"] != "train":
            x = x[:case.get("batch", x.shape[0]), :1]
        fn = fns[case["fn"]]
        f = case["factor"]
        y, aux = jax.jit(lambda p_, x_: fn(
            p_, mcfg_moe, x_, mesh, "model", ("data",),
            capacity_factor=f))(pm, x)
        out[name + "|y"] = np.asarray(y)
        out[name + "|aux"] = np.asarray(aux)
    elif kind == "forward":
        logits, aux = jax.jit(lambda p_, t_: forward(cfg, p_, t_, ctx=ctx))(
            params, tokens)
        out[name + "|logits"] = np.asarray(logits)
        out[name + "|aux"] = np.asarray(aux)
    elif kind == "decode":
        steps = case["steps"]
        cache = init_cache(cfg, params, tokens.shape[0], steps)
        step = jax.jit(lambda p_, c_, t_, pos: decode_step(
            cfg, p_, c_, t_, pos, ctx=ctx))
        got = []
        for t in range(steps):
            lg, cache = step(params, cache, tokens[:, t:t + 1], t)
            got.append(np.asarray(lg[:, 0]))
        out[name + "|logits"] = np.stack(got, 1)
    elif name == "train_zero1":  # the JAX step's arithmetic for both
        tc = dict(case["tcfg"])
        tc.pop("remat")
        specs = param_specs(cfg, mcfg)
        p = jax.device_put(params, jax.tree.map(shard, specs, is_leaf=is_p))
        opt = init_opt_state(p)
        batch = jax.device_put({k: jnp.asarray(data[k])
                                for k in ("tokens", "labels")},
                               shard(P("data", None)))
        p, opt, metrics = jax.jit(make_train_step(cfg, TrainConfig(**tc),
                                                  ctx))(p, opt, batch)
        out.update(flat(p, name + "|params"))
        out.update(flat(opt["m"], name + "|m"))
        out.update(flat(opt["v"], name + "|v"))
        for k, v in metrics.items():
            out[name + "|metric|" + k] = np.asarray(v, np.float32)
np.savez(out_path, **out)
print("OK")
"""


def _initial() -> dict:
    """The JAX package's parameters of dbrx's smoke config (key 0),
    flat."""
    jp = jax_init_params(jax_smoke_config(ARCH), jax.random.PRNGKey(0))
    return flatten(jax.tree.map(np.asarray, jp))


def _inputs(tmp, world: int, tp: int) -> str:
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), num_shared_experts=0)
    pm = jmoe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.float32)
    rng = np.random.default_rng(0)
    tok = rng.integers(0, 512, TOKENS).astype(np.int32)  # smoke vocab 512
    data = {f"moe|{k}": np.asarray(v) for k, v in pm.items()}
    data.update({f"params|{k}": v for k, v in _initial().items()})
    data["x"] = rng.standard_normal(X_SHAPE, dtype=np.float32)
    data["a2a|x"] = rng.standard_normal((world, tp, 3, 5), dtype=np.float32)
    data["a2a|c"] = rng.standard_normal((world, tp, 3, 5), dtype=np.float32)
    data["tokens"], data["labels"] = tok, np.roll(tok, -1, 1)
    path = str(tmp / "inputs.npz")
    np.savez(path, **data)
    return path


@pytest.fixture(scope="module", params=MESHES, ids=["2x2", "1x4"])
def runs(request, tmp_path_factory):
    """Every case on the mesh's 4 ranks and on JAX's 4 devices, at once:
    (mesh, the ranks' results, JAX's arrays, the inputs)."""
    mesh = request.param
    world = mesh[0] * mesh[1]
    tmp = tmp_path_factory.mktemp("ep{}x{}".format(*mesh))
    inputs = _inputs(tmp, world, mesh[1])
    cases = _cases(mesh)
    script = (f"import sys; sys.argv = ['', {inputs!r}, "
              f"{json.dumps(cases)!r}, {json.dumps(list(mesh))!r}, "
              f"{str(tmp / 'jax.npz')!r}]\n" + _JAX_SCRIPT)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(run_multidevice, script, num_devices=world,
                              timeout=300)
        ranks = spawn_ranks(ep_cases, world, mesh, inputs, cases,
                            timeout_s=300)
        jax_run.result()
    return mesh, ranks, dict(np.load(tmp / "jax.npz")), dict(np.load(inputs))


def _data_rows(mesh, ranks, name, key):
    """The ranks' results of ``name`` stacked in data order (model rank 0
    of each data index), after checking that every model rank of a data
    index holds the same bits."""
    dp, tp = mesh
    for d in range(dp):
        for m in range(1, tp):
            np.testing.assert_array_equal(ranks[d * tp + m][name][key],
                                          ranks[d * tp][name][key])
    return np.concatenate([ranks[d * tp][name][key] for d in range(dp)])


@pytest.mark.parametrize("ids,e", [((0, 1, 0, 0, 2, 1, 0), 3),
                                   ((3, 3, 3, 3), 4), ((1,), 2),
                                   (tuple(np.random.default_rng(0).integers(
                                       0, 16, 64)), 16)])
def test_slots_match_jax(ids, e):
    got = tmoe._slots(torch.tensor(ids), e)
    want = jmoe._slots(jnp.asarray(ids, jnp.int32), e)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("tokens,k,e,f", [
    (1, 1, 4, 1.0), (7, 2, 4, 1.25), (32, 2, 4, 0.25), (128, 4, 16, 1.25),
    (128, 4, 16, 16.0), (4, 4, 16, 4.0), (3, 4, 16, 4.0), (64, 2, 4, 1.25)])
def test_capacity_for_matches_jax(tokens, k, e, f):
    assert tmoe.capacity_for(tokens, k, e, f) == \
        jmoe.capacity_for(tokens, k, e, f)


def test_all_to_all_and_its_gradient_match_jax(runs):
    """``all_to_all`` over each model group (2 ranks on the 2 x 2 mesh, 4
    on 1 x 4) and the gradient through ``AllToAll``: bit-equal to
    ``jax.lax.all_to_all`` and its transpose."""
    mesh, ranks, jax_out, _ = runs
    for key in ("y", "plain"):
        got = np.stack([r["a2a"][key] for r in ranks])
        np.testing.assert_array_equal(got, jax_out["a2a|y"])
    got = np.stack([r["a2a"]["grad"] for r in ranks])
    np.testing.assert_array_equal(got, jax_out["a2a|grad"])


MOE_CASES = [f"{fn}|{f}" for fn in ("train", "decode", "decode_ws")
             for f in FACTORS]


@pytest.mark.parametrize("name", MOE_CASES + ["decode|replicated",
                                              "decode_ws|replicated"])
def test_moe_ep_matches_jax(runs, name):
    """Each path on the mesh against the JAX function on its devices,
    capacity drops included; the router loss too: in training the ranks'
    average to JAX's, in decode (no sum over the data ranks) each rank's
    is JAX's ``route`` of its own tokens, the JAX function's where it
    holds the whole batch."""
    mesh, ranks, jax_out, inputs = runs
    replicated = name.endswith("replicated")
    if replicated:
        got = ranks[0][name]["y"]
        for r in ranks:
            np.testing.assert_array_equal(r[name]["y"], got)
    else:
        got = _data_rows(mesh, ranks, name, "y")
    np.testing.assert_allclose(got, jax_out[f"{name}|y"], **TOL)
    want = float(jax_out[f"{name}|aux"])
    if name.startswith("train"):
        aux = np.mean([ranks[d * mesh[1]][name]["aux"]
                       for d in range(mesh[0])])
        assert aux == pytest.approx(want, rel=1e-5)
        return
    dp = 1 if replicated else mesh[0]
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), num_shared_experts=0)
    pm = {k.split("|", 1)[1]: jnp.asarray(v) for k, v in inputs.items()
          if k.startswith("moe|")}
    x = inputs["x"][:_cases(mesh)[name].get("batch"), :1]
    b = x.shape[0] // dp
    for d in range(mesh[0]):
        rows = x[(d % dp) * b:(d % dp + 1) * b]
        own = float(jmoe.route(pm, jcfg, jnp.asarray(rows))[2])
        for m in range(mesh[1]):
            assert ranks[d * mesh[1] + m][name]["aux"] == \
                pytest.approx(own, rel=1e-5)
        if dp == 1:
            assert own == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("fn", ["train", "decode", "decode_ws"])
def test_moe_ep_without_drops_equals_dense(runs, fn):
    """At capacity factor 4 every path gives the port's ``moe_dense``; at
    0.25 the training path drops dispatches (its output moves)."""
    mesh, ranks, _, inputs = runs
    cfg = moe_config()
    p = {k.split("|", 1)[1]: torch.from_numpy(v) for k, v in inputs.items()
         if k.startswith("moe|")}
    x = torch.from_numpy(inputs["x"])
    if fn != "train":
        x = x[:, :1]
    want, _ = tmoe.moe_dense(p, cfg, x)
    got = _data_rows(mesh, ranks, f"{fn}|{NO_DROP}", "y")
    np.testing.assert_allclose(got, want.numpy(), **TOL)
    if fn == "train":
        dropped = _data_rows(mesh, ranks, "train|0.25", "y")
        assert np.abs(dropped - want.numpy()).max() > 1e-2


@pytest.mark.parametrize("factor", FACTORS)
def test_moe_ep_train_ref_matches_jax(runs, factor):
    """``moe_ep_train_ref``, the single-process plain emulation of the
    training path on the mesh (``chip_smoke.py`` holds the card's EP
    prefill to it), gives JAX's ``moe_ep_train`` on the same mesh, drops
    included, and reports the share dropped."""
    mesh, _, jax_out, inputs = runs
    p = {k.split("|", 1)[1]: torch.from_numpy(v) for k, v in inputs.items()
         if k.startswith("moe|")}
    y, aux, dropped = tmoe.moe_ep_train_ref(
        p, moe_config(), torch.from_numpy(inputs["x"]), mesh[1], factor,
        dp=mesh[0])
    np.testing.assert_allclose(y.numpy(), jax_out[f"train|{factor}|y"],
                               **TOL)
    assert float(aux) == pytest.approx(float(jax_out[f"train|{factor}|aux"]),
                                       rel=1e-5)
    assert 0 <= dropped < 1
    if factor == NO_DROP:
        assert dropped == 0
    elif factor == 0.25:
        assert dropped > 0


def test_forward_and_decode_match_jax(runs):
    """``forward`` (MoE through ``moe_ep_train``) and ``decode_step``
    (through ``moe_ep_decode``) with an expert-parallel context, every
    rank on its data shard, against the JAX package's with ``make_ctx``
    on the mesh (EP, its default): logits and the router loss."""
    mesh, ranks, jax_out, _ = runs
    got = _data_rows(mesh, ranks, "forward", "logits")
    np.testing.assert_allclose(got, jax_out["forward|logits"], **LOGIT_TOL)
    aux = np.mean([ranks[d * mesh[1]]["forward"]["aux"]
                   for d in range(mesh[0])])
    assert aux == pytest.approx(float(jax_out["forward|aux"]), rel=1e-5)
    got = _data_rows(mesh, ranks, "decode", "logits")
    np.testing.assert_allclose(got, jax_out["decode|logits"], **LOGIT_TOL)


@pytest.mark.parametrize("name", ["train_zero1", "train_dp"])
def test_ep_train_step_matches_jax(runs, name):
    """One training step on the mesh (experts over the model axis, the
    sync over the data axis: ZeRO-1 or plain DP) against JAX's step
    with ``make_ctx`` and the planner's specs: the global loss, ce, aux,
    lr and grad_norm within 1e-5, the parameters through their update and
    the gathered moments as ``tests/test_torch_parallel.py`` holds them."""
    mesh, ranks, jax_out, _ = runs
    got = ranks[0][name]
    jname = "train_zero1"  # the JAX step's arithmetic is one for both
    for k in ("loss", "ce", "aux", "lr", "grad_norm"):
        assert got["metrics"][0][k] == pytest.approx(
            float(jax_out[f"{jname}|metric|{k}"]), rel=1e-5, abs=1e-7), k
    want = {k.split("|", 2)[2]: v for k, v in jax_out.items()
            if k.startswith(f"{jname}|params|")}
    assert sorted(want) == sorted(got["params"])
    err = update_errors(_initial(), got["params"], want, got["m"], got["v"],
                        BASE, got["metrics"][0]["lr"])
    assert err["adamw"] <= 1e-3, err
    assert err["update"] <= 1e-2, err
    for k in ("m", "v"):
        for path, value in got[k].items():
            np.testing.assert_allclose(value, jax_out[f"{jname}|{k}|{path}"],
                                       err_msg=path, **STEP_TOL)


@pytest.mark.parametrize("name", ["train_zero1_two_steps",
                                  "train_dp_two_steps"])
def test_ep_ranks_identical_after_two_steps(runs, name):
    """After two steps every rank holds the same gathered parameters and
    metrics, the replicated leaves bit-equal on every rank, each model
    rank's experts its own."""
    mesh, ranks, _, _ = runs
    assert len({r[name]["checksum"] for r in ranks}) == 1
    assert len({r[name]["dense"] for r in ranks}) == 1
    assert len({json.dumps(r[name]["metrics"]) for r in ranks}) == 1
    assert len({r[name]["own"] for r in ranks[:mesh[1]]}) == mesh[1]
    first, second = ranks[0][name]["metrics"]
    assert np.isfinite([first["loss"], second["loss"]]).all()


def test_bf16_ep_decode_logit_diff_is_bounded(runs):
    """G2 at smoke size: the bf16 EP decode (experts over the model axis,
    the attention and the vocabulary split beside them, a bf16 cache),
    teacher forced, against the single-rank bf16 decode of the same draw:
    the max |logit diff| within ``BF16_BOUND``; the attention's
    ``reduce_from_model`` skipped on the first layer
    (``torch_ep_ranks.SkipAttentionReduce``) beyond it."""
    from repro_torch.models import init_params
    mesh, ranks, _, inputs = runs
    cfg = smoke_config(ARCH)
    params = init_params(cfg, torch.Generator().manual_seed(BF16_SEED),
                         dtype=torch.bfloat16, device="cpu")
    tokens = torch.from_numpy(inputs["tokens"]).long()
    want = bf16_decode(cfg, params, tokens, DECODE_STEPS).numpy()
    v = cfg.vocab_size
    got = _data_rows(mesh, ranks, "bf16_decode", "logits")
    bad = _data_rows(mesh, ranks, "bf16_decode", "fault")
    sound = float(np.abs(got[..., :v] - want[..., :v]).max())
    fault = float(np.abs(bad[..., :v] - want[..., :v]).max())
    assert sound <= BF16_BOUND < fault, (sound, fault)
