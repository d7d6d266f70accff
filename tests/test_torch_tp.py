"""The port's tensor parallelism (``repro_torch.parallel.tensor`` and the
model, loss, step and serving under a context whose model axis splits)
against the JAX package's and against the port's own single-rank run, at
smoke size on the CPU.

For each mesh, (1, 4) and (2, 2): one ``spawn_ranks`` of 4 gloo ranks
computes every case (``torch_tp_ranks.tp_cases``), and, at the same time,
one JAX subprocess on 4 forced host devices computes the JAX package's
forward, decode and training step on a mesh of Auto axes (ROADMAP R5) with
the planner's parameter specs.  A (1, 2) mesh, on which the smoke configs'
2 KV heads split too, is held against the single-rank run.  The inputs are
the JAX package's parameters (``init_params``, key 0, the cross-attention
gates opened: ``torch_context.open_gates``), the stub contexts and numpy
from a seed.  This file holds the dense GQA and Mamba2 configs; the
families whose model axis splits MLA, cross-attention, the encoder and
(beside expert parallelism) the MoE configs' other layers run the same
checks in ``tests/test_torch_tp_families.py``, on ranks and a JAX run of
their own (so that the two files share the work of a test run's
workers).  The smoke configs have 4 query and 2 KV heads: at tp 4 the
query heads split and the KV heads do not (each rank reads the KV head of
its query head), at tp 2 both split; ``torch_tp_ranks.REPLICATED_ATTN``
has 14 query heads, so at tp 4 its attention is replicated and only its
FFN splits.  Tolerances: the logits
``tests/test_pallas_integration.py``'s (atol 5e-4, rtol 1e-3) against JAX
and 1e-5 against the single-rank run, the training step
``tests/test_torch_parallel.py``'s (metrics rel 1e-5, moments and
gradients 1e-5, parameters through their update).
"""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import concurrent.futures
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from helpers import run_multidevice
from repro.configs import smoke_config as jax_smoke_config
from repro.models import init_params as jax_init_params
from repro_torch.bridge import params_from_jax, params_to_jax_layout
from repro_torch.configs import smoke_config
from repro_torch.core.tree import param_leaves
from repro_torch.core.types import TrainConfig
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params)
from repro_torch.optim import init_opt_state
from repro_torch.parallel.planner import _unflatten_like
from repro_torch.train import make_train_step
from torch_context import open_gates, stub_context
from torch_dp_ranks import flatten, nest, update_errors
from torch_tp_ranks import (REPLICATED_ATTN, VARIANTS, tp_batch, tp_cases,
                            tp_config, tp_context)

ARCHS = ("qwen2-0.5b", "granite-3-8b", "starcoder2-3b", "mamba2-130m")
BATCHER_ARCHS = ("granite-3-8b", "mamba2-130m")
MOE_ARCHS = ("deepseek-v2-236b", "dbrx-132b", "jamba-1.5-large-398b")
MESHES = [(1, 4), (2, 2)]
LOGIT_TOL = dict(atol=5e-4, rtol=1e-3)  # tests/test_pallas_integration.py
STEP_TOL = dict(atol=1e-5, rtol=1e-5)   # tests/test_torch_parallel.py
TOKENS = (4, 16)
DECODE_STEPS = 6
# tests/test_torch_parallel.py's rate: every parameter moves visibly
BASE = dict(remat=False, learning_rate=1e-3, warmup_steps=1)
# three requests on a batcher of 2 slots: the third admitted mid-flight
BATCHER_REQUESTS = [[5, 17, 300, 2], [9, 9, 41], [250, 3, 77, 12, 8]]
BATCHER_TEMPERATURES = (0.0, 0.8)
# tests/test_torch_parallel.py's bounds on the updated parameters
ADAMW_TOL = 1e-3
UPDATE_RTOL = 1e-2


def model_cases(mesh, archs) -> dict:
    """The "model" and "init" cases of ``archs`` on ``mesh``."""
    cases = {}
    for arch in archs:
        cases[f"model|{arch}"] = {
            "kind": "model", "arch": arch, "steps": DECODE_STEPS,
            "tcfg": {**BASE, "zero1": mesh[0] > 1}}
        cases[f"init|{arch}"] = {"kind": "init", "arch": arch, "seed": 3}
    return cases


def batcher_cases(archs) -> dict:
    return {f"batcher|{arch}|{temp}": {
        "kind": "batcher", "arch": arch, "temperature": temp,
        "requests": BATCHER_REQUESTS}
        for arch in archs for temp in BATCHER_TEMPERATURES}


def _cases(mesh) -> dict:
    cases = model_cases(mesh, ARCHS + (REPLICATED_ATTN,))
    cases["fault|wo"] = {"kind": "fault", "arch": REPLICATED_ATTN,
                         "fault": "wo_all_reduce"}
    cases["fault|norm"] = {"kind": "fault", "arch": "mamba2-130m",
                           "fault": "local_norm"}
    for arch in ("granite-3-8b", "mamba2-130m", REPLICATED_ATTN):
        cases[f"bytes|{arch}"] = {"kind": "bytes", "arch": arch,
                                  "tcfg": BASE}
    cases.update(batcher_cases(BATCHER_ARCHS))
    return cases


_JAX_SCRIPT = """
import dataclasses, json, sys
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import smoke_config
from repro.core.types import MeshConfig, TrainConfig
from repro.models import decode_step, encode, forward, init_cache
from repro.optim.adamw import init_opt_state
from repro.parallel.planner import make_ctx, param_specs
from repro.train.step import make_train_step

(inputs, archs_json, mesh_json, steps, tcfg_json, out_path, use_ep_json,
 variants_json) = sys.argv[1:9]
data = np.load(inputs)
use_ep, variants = json.loads(use_ep_json), json.loads(variants_json)
dp, tp = json.loads(mesh_json)
mesh = jax.make_mesh((dp, tp), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
mcfg = MeshConfig((dp, tp))
is_p = lambda x: isinstance(x, P)
shard = lambda sp: NamedSharding(mesh, sp)
tokens = jnp.asarray(data["tokens"])

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

out = {}
for arch in json.loads(archs_json):
    if arch in variants:
        base, fields = variants[arch]
        cfg = dataclasses.replace(smoke_config(base), name=arch, **fields)
    else:
        cfg = smoke_config(arch)
    # MoE configs: expert parallelism beside the tensor parallelism, at
    # capacity factor E (no dispatch dropped), unless use_ep says otherwise
    ctx = make_ctx(mesh, mcfg, remat=False,
                   use_ep=cfg.is_moe if use_ep is None else use_ep)
    if cfg.is_moe:
        ctx = dataclasses.replace(
            ctx, capacity_factor=float(cfg.num_experts),
            decode_capacity_factor=float(cfg.num_experts))
    pre = "params|" + arch + "|"
    params = nest({k[len(pre):]: data[k] for k in data.files
                   if k.startswith(pre)})
    specs = param_specs(cfg, mcfg)
    params = jax.device_put(params, jax.tree.map(shard, specs, is_leaf=is_p))
    raw = ("context|" + arch) in data.files
    frames = jnp.asarray(data["context|" + arch]) if raw else None
    if cfg.is_encoder_decoder:
        context = jax.jit(lambda p_, f_: encode(cfg, p_, f_, ctx=ctx))(
            params, frames)
    else:
        context = frames
    logits, _ = jax.jit(lambda p_, t_, c_: forward(cfg, p_, t_, context=c_,
                                                   ctx=ctx))(
        params, tokens, context)
    out[arch + "|logits"] = np.asarray(logits)
    n = int(steps)
    cache = init_cache(cfg, params, tokens.shape[0], n, context=context)
    step = jax.jit(lambda p_, c_, t_, pos: decode_step(cfg, p_, c_, t_, pos,
                                                       ctx=ctx))
    got = []
    for t in range(n):
        lg, cache = step(params, cache, tokens[:, t:t + 1], t)
        got.append(np.asarray(lg[:, 0]))
    out[arch + "|decode"] = np.stack(got, 1)
    tc = json.loads(tcfg_json)
    tc.pop("remat")
    opt = init_opt_state(params)
    batch = jax.device_put({k: jnp.asarray(data[k])
                            for k in ("tokens", "labels")},
                           shard(P("data", None)))
    if raw:
        batch["context"] = jax.device_put(frames, shard(P("data", None,
                                                          None)))
    p, opt, metrics = jax.jit(make_train_step(cfg, TrainConfig(**tc), ctx))(
        params, opt, batch)
    out.update(flat(p, arch + "|params"))
    out.update(flat(opt["m"], arch + "|m"))
    out.update(flat(opt["v"], arch + "|v"))
    for k, v in metrics.items():
        out[arch + "|metric|" + k] = np.asarray(v, np.float32)
np.savez(out_path, **out)
print("OK")
"""


def jax_tp_config(name: str):
    """The JAX package's config of ``tp_config(name)``."""
    if name in VARIANTS:
        arch, fields = VARIANTS[name]
        return dataclasses.replace(jax_smoke_config(arch), name=name,
                                   **fields)
    return jax_smoke_config(name)


def _initial(arch: str) -> dict:
    jp = jax_init_params(jax_tp_config(arch), jax.random.PRNGKey(0))
    return flatten(open_gates(jax.tree.map(np.asarray, jp)))


def _inputs(tmp, archs) -> str:
    rng = np.random.default_rng(0)
    tok = rng.integers(0, 512, TOKENS).astype(np.int32)  # smoke vocab 512
    data = {"tokens": tok, "labels": np.roll(tok, -1, 1)}
    for arch in archs:
        data.update({f"params|{arch}|{k}": v
                     for k, v in _initial(arch).items()})
        context = stub_context(tp_config(arch), TOKENS[0], seed=1)
        if context is not None:
            data[f"context|{arch}"] = context
    path = str(tmp / "inputs.npz")
    np.savez(path, **data)
    return path


def mesh_runs(mesh, tmp, archs, cases, use_ep=None):
    """``cases`` on the mesh's 4 ranks and the JAX package's forward,
    decode and step of ``archs`` on its 4 devices, at once: (mesh, the
    ranks' results, JAX's arrays, the inputs).  ``use_ep``: the JAX
    context's (``None``: for the MoE configs)."""
    inputs = _inputs(tmp, archs)
    script = (f"import sys; sys.argv = ['', {inputs!r}, "
              f"{json.dumps(list(archs))!r}, {json.dumps(list(mesh))!r}, "
              f"'{DECODE_STEPS}', {json.dumps(BASE)!r}, "
              f"{str(tmp / 'jax.npz')!r}, {json.dumps(use_ep)!r}, "
              f"{json.dumps(VARIANTS)!r}]\n" + _JAX_SCRIPT)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(run_multidevice, script, num_devices=4,
                              timeout=300)
        ranks = spawn_ranks(tp_cases, 4, mesh, inputs, cases, timeout_s=300)
        jax_run.result()
    return mesh, ranks, dict(np.load(tmp / "jax.npz")), dict(np.load(inputs))


def runs_1x2_of(tmp, archs, cases):
    """``cases`` on a (1, 2) mesh: (the ranks' results, the inputs)."""
    inputs = _inputs(tmp, archs)
    return spawn_ranks(tp_cases, 2, (1, 2), inputs, cases, timeout_s=300), \
        dict(np.load(inputs))


@pytest.fixture(scope="module", params=MESHES[:1], ids=["1x4"])
def runs(request, tmp_path_factory):
    """Every case on the mesh's 4 ranks and on JAX's 4 devices, at once:
    (mesh, the ranks' results, JAX's arrays, the inputs).  The (2, 2)
    mesh's run is ``tests/test_torch_tp_2x2.py``'s."""
    return tp_runs(request.param, tmp_path_factory)


def tp_runs(mesh, tmp_path_factory):
    return mesh_runs(mesh, tmp_path_factory.mktemp("tp{}x{}".format(*mesh)),
                     ARCHS, _cases(mesh))


@pytest.fixture(scope="module")
def runs_1x2(tmp_path_factory):
    """granite-3-8b's cases on a (1, 2) mesh, whose 2 KV heads split."""
    cases = {k: v for k, v in _cases((1, 2)).items()
             if k.endswith("granite-3-8b")}
    return runs_1x2_of(tmp_path_factory.mktemp("tp1x2"), ARCHS, cases)


def _single(arch: str, data: dict) -> dict:
    """The port's single-rank run of the case: logits, decode logits, the
    step's metrics, gradient, parameters and moments (JAX layout)."""
    cfg = tp_config(arch)
    if any(k.startswith(f"params|{arch}|") for k in data):
        params = params_from_jax(cfg, nest({
            k.split("|", 2)[2]: v for k, v in data.items()
            if k.startswith(f"params|{arch}|")}), "cpu")
    else:
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    tokens = torch.from_numpy(data["tokens"]).long()
    context = tp_context(data, arch, cfg, params)
    out = {}
    with torch.no_grad():
        out["logits"] = forward(cfg, params, tokens,
                                context=context)[0].numpy()
        cache = init_cache(cfg, params, tokens.shape[0], DECODE_STEPS,
                           context=context)
        dec = []
        for t in range(DECODE_STEPS):
            lg, cache = decode_step(cfg, params, cache, tokens[:, t:t + 1],
                                    t)
            dec.append(lg[:, 0])
        out["decode"] = torch.stack(dec, 1).numpy()
    out["p0"] = {k: v.copy() for k, v in flatten(
        params_to_jax_layout(cfg, params)).items()}  # the step is in place
    seen = {}

    def hook(stage, grads):
        if stage == "local":
            seen["g"] = [g.detach().clone() for g in grads]

    params, opt, m = make_train_step(cfg, TrainConfig(**BASE))(
        params, init_opt_state(params), tp_batch(data, arch),
        grad_hook=hook)
    out["metrics"] = {k: float(v) for k, v in m.items()}
    out["grads"] = flatten(params_to_jax_layout(
        cfg, _unflatten_like(params, seen["g"])))
    out["params"] = flatten(params_to_jax_layout(cfg, params))
    for k in ("m", "v"):
        out[k] = flatten(params_to_jax_layout(cfg, opt[k]))
    return out


_SINGLE: dict = {}


def single(arch: str, data: dict) -> dict:
    if arch not in _SINGLE:
        _SINGLE[arch] = _single(arch, data)
    return _SINGLE[arch]


def _close(got: dict, want: dict, **tol) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _check_step(got: dict, want_metrics: dict, want: dict,
                p0: dict) -> None:
    for k in ("loss", "ce", "aux", "lr", "grad_norm"):
        assert got["metrics"][k] == pytest.approx(
            float(want_metrics[k]), rel=1e-5, abs=1e-7), k
    err = update_errors(p0, got["params"], want["params"], got["m"],
                        got["v"], BASE, got["metrics"]["lr"])
    assert err["adamw"] <= ADAMW_TOL, err
    assert err["update"] <= UPDATE_RTOL, err


def check_tp_forward_and_decode_match_jax(runs, arch):
    """Prefill logits and 6 decode steps, gathered over the vocabulary
    blocks, against JAX's forward and decode on the same mesh; every rank
    holds the same bits; each rank's logits are its vocabulary block."""
    mesh, ranks, jax_out, _ = runs
    got = ranks[0][f"model|{arch}"]
    for r in ranks:
        np.testing.assert_array_equal(r[f"model|{arch}"]["logits"],
                                      got["logits"])
        np.testing.assert_array_equal(r[f"model|{arch}"]["decode"],
                                      got["decode"])
    assert got["local_vocab"] * mesh[1] == got["logits"].shape[-1]
    np.testing.assert_allclose(got["logits"], jax_out[f"{arch}|logits"],
                               **LOGIT_TOL)
    np.testing.assert_allclose(got["decode"], jax_out[f"{arch}|decode"],
                               **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_forward_and_decode_match_jax(runs, arch):
    check_tp_forward_and_decode_match_jax(runs, arch)


def check_tp_forward_and_decode_match_single_rank(runs, arch):
    mesh, ranks, _, data = runs
    got = ranks[0][f"model|{arch}"]
    want = single(arch, data)
    np.testing.assert_allclose(got["logits"], want["logits"], **STEP_TOL)
    np.testing.assert_allclose(got["decode"], want["decode"], **STEP_TOL)


@pytest.mark.parametrize("arch", ARCHS + (REPLICATED_ATTN,))
def test_tp_forward_and_decode_match_single_rank(runs, arch):
    check_tp_forward_and_decode_match_single_rank(runs, arch)


def check_tp_step_matches_jax(runs, arch):
    """One training step on the mesh (ZeRO-1 where the data axis has 2
    ranks) against JAX's step: the metrics, the updated parameters and the
    gathered moments, leaf for leaf in the JAX layout."""
    mesh, ranks, jax_out, _ = runs
    got = ranks[0][f"model|{arch}"]
    want = {k.split("|", 2)[2]: v for k, v in jax_out.items()
            if k.startswith(f"{arch}|params|")}
    metrics = {k: jax_out[f"{arch}|metric|{k}"]
               for k in ("loss", "ce", "aux", "lr", "grad_norm")}
    _check_step(got, metrics, {"params": want}, _initial(arch))
    for k in ("m", "v"):
        _close(got[k], {p.split("|", 2)[2]: v for p, v in jax_out.items()
                        if p.startswith(f"{arch}|{k}|")}, **STEP_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_step_matches_jax(runs, arch):
    check_tp_step_matches_jax(runs, arch)


def check_tp_step_matches_single_rank(runs, arch):
    """One step against the port's single-rank step: every leaf's
    gradient (each rank's own, gathered) within 1e-5, so no replicated
    leaf's gradient is summed over the model ranks and no block's is
    partial; the metrics, moments and parameters as against JAX; the
    replicated leaves bit-equal on every rank of the mesh."""
    mesh, ranks, _, data = runs
    name = f"model|{arch}"
    got = ranks[0][name]
    want = single(arch, data)
    # each data index's gradient is of its rows: their sum is the batch's
    grads = {k: sum(ranks[d * mesh[1]][name]["grads"][k]
                    for d in range(mesh[0])) for k in got["grads"]}
    _close(grads, want["grads"], **STEP_TOL)
    _check_step(got, want["metrics"], want, want["p0"])
    for k in ("m", "v"):
        _close(got[k], want[k], **STEP_TOL)
    assert len({r[name]["replicated_checksum"] for r in ranks}) == 1
    assert got["split"] > 0


@pytest.mark.parametrize("arch", ARCHS + (REPLICATED_ATTN,))
def test_tp_step_matches_single_rank(runs, arch):
    check_tp_step_matches_single_rank(runs, arch)


def check_tp_init_gathers_to_the_single_draw(runs, arch):
    """``gather_params(init_params(..., ctx))`` is bit-equal to
    ``init_params(...)`` from the same seed, and the ranks of a model
    group hold different blocks."""
    mesh, ranks, _, _ = runs
    cfg = tp_config(arch)
    want = flatten(params_to_jax_layout(cfg, init_params(
        cfg, torch.Generator().manual_seed(3), device="cpu")))
    for r in ranks:
        got = r[f"init|{arch}"]["params"]
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len({r[f"init|{arch}"]["own"] for r in ranks[:mesh[1]]}) == \
        mesh[1]


@pytest.mark.parametrize("arch", ARCHS + (REPLICATED_ATTN,))
def test_tp_init_gathers_to_the_single_draw(runs, arch):
    check_tp_init_gathers_to_the_single_draw(runs, arch)


def test_tp_cache_holds_this_ranks_heads(runs):
    """The decode cache of a rank holds its KV heads (all of them where
    they do not split) and its SSM heads and conv_x channels."""
    mesh, ranks, _, _ = runs
    tp = mesh[1]
    b = TOKENS[0]
    g = smoke_config("granite-3-8b")
    kv = g.num_kv_heads // tp if g.num_kv_heads % tp == 0 else \
        g.num_kv_heads
    assert ranks[0]["model|granite-3-8b"]["cache_shapes"][0] == \
        (b, DECODE_STEPS, kv, g.resolved_head_dim)
    m = smoke_config("mamba2-130m")
    shapes = ranks[0]["model|mamba2-130m"]["cache_shapes"]
    assert shapes[0] == (b, m.ssm_conv_kernel - 1, m.ssm_d_inner // tp)
    assert shapes[3] == (b, m.ssm_num_heads // tp, m.ssm_head_dim,
                         m.ssm_state)


@pytest.mark.parametrize("fault,arch", [("wo", REPLICATED_ATTN),
                                        ("norm", "mamba2-130m")])
def test_planted_faults_are_caught(runs, fault, arch):
    """An all-reduce after the output projection of a replicated
    attention (each rank already holds the whole output: it would count
    it tp times), and Mamba's gated norm over a rank's own channels (its
    mean square spans the whole d_inner): both move the logits far beyond
    the tolerance that the sound run meets."""
    mesh, ranks, _, data = runs
    want = single(arch, data)["logits"]
    got = ranks[0][f"fault|{fault}"]["logits"]
    assert np.abs(got - want).max() > 100 * LOGIT_TOL["atol"]
    np.testing.assert_allclose(ranks[0][f"model|{arch}"]["logits"], want,
                               **STEP_TOL)


def check_tp_batcher_ranks_emit_the_same_tokens(runs, arch, temperature):
    """A ``ContinuousBatcher`` on every rank of the mesh, fed the same
    requests: greedy and sampled (temperature 0.8, generators seeded
    alike, the gathered logits the same bits on every rank), every rank
    emits the same tokens, those of the single-rank batcher on the whole
    parameters, and a request is admitted mid-flight.  With a context
    (two rows of it, one a slot) each rank encodes or projects it on its
    heads."""
    from torch_tp_ranks import tp_batcher
    mesh, ranks, _, data = runs
    name = f"batcher|{arch}|{temperature}"
    got = ranks[0][name]
    for r in ranks:
        assert r[name] == got
    cfg = tp_config(arch)
    params = params_from_jax(cfg, nest({
        k.split("|", 2)[2]: v for k, v in data.items()
        if k.startswith(f"params|{arch}|")}), "cpu")
    want = tp_batcher(cfg, params, {"temperature": temperature,
                                    "requests": BATCHER_REQUESTS},
                      context=tp_context(data, arch, cfg, params,
                                         rows=slice(0, 2)))
    assert got == want
    assert max(got["admitted"].values()) > 0


@pytest.mark.parametrize("temperature", BATCHER_TEMPERATURES)
@pytest.mark.parametrize("arch", BATCHER_ARCHS)
def test_tp_batcher_ranks_emit_the_same_tokens(runs, arch, temperature):
    check_tp_batcher_ranks_emit_the_same_tokens(runs, arch, temperature)


def _ar(n: int, p: int, itemsize: int = 4) -> int:
    """Wire bytes a rank of ``ring_all_reduce`` of n values over p ranks:
    2 (p - 1) chunks of n / p (padded)."""
    return 2 * (p - 1) * -(-n // p) * itemsize if p > 1 else 0


def _gather(n: int, p: int, itemsize: int = 4) -> int:
    return (p - 1) * n * itemsize


def _expected_bytes(arch: str, tp: int, dp: int = 1) -> dict:
    """The model ring's bytes of a forward and of a step (f32, one data
    rank's rows): forward, the embedding's all-reduce and one a layer per
    row-parallel product (attention where its heads split, the FFN, the
    Mamba out-projection) plus the gated norm's mean square; the loss, the
    gather of the row maxima and the all-reduce of the sums of
    exponentials and label logits; backward, the all-reduce of each
    copy_to_model's gradient: the input of each split block, the LM
    head's, the KV projections where they do not split, Mamba's B and C,
    its norm's mean square and scale; the clip's norm, the gather of the
    split leaves' sum of squares (one f64).  ``dp``: the forward is on a
    data rank's 1/dp of the rows."""
    cfg = tp_config(arch)
    b, s = TOKENS
    b //= dp
    n = b * s * cfg.d_model
    lay = {"heads": cfg.num_heads % tp == 0 if cfg.num_heads else False,
           "kv": cfg.num_kv_heads % tp == 0 if cfg.num_kv_heads else False,
           "ffn": cfg.d_ff % tp == 0 if cfg.d_ff else False,
           "ssm": cfg.ssm_num_heads % tp == 0}
    fwd, bwd = _ar(n, tp), _ar(n, tp)  # embedding; LM head input
    kv_n = b * s * cfg.num_kv_heads * cfg.resolved_head_dim
    for spec in cfg.layer_specs():
        if spec.mixer == "attn" and lay["heads"]:
            fwd += _ar(n, tp)
            bwd += _ar(n, tp) + (0 if lay["kv"] else 2 * _ar(kv_n, tp))
        if spec.mixer == "mamba" and lay["ssm"]:
            fwd += _ar(n, tp) + _ar(b * s, tp)
            bwd += _ar(n, tp) + 2 * _ar(b * s * cfg.ssm_state, tp) + \
                _ar(b * s, tp) + _ar(cfg.ssm_d_inner, tp)
        if spec.ffn == "dense" and lay["ffn"]:
            fwd += _ar(n, tp)
            bwd += _ar(n, tp)
    loss = _gather(b * s, tp) + _ar(2 * b * s, tp)
    return {"forward": fwd, "step": fwd + loss + bwd + _gather(1, tp, 8)}


@pytest.mark.parametrize("arch", ["granite-3-8b", "mamba2-130m",
                                  REPLICATED_ATTN])
def test_tp_wire_bytes_equal_the_ring_formula(runs, arch):
    """Every rank's bytes on the model ring equal the ring formula (2
    (p-1)/p of each all-reduce's bytes a rank): in a forward on its data
    rank's rows, and on a (1, 4) mesh, where every exchange of a step is
    the model ring's, in a training step."""
    mesh, ranks, _, _ = runs
    want = _expected_bytes(arch, mesh[1], mesh[0])
    for r in ranks:
        got = r[f"bytes|{arch}"]
        assert got["forward"] == want["forward"]
        if mesh[0] == 1:
            assert got["step"] == want["step"]


def test_tp_1x2_splits_the_kv_heads(runs_1x2):
    """On a (1, 2) mesh the KV heads split too: logits, decode, gradient
    and moments against the single-rank run, the cache with 1 KV head."""
    ranks, data = runs_1x2
    got = ranks[0]["model|granite-3-8b"]
    want = single("granite-3-8b", data)
    np.testing.assert_allclose(got["logits"], want["logits"], **STEP_TOL)
    np.testing.assert_allclose(got["decode"], want["decode"], **STEP_TOL)
    _close(got["grads"], want["grads"], **STEP_TOL)
    _check_step(got, want["metrics"], want, want["p0"])
    cfg = smoke_config("granite-3-8b")
    assert got["cache_shapes"][0][2] == cfg.num_kv_heads // 2
    init = ranks[1]["init|granite-3-8b"]["params"]
    full = flatten(params_to_jax_layout(cfg, init_params(
        cfg, torch.Generator().manual_seed(3), device="cpu")))
    for k in full:
        np.testing.assert_array_equal(init[k], full[k], err_msg=k)


def test_tensor_parallel_raises_for_item_8b():
    """What a model axis still refuses, and what it takes since the MoE
    configs run without expert parallelism too: the layout of a tree
    needs its config, and expert parallelism needs an axis that divides
    the experts; without expert parallelism every MoE config (also one
    whose experts the axis does not divide, replicated then) initialises
    on meta with its rank's block of the experts, and ``shard_params``
    cuts the same blocks out of the whole draw."""
    from repro_torch.parallel import ParallelCtx, shard_params
    for arch in MOE_ARCHS:
        cfg = smoke_config(arch)
        ctx = ParallelCtx(tp=2, use_ep=False, model_rank=1)
        with pytest.raises(ValueError, match="needs the config"):
            shard_params({"embed": torch.zeros(1)}, ctx)
        meta = init_params(cfg, torch.Generator(), device="meta", ctx=ctx)
        full = init_params(cfg, torch.Generator().manual_seed(2),
                           device="cpu")
        mine = init_params(cfg, torch.Generator().manual_seed(2),
                           device="cpu", ctx=ctx)
        for a, b, c in zip(param_leaves(meta), param_leaves(mine),
                           param_leaves(shard_params(full, ctx, cfg))):
            assert a.shape == b.shape
            torch.testing.assert_close(b, c, rtol=0, atol=0)
        e = meta["layers"][-1]["ffn"]["w_gate"].shape[0]
        assert e == cfg.num_experts // 2
        odd = dataclasses.replace(cfg, num_experts=3)
        with pytest.raises(ValueError, match="do not split"):
            init_params(odd, torch.Generator(), device="meta",
                        ctx=ParallelCtx(tp=2, use_ep=True))
        meta = init_params(odd, torch.Generator(), device="meta", ctx=ctx)
        assert meta["layers"][-1]["ffn"]["w_gate"].shape[0] == 3
    for arch in ("llama-3.2-vision-90b", "seamless-m4t-medium",
                 "granite-3-8b"):
        init_params(smoke_config(arch), torch.Generator(), device="meta",
                    ctx=ParallelCtx(tp=2, use_ep=False))


def test_tensor_parallel_is_a_model_axis_without_ep():
    """A model axis is tensor parallelism with or without expert
    parallelism: it splits the layers whether or not it runs expert
    parallelism of the experts beside them: ``tensor_parallel`` is
    ``tp > 1``, and ``make_ctx`` picks EP for a MoE config and leaves it
    off for the others."""
    from repro_torch.parallel import ParallelCtx
    from repro_torch.parallel.planner import tp_layout
    assert ParallelCtx(tp=2, use_ep=False).tensor_parallel
    assert ParallelCtx(tp=2, use_ep=True).tensor_parallel
    assert not ParallelCtx(tp=1, use_ep=False).tensor_parallel
    assert not ParallelCtx(tp=1, use_ep=True).tensor_parallel
    lay = tp_layout(smoke_config("dbrx-132b"),
                    ParallelCtx(tp=2, use_ep=True, model_rank=1))
    assert lay.heads and lay.kv and lay.vocab and lay.rank == 1
