"""The port's decode on a cache whose slot axis is split over the data
axes (``repro_torch.parallel.sequence``: a batch that the data axes do not
divide, the JAX package's ``kv_cache_seqsharded`` and
``mla_cache_seqsharded`` of ``cache_specs``) against the JAX package's
``decode_step`` and against the port's own single-rank run, at smoke size
on the CPU.

For the (4, 1) mesh one ``spawn_ranks`` of 4 gloo ranks runs every case
(``torch_seq_ranks.seq_cases``) and, at the same time, one JAX subprocess
on 4 forced host devices runs, for each case, the JAX package's jitted
``decode_step`` over its 6 steps twice: on the whole cache on one device,
and with the cache placed by the JAX ``cache_specs`` (and the parameters
by ``param_specs``) on a mesh of Auto axes (ROADMAP R5), whose per-device
shard shapes it records.  The inputs are the JAX package's parameters
(``init_params``, key 0), a whole cache and the tokens from numpy (seed
0); each rank copies its block of the cache.  The (2, 2) mesh's cases,
whose model axis splits the heads beside the split slots, are
``tests/test_torch_seq_decode_2x2.py``'s.

Tolerances: the logits ``tests/test_pallas_integration.py``'s (atol 5e-4,
rtol 1e-3, f32) against JAX and 1e-5 against the single-rank run; every
rank's logits bit-equal.  The two planted faults (the combine skipped, the
new token written on every rank) move the logits beyond five times the
tolerance.
"""
import concurrent.futures
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from helpers import run_multidevice
from repro.configs import smoke_config as jax_smoke_config
from repro.models import init_params as jax_init_params
from repro_torch.bridge import layers_to_jax_layout, params_from_jax
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.models import init_cache, init_params
from repro_torch.parallel.sequence import combine_bytes
from torch_dp_ranks import flatten, nest
from torch_seq_ranks import (SEQ_VARIANTS, seq_cases, seq_config, seq_run,
                             whole_layers)

LOGIT_TOL = dict(atol=5e-4, rtol=1e-3)    # tests/test_pallas_integration.py
SINGLE_TOL = dict(atol=1e-5, rtol=1e-5)   # tests/test_torch_tp.py
STEPS = 6
FAULT_MARGIN = 5


def steps_from(first: int) -> list:
    return list(range(first, first + STEPS))


# (4, 1): each rank holds a quarter of the slots
CASES = {
    # ring of 64, 16 slots a rank; at positions 0-2 ranks 1-3 hold no
    # valid slot (the -inf guard); from 15 to 16 the owner moves
    "gqa": dict(config="qwen2-0.5b", max_len=64,
                positions=[0, 1, 2, 15, 16, 17]),
    # the sliding-window ring (window 16, 4 slots a rank), several windows
    # past it: the owner moves from rank 1 to rank 2
    "swa_ring": dict(config="qwen2-0.5b-swa16", max_len=256,
                     positions=steps_from(100)),
    # a window of 24 shorter than the ring of 64, the ring wrapped twice
    "window": dict(config="qwen2-0.5b", max_len=64, window=24,
                   positions=steps_from(150)),
    "mla": dict(config="deepseek-v2-236b", max_len=64,
                positions=[0, 1, 2, 31, 32, 33]),
    # a Mamba layer's whole state beside a split attention layer
    "hybrid": dict(config="jamba-1.5-large-398b", max_len=64,
                   positions=steps_from(20)),
    # 4 does not divide 30 slots: the cache stays whole, no combine
    "guarded": dict(config="qwen2-0.5b", max_len=30,
                    positions=steps_from(40)),
}
FAULT_CASES = {
    f"fault|{f}": dict(config="qwen2-0.5b", max_len=64,
                       positions=steps_from(50), fault=f)
    for f in ("no_combine", "write_all")}

_JAX_SCRIPT = """
import dataclasses, json, sys
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import smoke_config
from repro.core.types import MeshConfig
from repro.models import decode_step
from repro.parallel.planner import cache_specs, make_ctx, param_specs

inputs, cases_json, mesh_json, out_path, variants_json = sys.argv[1:6]
data = np.load(inputs)
cases, variants = json.loads(cases_json), json.loads(variants_json)
dp, tp = json.loads(mesh_json)
mesh = jax.make_mesh((dp, tp), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
mcfg = MeshConfig((dp, tp))
is_p = lambda x: isinstance(x, P)
shard = lambda sp: NamedSharding(mesh, sp)

def nest(prefix):
    tree = {}
    for key in data.files:
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(data[key])
    return tree

def config(name):
    if name in variants:
        base, fields = variants[name]
        return dataclasses.replace(smoke_config(base), name=name, **fields)
    return smoke_config(name)

out = {}
for name, case in cases.items():
    cfg = config(case["config"])
    params = nest("params|" + case["config"] + "|")
    cache = nest("jcache|" + name + "|")
    tokens = jnp.asarray(data["tokens|" + name])
    positions = [np.asarray(p, np.int32) for p in case["positions"]]

    def run(p, c, ctx):
        step = jax.jit(lambda p_, c_, t_, q_: decode_step(
            cfg, p_, c_, t_, q_, ctx=ctx, window=case.get("window")))
        got = []
        for t, q in enumerate(positions):
            lg, c = step(p, c, tokens[:, t:t + 1], q)
            got.append(np.asarray(lg[:, 0]))
        return np.stack(got, 1)

    out[name + "|whole"] = run(params, cache, None)
    ctx = make_ctx(mesh, mcfg, remat=False, use_ep=cfg.is_moe and tp > 1)
    if cfg.is_moe:  # no dispatch dropped
        ctx = dataclasses.replace(
            ctx, capacity_factor=float(cfg.num_experts),
            decode_capacity_factor=float(cfg.num_experts))
    params = jax.device_put(params, jax.tree.map(
        shard, param_specs(cfg, mcfg), is_leaf=is_p))
    cache = jax.device_put(cache, jax.tree.map(
        shard, cache_specs(cfg, mcfg, tokens.shape[0], cache), is_leaf=is_p))
    for kp, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]:
        out[name + "|shard|" + "/".join(str(k.key) for k in kp)] = \\
            np.asarray(leaf.addressable_shards[0].data.shape)
    out[name + "|sharded"] = run(params, cache, ctx)
np.savez(out_path, **out)
print("OK")
"""


def jax_seq_config(name: str):
    """The JAX package's config of ``seq_config(name)``."""
    if name in SEQ_VARIANTS:
        arch, fields = SEQ_VARIANTS[name]
        return dataclasses.replace(jax_smoke_config(arch), name=name,
                                   **fields)
    return jax_smoke_config(name)


def _stacked(xs):
    return np.stack(xs)


def seq_inputs(tmp, cases: dict) -> str:
    """The JAX package's parameters of every config, and of each case its
    tokens (B, STEPS) and a whole cache of ``max_len`` (``init_window``)
    from numpy, seed 0, in the port's layout (``cache|<case>|<layer>|
    <leaf>``) and in the JAX package's (``jcache|<case>|<path>``)."""
    rng = np.random.default_rng(0)
    data = {}
    for name in sorted({c["config"] for c in cases.values()}):
        jp = jax_init_params(jax_seq_config(name), jax.random.PRNGKey(0))
        data.update({f"params|{name}|{k}": v for k, v in flatten(
            jax.tree.map(np.asarray, jp)).items()})
    for name, case in cases.items():
        cfg = seq_config(case["config"])
        b = case.get("batch", 1)
        data[f"tokens|{name}"] = rng.integers(
            0, cfg.vocab_size, (b, STEPS)).astype(np.int32)
        meta = init_cache(cfg, init_params(cfg, torch.Generator(),
                                           device="meta"),
                          b, case["max_len"], window=case.get("init_window"))
        layers = []
        for i, lc in enumerate(meta["layers"]):
            layers.append({})
            for leaf, t in lc.items():
                scale = 1.0 if leaf in ("k", "v", "c", "k_rope") else 0.1
                arr = (scale * rng.standard_normal(tuple(t.shape))
                       ).astype(np.float32)
                layers[-1][leaf] = data[f"cache|{name}|{i}|{leaf}"] = arr
        data.update({f"jcache|{name}|{k}": v for k, v in flatten(
            layers_to_jax_layout(cfg, layers, lambda a: a,
                                 _stacked)).items()})
    path = str(tmp / "inputs.npz")
    np.savez(path, **data)
    return path


def seq_mesh_runs(mesh, tmp, cases: dict, jax_cases: dict):
    """``cases`` on the mesh's 4 ranks and JAX's whole and sharded decode
    of ``jax_cases`` on its 4 devices, at once: (mesh, the ranks' results,
    JAX's arrays, the inputs, the cases)."""
    inputs = seq_inputs(tmp, cases)
    script = (f"import sys; sys.argv = ['', {inputs!r}, "
              f"{json.dumps(jax_cases)!r}, {json.dumps(list(mesh))!r}, "
              f"{str(tmp / 'jax.npz')!r}, {json.dumps(SEQ_VARIANTS)!r}]\n"
              + _JAX_SCRIPT)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(run_multidevice, script, num_devices=4,
                              timeout=300)
        ranks = spawn_ranks(seq_cases, 4, mesh, inputs, cases,
                            timeout_s=300)
        jax_run.result()
    return (mesh, ranks, dict(np.load(tmp / "jax.npz")),
            dict(np.load(inputs)), cases)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on the (4, 1) mesh's 4 ranks and on JAX's 4 devices."""
    return seq_mesh_runs((4, 1), tmp_path_factory.mktemp("seq4x1"),
                         {**CASES, **FAULT_CASES}, CASES)


_SINGLE: dict = {}


def single(runs, name: str) -> np.ndarray:
    """The port's single-rank logits of the case (no fault), on the whole
    cache."""
    _, _, _, data, cases = runs
    key = (id(data), name)
    if key not in _SINGLE:
        case = dict(cases[name], fault=None)
        cfg = seq_config(case["config"])
        prefix = f"params|{case['config']}|"
        params = params_from_jax(cfg, nest({
            k[len(prefix):]: v for k, v in data.items()
            if k.startswith(prefix)}), "cpu")
        case["tokens"] = data[f"tokens|{name}"]
        _SINGLE[key] = seq_run(cfg, params, whole_layers(data, name, cfg),
                               case)["logits"]
    return _SINGLE[key]


def want_bytes(cfg, mesh, case: dict) -> int:
    """A rank's wire bytes a decode step: the combine's
    (``combine_bytes``), and on a model axis the ring all-reduces of the
    decode (``chip_smoke.tp_forward_bytes``, f32, the logits not
    gathered); without one, a MoE config's ``moe_dense`` gathers each MoE
    layer's E pick fractions (f32) over the data ranks (``route``; decode
    discards the router loss)."""
    dp, tp = mesh
    b = case.get("batch", 1)
    n = combine_bytes(cfg, dp, tp, b, case["max_len"],
                      case.get("init_window"))
    if tp > 1:
        return n + chip_smoke.tp_forward_bytes(
            cfg, tp, b, 1, 4, gather=False,
            moe="decode" if cfg.is_moe else None)
    n_moe = sum(s.ffn == "moe" for s in cfg.layer_specs())
    return n + n_moe * (dp - 1) * cfg.num_experts * 4


def check_matches_jax(runs, name):
    """The ranks' logits (gathered over the vocabulary) against JAX's
    decode on the whole cache; JAX's own run on the cache that its
    ``cache_specs`` shards against the same."""
    _, ranks, jax_out, _, _ = runs
    want = jax_out[f"{name}|whole"]
    np.testing.assert_allclose(ranks[0][name]["logits"], want, **LOGIT_TOL)
    np.testing.assert_allclose(jax_out[f"{name}|sharded"], want,
                               **LOGIT_TOL)


def check_matches_single_rank(runs, name):
    _, ranks, _, _, _ = runs
    np.testing.assert_allclose(ranks[0][name]["logits"], single(runs, name),
                               **SINGLE_TOL)


def check_ranks_bit_equal(runs, name):
    _, ranks, _, _, _ = runs
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[name]["logits"],
                                      ranks[0][name]["logits"])


def check_shard_shapes(runs, name, split: bool):
    """Each rank's cache leaves have the per-device shard shapes of JAX's
    cache placed by its ``cache_specs`` (the group-stacking dim aside);
    the attention layers are ``SlotBlock``s exactly where ``split``."""
    _, ranks, jax_out, _, cases = runs
    cfg = seq_config(cases[name]["config"])
    want = {k.split("|", 2)[2]: tuple(int(d) for d in v)
            for k, v in jax_out.items() if k.startswith(f"{name}|shard|")}
    assert want
    for r in ranks:
        got = flatten(layers_to_jax_layout(
            cfg, r[name]["shapes"], lambda s: s,
            lambda xs: (len(xs), *xs[0])))
        assert got == want
        attn = [s.mixer == "attn" for s in cfg.layer_specs()]
        assert r[name]["blocks"] == [a and split for a in attn]


def check_wire_bytes(runs, name):
    mesh, ranks, _, _, cases = runs
    case = cases[name]
    want = want_bytes(seq_config(case["config"]), mesh, case)
    for r in ranks:
        assert r[name]["bytes"] == [want] * STEPS


def check_fault_caught(runs, name):
    """The faulty decode moves the logits beyond ``FAULT_MARGIN`` times
    the JAX tolerance from the single-rank run."""
    _, ranks, _, _, _ = runs
    want = single(runs, name)
    got = ranks[0][name]["logits"]
    err = float(np.nan_to_num(np.abs(got - want), nan=np.inf).max())
    bound = LOGIT_TOL["atol"] + LOGIT_TOL["rtol"] * float(np.abs(want).max())
    assert err > FAULT_MARGIN * bound, (name, err, bound)


@pytest.mark.parametrize("name", sorted(CASES))
def test_seq_decode_matches_jax(runs, name):
    check_matches_jax(runs, name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_seq_decode_matches_single_rank(runs, name):
    check_matches_single_rank(runs, name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_seq_decode_ranks_bit_equal(runs, name):
    check_ranks_bit_equal(runs, name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_seq_cache_shards_are_jax_cache_specs(runs, name):
    check_shard_shapes(runs, name, split=name != "guarded")


@pytest.mark.parametrize("name", sorted(CASES))
def test_seq_decode_wire_bytes_equal_the_formula(runs, name):
    check_wire_bytes(runs, name)


def test_guarded_cache_has_no_combine(runs):
    """Slots that the data ranks do not divide: every rank holds the whole
    cache (``guarded``) and sends nothing."""
    _, ranks, _, _, cases = runs
    cfg = seq_config(cases["guarded"]["config"])
    assert combine_bytes(cfg, 4, 1, 1, cases["guarded"]["max_len"]) == 0
    for r in ranks:
        assert r["guarded"]["bytes"] == [0] * STEPS
        assert r["guarded"]["shapes"][0]["k"][1] == 30


def test_rank_holds_a_quarter_of_the_cache(runs):
    """A split rank's cache is 1/4 of the whole (qwen2: every layer's)."""
    _, ranks, _, data, _ = runs
    whole = sum(v.size * 4 for k, v in data.items()
                if k.startswith("cache|gqa|"))
    for r in ranks:
        assert r["gqa"]["cache_bytes"] * 4 == whole


@pytest.mark.parametrize("name", sorted(FAULT_CASES))
def test_planted_fault_is_caught(runs, name):
    check_fault_caught(runs, name)


def test_combine_bytes_formula():
    """The formula at the card's shapes: qwen2-0.5b on (4, 1), 24 layers
    of 14 heads of 64; deepseek-v2-236b's 2 layers on (2, 2), 64 heads a
    rank, the value head of 128 after ``w_uv``; a batch that the data
    axes divide, and a window that keeps the ring whole, send none."""
    from repro_torch.configs import get_config
    qwen = get_config("qwen2-0.5b")
    assert combine_bytes(qwen, 4, 1, 1, 524_288) == 24 * 11_088 == 266_112
    assert combine_bytes(qwen, 4, 1, 1, 524_288, 8_192) == 266_112
    assert combine_bytes(qwen, 4, 1, 4, 524_288) == 0
    assert combine_bytes(qwen, 4, 1, 1, 524_286) == 0
    ds = dataclasses.replace(get_config("deepseek-v2-236b"), num_layers=2)
    assert combine_bytes(ds, 2, 2, 1, 524_288) == 2 * 33_280
