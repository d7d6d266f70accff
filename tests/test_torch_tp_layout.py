"""The port's layout rules (``repro_torch.parallel.planner``: ``guarded``,
``validate_spec``, ``_leaf_rule``, ``_mamba_head_axis``, ``param_specs``,
``cache_specs``, ``zero1_spec``, ``apply_fsdp``) against the JAX
package's, leaf for leaf, for every architecture on both production
meshes; and what the port's model axis takes from them (``tp_layout``,
``shard_params``, the decode cache).  Ports ``tests/test_planner.py``.  The port's trees are matched to
the JAX layout through ``bridge.to_jax_layout`` (a JAX leaf stacked over a
layer group's repeats has one more, unsharded, leading dim)."""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.core.types import MULTI_POD_MESH as JAX_MULTI_POD
from repro.core.types import SHAPES_BY_NAME
from repro.core.types import SINGLE_POD_MESH as JAX_SINGLE_POD
from repro.launch.specs import cache_shapes, decode_window
from repro.models.transformer import init_params as jax_init_params
from repro.parallel.planner import apply_fsdp as jax_apply_fsdp
from repro.parallel.planner import cache_specs as jax_cache_specs
from repro.parallel.planner import param_specs as jax_param_specs
from repro.parallel.planner import zero1_spec as jax_zero1_spec
from repro_torch.bridge import layers_to_jax_layout, to_jax_layout
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.core.tree import param_leaves
from repro_torch.core.types import MeshConfig
from repro_torch.models import init_cache
from repro_torch.parallel import ParallelCtx, shard_params
from repro_torch.parallel.planner import (_unflatten_like, _with_paths,
                                          apply_fsdp, cache_specs,
                                          expert_flags, param_shapes,
                                          param_specs, tp_dims, tp_layout,
                                          validate_spec, zero1_spec)

SINGLE_POD = MeshConfig()
MULTI_POD = MeshConfig(shape=(2, 16, 16), axis_names=("pod", "data",
                                                      "model"),
                       data_axes=("pod", "data"), model_axes=("model",))
MESHES = [(SINGLE_POD, JAX_SINGLE_POD), (MULTI_POD, JAX_MULTI_POD)]
TP_ARCHS = ("qwen2-0.5b", "granite-3-8b", "h2o-danube-1.8b",
            "starcoder2-3b", "mamba2-130m", "deepseek-v2-236b",
            "llama-3.2-vision-90b", "seamless-m4t-medium", "dbrx-132b",
            "jamba-1.5-large-398b")


def _stacked(specs: list):
    """A JAX leaf stacked over repeats: each repeat's spec the same, one
    unsharded dim in front."""
    assert all(sp == specs[0] for sp in specs), specs
    return (None, *specs[0])


def _jax(tree) -> list:
    return [tuple(sp) for sp in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, P))]


def _port(tree) -> list:
    return list(param_leaves(tree))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=["1pod", "2pod"])
def test_param_specs_equal_jax(arch, mesh):
    """Every leaf's spec equals the JAX package's, and both divide the
    leaf's dims; the planner notes name the same replicated leaves."""
    port_mesh, jax_mesh = mesh
    cfg = get_config(arch)
    notes, jax_notes = [], []
    shapes = param_shapes(cfg)
    specs = param_specs(cfg, port_mesh, notes, shapes=shapes)
    got = to_jax_layout(cfg, specs, lambda sp: sp, _stacked)
    want = jax_param_specs(jax_get_config(arch), jax_mesh, jax_notes)
    assert jax.tree.structure(got, is_leaf=lambda x: isinstance(x, tuple)) \
        == jax.tree.structure(jax.tree.map(
            tuple, want, is_leaf=lambda x: isinstance(x, P)),
            is_leaf=lambda x: isinstance(x, tuple))
    assert [tuple(sp) for sp in jax.tree.leaves(
        got, is_leaf=lambda x: isinstance(x, tuple))] == _jax(want)
    for sp, t in zip(_port(specs), _port(shapes)):
        assert validate_spec(sp, t.shape, port_mesh), (sp, t.shape)
    # JAX notes each replicated dim once per stacked leaf, the port once
    # per layer: the same leaf names, by rule
    name = lambda n: (n.split(":")[0], n.rsplit("/", 1)[-1])  # noqa: E731
    assert {name(n) for n in notes} == {name(n) for n in jax_notes}


@pytest.mark.parametrize("arch", ["granite-3-8b", "mamba2-130m",
                                  "deepseek-v2-236b",
                                  "jamba-1.5-large-398b"])
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
def test_cache_specs_equal_jax(arch, shape_name):
    """The decode cache's specs (the port's ``init_cache`` on the meta
    device) equal the JAX package's on both meshes."""
    shape = SHAPES_BY_NAME[shape_name]
    jcfg = jax_get_config(arch)
    j_shapes = jax.eval_shape(lambda: jax_init_params(
        jcfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16))
    j_cache = cache_shapes(jcfg, shape, j_shapes)
    cfg = get_config(arch)
    cache = init_cache(cfg, param_shapes(cfg), shape.global_batch,
                       shape.seq_len, dtype=torch.bfloat16,
                       window=decode_window(jcfg, shape))
    for port_mesh, jax_mesh in MESHES:
        specs = cache_specs(cfg, port_mesh, shape.global_batch, cache)
        got = layers_to_jax_layout(cfg, specs["layers"], lambda sp: sp,
                                   _stacked)
        want = jax_cache_specs(jcfg, jax_mesh, shape.global_batch, j_cache)
        assert [tuple(sp) for sp in jax.tree.leaves(
            got, is_leaf=lambda x: isinstance(x, tuple))] == _jax(want)
        for sp, t in zip(_port(specs), _port(cache)):
            assert validate_spec(sp, t.shape, port_mesh), (sp, t.shape)


def test_tp_shards_the_big_weights():
    cfg = get_config("granite-3-8b")
    g = param_specs(cfg, SINGLE_POD)["layers"][0]
    assert g["mixer"]["wq"] == (None, "model", None)
    assert g["ffn"]["w_gate"] == (None, "model")
    assert g["ffn"]["w_down"] == ("model", None)


def test_qwen2_attention_replicates_with_note():
    notes = []
    g = param_specs(get_config("qwen2-0.5b"), SINGLE_POD, notes)["layers"][0]
    assert g["mixer"]["wq"] == (None, None, None)
    assert any("wq" in n for n in notes)
    assert g["ffn"]["w_gate"] == (None, "model")


@pytest.mark.parametrize("arch", TP_ARCHS)
@pytest.mark.parametrize("tp", [2, 4, 16])
def test_tp_layout_is_what_the_specs_split(arch, tp):
    """``tp_layout``'s flags, which the model code reads, are what
    ``param_specs`` decides for the leaves they name (MLA's head leaves
    under ``heads``, the shared experts' under ``shared``);
    ``shard_params`` cuts each leaf the specs split to 1/tp along that
    dim (the experts of a MoE config, under expert parallelism, to their
    model rank's E/tp), rank 1 holding the second block."""
    cfg = get_config(arch)
    ctx = ParallelCtx(tp=tp, use_ep=cfg.is_moe, model_rank=1)
    lay = tp_layout(cfg, ctx)
    dims = tp_dims(cfg, ctx)
    full = param_shapes(cfg)
    experts = dict(zip((p for p, _ in _with_paths(full)),
                       expert_flags(full)))
    leaves = {"heads": ("wq", "wo", "w_uq", "w_uk", "w_uv"),
              "kv": ("wk", "wv"), "ffn": ("w_gate", "w_up", "w_down"),
              "vocab": ("embed", "lm_head"),
              "ssm": ("z_proj", "x_proj", "dt_proj", "conv_x", "A_log",
                      "out_proj")}
    for flag, names in leaves.items():
        split = {dims[p] is not None for p in dims
                 if p.rsplit("/", 1)[-1] in names and not experts[p]
                 and "/shared/" not in p}
        assert split <= {getattr(lay, flag)}, (flag, split)
    shared = {dims[p] is not None for p in dims if "/shared/" in p}
    assert shared <= {lay.shared}, shared
    assert {dims[p] for p in dims if experts[p]} <= {0}
    mine = shard_params(full, ctx, cfg)
    for (path, t), (_, s) in zip(_with_paths(full), _with_paths(mine)):
        want = list(t.shape)
        if dims[path] is not None:
            want[dims[path]] //= tp
        assert list(s.shape) == want, path


@functools.lru_cache(maxsize=4)
def _jax_specs(arch: str, mesh: int):
    jcfg = jax_get_config(arch)
    shapes = jax.eval_shape(lambda: jax_init_params(
        jcfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16))
    return jax_param_specs(jcfg, MESHES[mesh][1]), shapes


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", [0, 1], ids=["1pod", "2pod"])
def test_fsdp_and_zero1_specs_equal_jax(arch, mesh):
    """``apply_fsdp`` of the port's specs, then ``zero1_spec`` of each
    leaf, equal the JAX package's (``tests/test_planner.py``'s chain),
    leaf for leaf; ``zero1_spec`` itself equals JAX's on every stacked
    JAX leaf, and neither uses a mesh axis twice."""
    port_mesh, jax_mesh = MESHES[mesh]
    cfg = get_config(arch)
    shapes = param_shapes(cfg)
    fsdp = apply_fsdp(param_specs(cfg, port_mesh, shapes=shapes), shapes,
                      port_mesh)
    z1 = _unflatten_like(shapes, [
        zero1_spec(sp, tuple(t.shape), port_mesh)
        for (_, sp), (_, t) in zip(_with_paths(fsdp), _with_paths(shapes))])
    jspecs, jshapes = _jax_specs(arch, mesh)
    jfsdp = jax_apply_fsdp(jspecs, jshapes, jax_mesh)
    is_p = lambda x: isinstance(x, P)  # noqa: E731
    jz1 = jax.tree.map(lambda sp, sh: jax_zero1_spec(sp, sh.shape, jax_mesh),
                       jfsdp, jshapes, is_leaf=is_p)
    for got, want in ((fsdp, jfsdp), (z1, jz1)):
        got = to_jax_layout(cfg, got, lambda sp: sp, _stacked)
        assert [tuple(sp) for sp in jax.tree.leaves(
            got, is_leaf=lambda x: isinstance(x, tuple))] == _jax(want)
    for sp, sh in zip(jax.tree.leaves(jspecs, is_leaf=is_p),
                      jax.tree.leaves(jshapes)):
        assert zero1_spec(tuple(sp), sh.shape, port_mesh) == \
            tuple(jax_zero1_spec(sp, sh.shape, jax_mesh))
    for sp in _port(z1):
        used = [a for e in sp for a in
                (e if isinstance(e, tuple) else (e,)) if a]
        assert len(used) == len(set(used)), sp


def test_replicated_leaves_stay_whole():
    """Norm scales, Mamba's B and C projections and convolutions, and the
    vocabulary-parallel embedding of a tied head: the rules as the JAX
    package's (tests/test_planner.py)."""
    cfg = smoke_config("mamba2-130m")
    g = param_specs(cfg, MeshConfig((1, 4)))
    m = g["layers"][0]["mixer"]
    for name in ("b_proj", "c_proj", "conv_b", "conv_c"):
        assert all(ax is None for ax in m[name]), name
    assert m["norm"]["scale"] == (None,)
    assert m["z_proj"] == (None, "model")
    assert g["embed"] == ("model", None)
