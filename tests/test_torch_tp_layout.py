"""The port's layout rules (``repro_torch.parallel.planner``: ``guarded``,
``validate_spec``, ``_leaf_rule``, ``_mamba_head_axis``, ``param_specs``,
``cache_specs``) against the JAX package's, leaf for leaf, for every
architecture on both production meshes; and what the port's tensor
parallelism takes from them (``tp_layout``, ``shard_params``, the decode
cache).  Ports ``tests/test_planner.py``.  The port's trees are matched to
the JAX layout through ``bridge.to_jax_layout`` (a JAX leaf stacked over a
layer group's repeats has one more, unsharded, leading dim)."""
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
from repro.parallel.planner import cache_specs as jax_cache_specs
from repro.parallel.planner import param_specs as jax_param_specs
from repro_torch.bridge import layers_to_jax_layout, to_jax_layout
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.core.tree import param_leaves
from repro_torch.core.types import MeshConfig
from repro_torch.models import init_cache
from repro_torch.parallel import ParallelCtx, shard_params
from repro_torch.parallel.planner import (_with_paths, cache_specs,
                                          param_shapes, param_specs,
                                          tp_dims, tp_layout,
                                          validate_spec)

SINGLE_POD = MeshConfig()
MULTI_POD = MeshConfig(shape=(2, 16, 16), axis_names=("pod", "data",
                                                      "model"),
                       data_axes=("pod", "data"), model_axes=("model",))
MESHES = [(SINGLE_POD, JAX_SINGLE_POD), (MULTI_POD, JAX_MULTI_POD)]
TP_ARCHS = ("qwen2-0.5b", "granite-3-8b", "h2o-danube-1.8b",
            "starcoder2-3b", "mamba2-130m")


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
    ``param_specs`` decides for the leaves they name; ``shard_params``
    cuts each leaf the specs split to 1/tp along that dim, rank 1 holding
    the second block."""
    cfg = get_config(arch)
    ctx = ParallelCtx(tp=tp, use_ep=False, model_rank=1)
    lay = tp_layout(cfg, ctx)
    dims = tp_dims(cfg, ctx)
    leaves = {"heads": ("wq", "wo"), "kv": ("wk", "wv"),
              "ffn": ("w_gate", "w_up", "w_down"),
              "vocab": ("embed", "lm_head"),
              "ssm": ("z_proj", "x_proj", "dt_proj", "conv_x", "A_log",
                      "out_proj")}
    for flag, names in leaves.items():
        split = {dims[p] is not None for p in dims
                 if p.rsplit("/", 1)[-1] in names}
        assert split <= {getattr(lay, flag)}, (flag, split)
    full = param_shapes(cfg)
    mine = shard_params(full, ctx, cfg)
    for (path, t), (_, s) in zip(_with_paths(full), _with_paths(mine)):
        want = list(t.shape)
        if dims[path] is not None:
            want[dims[path]] //= tp
        assert list(s.shape) == want, path


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
