"""The port's workload specs (``repro_torch.launch.specs``) against the JAX
package's (``repro.launch.specs``) for every architecture x input shape:
the decode window policy, the input stand-ins (meta tensors against
``jax.ShapeDtypeStruct``s) and the decode cache's leaves, the JAX
package's group-stacking dim removed as ``tests/test_torch_tp_layout.py``
removes it."""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import specs as jax_specs
from repro.models.transformer import init_params as jax_init_params
from repro_torch.bridge import layers_to_jax_layout
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.types import INPUT_SHAPES
from repro_torch.launch import specs
from repro_torch.models import param_leaves
from repro_torch.parallel.planner import param_shapes

SHAPES = [s.name for s in INPUT_SHAPES]
_DTYPES = {jnp.dtype(jnp.int32): torch.int32,
           jnp.dtype(jnp.bfloat16): torch.bfloat16,
           jnp.dtype(jnp.float32): torch.float32}


def _shape(name):
    from repro.core.types import SHAPES_BY_NAME as JAX_SHAPES
    from repro_torch.core.types import SHAPES_BY_NAME
    return SHAPES_BY_NAME[name], JAX_SHAPES[name]


def _same(got: torch.Tensor, want) -> None:
    assert got.device.type == "meta"
    assert tuple(got.shape) == tuple(want.shape)
    assert got.dtype == _DTYPES[jnp.dtype(want.dtype)]


@pytest.mark.parametrize("arch", ARCHS)
def test_window_inputs_and_context_equal_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name in SHAPES:
        shape, jshape = _shape(name)
        assert specs.decode_window(cfg, shape) == \
            jax_specs.decode_window(jcfg, jshape)
        assert specs.uses_swa_variant(cfg, shape) == \
            jax_specs.uses_swa_variant(jcfg, jshape)
        got = specs.input_specs(cfg, shape)
        want = jax_specs.input_specs(jcfg, jshape)
        assert list(got) == list(want)
        for k in want:
            _same(got[k], want[k])
        for b in (1, shape.global_batch):
            c, jc = (specs.context_spec(cfg, b, torch.bfloat16),
                     jax_specs.context_spec(jcfg, b, jnp.bfloat16))
            assert (c is None) == (jc is None)
            if c is not None:
                _same(c, jc)
    assert specs.SWA_VARIANT_WINDOW == jax_specs.SWA_VARIANT_WINDOW


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax.eval_shape(lambda: jax_init_params(
        jax_get_config(arch), jax.random.PRNGKey(0), dtype=jnp.bfloat16))


def _unstacked(specs_list):
    """A stacked JAX leaf: every repeat's (shape, dtype) the same, one
    leading dim of the repeats."""
    assert all(s == specs_list[0] for s in specs_list), specs_list
    shape, dtype = specs_list[0]
    return ((len(specs_list), *shape), dtype)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
def test_cache_shapes_equal_jax(arch, shape_name):
    """Every leaf of the port's decode cache (``init_cache`` on the meta
    device) has the shape and dtype of the JAX package's, the layers
    stacked per group as the JAX tree holds them."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    shape, jshape = _shape(shape_name)
    p_shapes = param_shapes(cfg)
    cache = specs.cache_shapes(cfg, shape, p_shapes)
    want = jax_specs.cache_shapes(jcfg, jshape, _jax_params(arch))
    for t in param_leaves(cache):
        assert t.device.type == "meta"

    def leaf(t):
        return tuple(t.shape), t.dtype

    got = {"layers": layers_to_jax_layout(cfg, cache["layers"], leaf,
                                          _unstacked)}
    if "cross" in cache:
        from repro_torch.bridge import _stack
        got["cross"] = _stack(cache["cross"], leaf, _unstacked)
    j_layers = {k: v for k, v in want.items() if k.startswith("group")}
    flat_want = jax.tree.leaves({"layers": j_layers,
                                 **({"cross": want["cross"]}
                                    if "cross" in want else {})})
    flat_got = jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, tuple)
                               and len(x) == 2 and isinstance(x[1],
                                                              torch.dtype))
    assert len(flat_got) == len(flat_want)
    for (shp, dt), w in zip(flat_got, flat_want):
        assert shp == tuple(w.shape)
        assert dt == _DTYPES[jnp.dtype(w.dtype)]
    n_bytes = sum(t.numel() * t.element_size() for t in param_leaves(cache))
    assert n_bytes == sum(int(np.prod(w.shape)) * w.dtype.itemsize
                          for w in jax.tree.leaves(want))
