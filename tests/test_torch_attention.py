"""The port's MLA and cross-attention modules against the JAX package's,
at smoke size on the CPU (neither reaches a Pallas kernel in JAX: both go
through the plain or chunked jnp attention), and the kernel launches the
new families make on the card, counted from their configs.  Weights are
JAX's ``init_mla`` / ``init_gqa(cross=True)``, the gate opened; inputs are
numpy from a seed."""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import attention as ja
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import attention as ta
from repro_torch.models import encode_launches, prefill_launches, tree_map
from torch_context import open_gates

TOL = dict(atol=1e-5, rtol=1e-5)


def _module(init, arch, seed=0, **kw):
    """(port cfg, JAX cfg, port params, JAX params) of one module."""
    jcfg = jax_smoke_config(arch)
    jp = open_gates(jax.tree.map(
        np.asarray, init(jax.random.PRNGKey(seed), jcfg, jnp.float32, **kw)))
    return smoke_config(arch), jcfg, \
        tree_map(lambda a: torch.from_numpy(np.array(a)), jp), \
        jax.tree.map(jnp.asarray, jp)


def _x(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("s", [16, 4096])
def test_mla_head_dims(s):
    """Port of tests/test_attention_props.py::test_mla_head_dims: MLA with
    distinct qk (head_dim + rope) and v head dims through the plain path
    (S 16) and the chunked online-softmax path (S 4096, above 2048^2
    scores), against JAX's ``mla_forward`` within 1e-5."""
    cfg, jcfg, p, jp = _module(ja.init_mla, "deepseek-v2-236b")
    assert cfg.resolved_head_dim + cfg.qk_rope_head_dim != \
        cfg.resolved_v_head_dim
    x = _x(s, 1, s, cfg.d_model, scale=0.02)
    want = ja.mla_forward(jp, jcfg, jnp.asarray(x), jnp.arange(s))
    got = ta.mla_forward(p, cfg, torch.from_numpy(x), torch.arange(s))
    assert got.shape == (1, s, cfg.d_model)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mla_decode_matches_jax():
    """The absorbed decode over the latent cache, per-sequence positions
    (slot 1 three steps behind slot 0), against JAX's ``mla_decode``:
    outputs and the written cache, every step."""
    cfg, jcfg, p, jp = _module(ja.init_mla, "deepseek-v2-236b", 1)
    b, steps, max_len = 2, 6, 12
    cache = ta.init_mla_cache(cfg, b, max_len, torch.float32, "cpu")
    jcache = ja.init_mla_cache(jcfg, b, max_len, jnp.float32)
    xs = _x(1, steps, b, 1, cfg.d_model)
    for t in range(steps):
        pos = np.array([t + 3, t], np.int32)
        want, jcache = ja.mla_decode(jp, jcfg, jnp.asarray(xs[t]), jcache,
                                     jnp.asarray(pos))
        got, cache = ta.mla_decode(p, cfg, torch.from_numpy(xs[t]), cache,
                                   torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for k in ("c", "k_rope"):
            np.testing.assert_allclose(cache[k].numpy(),
                                       np.asarray(jcache[k]), **TOL)


def test_mla_decode_equals_decompressed_forward():
    """Absorbing w_uk into the query and applying w_uv after the softmax
    computes the decompressed attention: decode step t equals
    ``mla_forward``'s row t."""
    cfg, _, p, _ = _module(ja.init_mla, "deepseek-v2-236b", 2)
    s = 8
    x = torch.from_numpy(_x(2, 2, s, cfg.d_model))
    full = ta.mla_forward(p, cfg, x, torch.arange(s))
    cache = ta.init_mla_cache(cfg, 2, s, torch.float32, "cpu")
    for t in range(s):
        out, cache = ta.mla_decode(p, cfg, x[:, t:t + 1], cache, t)
        np.testing.assert_allclose(out[:, 0].numpy(), full[:, t].numpy(),
                                   atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("t", [16, 24])  # the context as long as x, longer
def test_cross_attention_forward_matches_jax(t):
    cfg, jcfg, p, jp = _module(ja.init_gqa, "llama-3.2-vision-90b", 3,
                               cross=True)
    assert float(p["gate_attn"]) != 0
    x, ctx = _x(3, 2, 16, cfg.d_model), _x(4, 2, t, cfg.d_model)
    want = ja.cross_attention_forward(jp, jcfg, jnp.asarray(x),
                                      jnp.asarray(ctx))
    got = ta.cross_attention_forward(p, cfg, torch.from_numpy(x),
                                     torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cross_attention_decode_matches_jax():
    """``init_cross_cache`` and ``cross_attention_decode`` against JAX's,
    and decode against the forward (no mask: every step sees the whole
    context)."""
    cfg, jcfg, p, jp = _module(ja.init_gqa, "seamless-m4t-medium", 4,
                               cross=True)
    ctx = _x(5, 2, 10, cfg.d_model)
    cache = ta.init_cross_cache(p, cfg, torch.from_numpy(ctx), torch.float32)
    jcache = ja.init_cross_cache(jp, jcfg, jnp.asarray(ctx), jnp.float32)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   **TOL)
    x = _x(6, 2, 5, cfg.d_model)
    full = ta.cross_attention_forward(p, cfg, torch.from_numpy(x),
                                      torch.from_numpy(ctx))
    for t in range(5):
        want = ja.cross_attention_decode(jp, jcfg, jnp.asarray(x[:, t:t + 1]),
                                         jcache)
        got = ta.cross_attention_decode(p, cfg, torch.from_numpy(
            x[:, t:t + 1]), cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, t].numpy(),
                                   **TOL)


def test_prefill_and_encode_launches_of_the_context_families():
    """K1 launches of one prefill on the card, full configs: none for MLA
    (its layers' q and v head dims differ), a cross-attention layer or
    cross block only where S equals the context's length; the encoder's
    twelve counted apart (the caller encodes)."""
    ds = get_config("deepseek-v2-236b")
    assert prefill_launches(ds, 128) == {
        "flash_attention": 0, "ssd_scan": 0, "moe_gmm": 3 * 59}
    lv = get_config("llama-3.2-vision-90b")
    assert prefill_launches(lv)["flash_attention"] == 80
    assert prefill_launches(lv, 128)["flash_attention"] == 80
    assert prefill_launches(lv, 1601)["flash_attention"] == 100
    sm = get_config("seamless-m4t-medium")
    assert prefill_launches(sm, 128)["flash_attention"] == 12
    assert prefill_launches(sm, 1024)["flash_attention"] == 24
    assert encode_launches(sm) == {"flash_attention": 12}
    assert encode_launches(lv) == {"flash_attention": 0}
