"""The port's building blocks, configs and device rules against the JAX
package: the same numpy inputs through both sides."""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import init_params as jax_init_params
from repro.models import modules as jm
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.core import resolve_device
from repro_torch.models import init_params
from repro_torch.models import modules as tm


def _rng(seed=0):
    return np.random.default_rng(seed)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_jax(arch, smoke):
    port = smoke_config(arch) if smoke else get_config(arch)
    ref = jax_smoke_config(arch) if smoke else jax_get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.padded_vocab == ref.padded_vocab
    assert [(s.mixer, s.ffn) for s in port.layer_specs()] == \
        [(s.mixer, s.ffn) for s in ref.layer_specs()]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    x = _rng().standard_normal((2, 5, 64), dtype=np.float32) * 3
    scale = _rng(1).standard_normal(64, dtype=np.float32)
    ref = jm.rms_norm(jnp.asarray(x).astype(dtype), jnp.asarray(scale), 1e-5)
    out = tm.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                      torch.from_numpy(scale), 1e-5)
    assert out.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("per_sequence", [False, True])
def test_apply_rope(theta, per_sequence):
    x = _rng().standard_normal((2, 6, 3, 32), dtype=np.float32)
    if per_sequence:  # decode: one position per sequence, (B, 1)
        x = x[:, :1]
        pos = np.array([[5], [300]], np.int32)
    else:
        pos = np.arange(100, 106, dtype=np.int32)
    ref = jm.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    out = tm.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("arch,act", [("qwen2-0.5b", "swiglu"),
                                      ("starcoder2-3b", "gelu"),
                                      ("qwen2-0.5b", "geglu")])
def test_ffn_apply(arch, act):
    cfg = dataclasses.replace(jax_smoke_config(arch), ffn_act=act)
    p = jm.init_ffn(jax.random.PRNGKey(0), cfg, cfg.d_ff, jnp.float32)
    x = _rng().standard_normal((2, 4, cfg.d_model), dtype=np.float32)
    ref = jm.ffn_apply(p, jnp.asarray(x), act)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    out = tm.ffn_apply(tp, torch.from_numpy(x), act)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout_matches_bridged_jax(arch):
    """The port's own init gives the tree the bridge builds from JAX's:
    same keys, shapes and dtype, layer by layer (the encoder's layers and
    the cross blocks included)."""
    cfg = smoke_config(arch)
    jp = jax_init_params(jax_smoke_config(arch), jax.random.PRNGKey(0))
    bridged = params_from_jax(cfg, _tree_np(jp), device="cpu")
    own = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    def layout(tree):
        if isinstance(tree, dict):
            return {k: layout(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [layout(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)

    assert layout(own) == layout(bridged)
    assert len(own["layers"]) == cfg.num_layers
    if cfg.is_encoder_decoder:
        assert len(own["encoder"]["layers"]) == cfg.encoder_layers
        assert len(own["cross"]) == cfg.num_layers
    mixer = own["layers"][0]["mixer"]
    w = next(mixer[k] for k in ("wq", "x_proj", "w_dq") if k in mixer)
    bound = 3.0 / np.sqrt(cfg.d_model)  # truncated at 3 sigma
    assert float(w.abs().max()) <= bound + 1e-6


def test_bridge_carries_bf16_and_unstacks_layers():
    cfg = smoke_config("qwen2-0.5b")
    jp = jax_init_params(jax_smoke_config("qwen2-0.5b"),
                         jax.random.PRNGKey(3), dtype=jnp.bfloat16)
    tree = _tree_np(jp)
    p = params_from_jax(cfg, tree, device="cpu")
    assert p["embed"].dtype == torch.bfloat16
    assert "lm_head" not in p  # tied embeddings
    for r in range(cfg.num_layers):
        np.testing.assert_array_equal(
            p["layers"][r]["mixer"]["bq"].float().numpy(),
            np.asarray(tree["group0"]["pos0"]["mixer"]["bq"][r], np.float32))
        np.testing.assert_array_equal(
            p["layers"][r]["ffn"]["w_down"].float().numpy(),
            np.asarray(tree["group0"]["pos0"]["ffn"]["w_down"][r],
                       np.float32))


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    cfg = smoke_config("qwen2-0.5b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg, torch.Generator())  # the default device is cuda
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax(cfg, {})
    assert resolve_device("cpu") == torch.device("cpu")
