"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's: the same layout and keys, so that a checkpoint written by either
package restores in the other; the manifest through the port's own
MessagePack coder, held against the ``msgpack`` package; and
``checkpoint_state_bytes``."""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import jax
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint.io import checkpoint_state_bytes as jax_state_bytes
from repro.checkpoint.io import restore_checkpoint as jax_restore
from repro.checkpoint.io import save_checkpoint as jax_save
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import init_params as jax_init_params
from repro.optim.adamw import init_opt_state as jax_init_opt_state
from repro_torch.bridge import (opt_state_from_jax, params_from_jax,
                                params_to_jax_layout)
from repro_torch.checkpoint import (checkpoint_state_bytes,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint import msgpack_lite
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.core.types import TrainConfig
from repro_torch.models import param_leaves, tree_map
from repro_torch.optim import init_opt_state
from repro_torch.parallel import ParallelCtx
from repro_torch.train import make_train_step
from torch_context import open_gates, stub_context


def _trained(arch="qwen2-0.5b"):
    """The port's params and optimizer state after one step from the JAX
    package's initial parameters (so m, v and step are not all zero; the
    cross-attention gates opened, and the stub context in the batch)."""
    cfg = smoke_config(arch)
    jp = jax_init_params(jax_smoke_config(arch), jax.random.PRNGKey(1))
    params = params_from_jax(cfg, open_gates(jax.tree.map(np.asarray, jp)),
                             "cpu")
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    batch = {"tokens": tok, "labels": np.roll(tok, -1, 1)}
    context = stub_context(cfg, 2)
    if context is not None:
        batch["context"] = context
    params, opt, _ = make_train_step(cfg, TrainConfig(remat=False))(
        params, init_opt_state(params), batch)
    return cfg, params, opt


def _assert_trees_equal(a, b):
    la, lb = list(param_leaves(a)), list(param_leaves(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "dbrx-132b",
                                  "deepseek-v2-236b", "llama-3.2-vision-90b",
                                  "seamless-m4t-medium"])
def test_round_trip(tmp_path, arch):
    cfg, params, opt = _trained(arch)
    path = save_checkpoint(cfg, str(tmp_path), 7, params, opt,
                           extra={"note": "x"})
    assert path.endswith("step_00000007")
    got, got_opt, step = restore_checkpoint(cfg, path, params, opt)
    assert step == 7
    _assert_trees_equal(got, params)
    _assert_trees_equal(got_opt["m"], opt["m"])
    _assert_trees_equal(got_opt["v"], opt["v"])
    assert int(got_opt["step"]) == int(opt["step"]) == 1


def test_round_trip_keeps_bf16(tmp_path):
    """bf16 leaves are written as f32 (exact) and come back in the
    template's dtype, bit for bit."""
    cfg, params, _ = _trained()
    params = tree_map(lambda t: t.bfloat16(), params)
    path = save_checkpoint(cfg, str(tmp_path), 1, params)
    got, opt, _ = restore_checkpoint(cfg, path, params)
    assert opt is None
    _assert_trees_equal(got, params)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    arch = "qwen2-0.5b"
    cfg = smoke_config(arch)
    jp = jax_init_params(jax_smoke_config(arch), jax.random.PRNGKey(2))
    jo = jax_init_opt_state(jp)
    jo = {"m": jax.tree.map(lambda a: a + 0.5, jo["m"]),
          "v": jax.tree.map(lambda a: a + 0.25, jo["v"]),
          "step": jo["step"] + 3}
    path = jax_save(str(tmp_path), 3, jp, jo)
    tmpl = params_from_jax(cfg, jax.tree.map(np.asarray, jp), "cpu")
    got, got_opt, step = restore_checkpoint(
        cfg, path, tmpl, init_opt_state(tmpl))
    assert step == 3
    _assert_trees_equal(got, tmpl)
    want = opt_state_from_jax(cfg, jax.tree.map(np.asarray, jo), "cpu")
    _assert_trees_equal(got_opt["m"], want["m"])
    _assert_trees_equal(got_opt["v"], want["v"])
    assert int(got_opt["step"]) == 3


def test_port_checkpoint_restores_in_jax(tmp_path):
    cfg, params, opt = _trained()
    path = save_checkpoint(cfg, str(tmp_path), 5, params, opt)
    jcfg = jax_smoke_config("qwen2-0.5b")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    got, got_opt, step = jax_restore(path, jp, jax_init_opt_state(jp))
    assert step == 5
    for tree, want in ((got, params), (got_opt["m"], opt["m"]),
                       (got_opt["v"], opt["v"])):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        ref = params_to_jax_layout(cfg, want)
        for kp, leaf in flat:
            node = ref
            for k in kp:
                node = node[k.key]
            np.testing.assert_array_equal(np.asarray(leaf), node)
    assert int(got_opt["step"]) == 1


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "llama-3.2-vision-90b",
                                  "seamless-m4t-medium"])
def test_context_family_checkpoint_restores_in_jax(tmp_path, arch):
    """A checkpoint of the port's MLA, cross-attention or encoder-decoder
    tree restores in the JAX package's layout, the ``encoder`` and
    ``cross`` stacks included, leaf for leaf."""
    cfg, params, opt = _trained(arch)
    path = save_checkpoint(cfg, str(tmp_path), 4, params, opt)
    jp = jax_init_params(jax_smoke_config(arch), jax.random.PRNGKey(0))
    got, got_opt, step = jax_restore(path, jp, jax_init_opt_state(jp))
    assert step == 4
    if cfg.is_encoder_decoder:
        assert set(got) >= {"encoder", "cross"}
        assert got["cross"]["gate_attn"].shape == (cfg.num_layers,)
    for tree, want in ((got, params), (got_opt["m"], opt["m"]),
                       (got_opt["v"], opt["v"])):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        ref = params_to_jax_layout(cfg, want)
        assert len(flat) == len(jax.tree_util.tree_leaves(ref))
        for kp, leaf in flat:
            node = ref
            for k in kp:
                node = node[k.key]
            np.testing.assert_array_equal(np.asarray(leaf), node)


def test_manifest_decodes_with_msgpack(tmp_path):
    """The port writes the JAX package's manifest, byte for byte what the
    ``msgpack`` package encodes."""
    cfg, params, opt = _trained()
    path = save_checkpoint(cfg, str(tmp_path), 2, params, opt,
                           extra={"tag": "a", "n": [1, -2, None, True]})
    raw = open(f"{path}/manifest.msgpack", "rb").read()
    manifest = msgpack.unpackb(raw)
    assert raw == msgpack.packb(manifest)
    assert manifest["step"] == 2
    assert manifest["extra"] == {"tag": "a", "n": [1, -2, None, True]}
    npz = np.load(f"{path}/arrays.npz")
    assert sorted([f"params/{k}" for k in manifest["params_keys"]]
                  + [f"opt_state/{k}" for k in manifest["opt_state_keys"]]
                  ) == sorted(npz.files)
    assert "step" in manifest["opt_state_keys"]


@pytest.mark.parametrize("obj", [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
    2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
    -2 ** 31, -2 ** 31 - 1, -2 ** 63, "", "a" * 31, "b" * 32, "c" * 255,
    "d" * 256, "e" * 65536, "ü∑", [], list(range(15)), list(range(16)),
    list(range(70000)), {}, {str(i): i for i in range(15)},
    {str(i): [i, None] for i in range(16)},
    {"step": 3, "extra": {}, "params_keys": ["embed", "group0/pos0/x"]}])
def test_msgpack_lite_matches_msgpack(obj):
    raw = msgpack_lite.packb(obj)
    assert raw == msgpack.packb(obj)
    assert msgpack_lite.unpackb(raw) == obj
    assert msgpack_lite.unpackb(msgpack.packb(obj)) == obj


def test_msgpack_lite_refuses_other_types():
    with pytest.raises(TypeError):
        msgpack_lite.packb({"x": 1.5})
    with pytest.raises(ValueError):
        msgpack_lite.unpackb(msgpack.packb(1.5))
    with pytest.raises(ValueError):
        msgpack_lite.unpackb(msgpack.packb(1) + b"\x00")


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_state_bytes_matches_jax(arch):
    assert checkpoint_state_bytes(get_config(arch)) == \
        jax_state_bytes(jax_get_config(arch))
    assert checkpoint_state_bytes(get_config(arch), 2, 4, 1) == \
        jax_state_bytes(jax_get_config(arch), 2, 4, 1)
    assert get_config(arch).param_counts() == \
        jax_get_config(arch).param_counts()


def test_sharded_state_must_be_gathered_first(tmp_path):
    cfg, params, _ = _trained()
    sharded = init_opt_state(params, ParallelCtx(dp=2, rank=1))
    with pytest.raises(ValueError, match="gather"):
        save_checkpoint(cfg, str(tmp_path), 1, params, sharded)
