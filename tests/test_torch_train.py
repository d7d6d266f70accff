"""The port's training slice against the JAX package, at smoke size on the
CPU: data, loss, schedule and AdamW (ports of tests/test_train_features.py).
The whole step is in ``test_torch_train_dense.py`` (and, per family,
``test_torch_train_families.py``, ``test_torch_train_context.py``, with
the chunked attention path and the launch counts); the shared parts in
``torch_train_cases.py``.  Weights and optimizer state are the JAX
package's, carried over by the bridge; inputs are made with numpy from a
seed.  The JAX side runs as its own tests run it: jitted, on the CPU,
through the plain attention path."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from torch_train_cases import (adamw_update, _assert_trees_close, BF16_TOL,
                               _both, cross_entropy, global_norm,
                               init_opt_state, init_params, jax_adamw_update,
                               jax_cross_entropy, jax_global_norm,
                               jax_init_opt_state, jax_lr_schedule,
                               jax_make_batches, jax_smoke_config,
                               JaxSyntheticLM, JaxTrainConfig, lr_schedule,
                               make_batches, make_train_step, param_leaves,
                               params_from_jax, smoke_config, SyntheticLM, TOL,
                               TrainConfig, tree_map)


# --- data ------------------------------------------------------------------

@pytest.mark.parametrize("arch,batch,seq,seed", [
    ("qwen2-0.5b", 8, 64, 0), ("mamba2-130m", 3, 17, 5),
    ("granite-3-8b", 2, 128, 11)])
def test_make_batches_equals_jax(arch, batch, seq, seed):
    cfg = smoke_config(arch)
    ours = make_batches(cfg, batch, seq, seed=seed)
    theirs = jax_make_batches(jax_smoke_config(arch), batch, seq, seed=seed)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_recurrence_pattern_equals_jax():
    a = SyntheticLM(97, 32, seed=3, pattern="recurrence").batch(1, 4, 5)
    b = JaxSyntheticLM(97, 32, seed=3, pattern="recurrence").batch(1, 4, 5)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])


# --- loss ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_jax(dtype):
    """Padded vocab with the LM head's -1e30 bias, ignore_index labels."""
    cfg = smoke_config("qwen2-0.5b")
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 10, cfg.padded_vocab)) * 3
    logits[..., cfg.vocab_size:] = -1e30
    labels = rng.integers(0, cfg.vocab_size, (3, 10)).astype(np.int32)
    labels[0, :4] = -1
    labels[2, 7] = -1
    port = cross_entropy(torch.from_numpy(logits).to(getattr(torch, dtype)),
                         torch.from_numpy(labels))
    ref = jax_cross_entropy(jnp.asarray(logits).astype(getattr(jnp, dtype)),
                            jnp.asarray(labels))
    assert port.dtype == torch.float32
    np.testing.assert_allclose(float(port), float(ref), rtol=1e-6)


def test_cross_entropy_manual_and_all_ignored():
    """tests/test_train_features.py:99-113, and a batch with every label
    ignored (mean over max(count, 1): 0)."""
    got = float(cross_entropy(torch.tensor([[[2.0, 0.0, -1.0],
                                              [0.0, 3.0, 0.0]]]),
                              torch.tensor([[0, 1]])))
    want = -(math.log(math.exp(2) / (math.exp(2) + 1 + math.exp(-1)))
             + math.log(math.exp(3) / (2 + math.exp(3)))) / 2
    assert got == pytest.approx(want, rel=1e-6)
    got = float(cross_entropy(torch.zeros(1, 3, 4),
                              torch.tensor([[1, -1, -1]])))
    assert got == pytest.approx(math.log(4), rel=1e-6)
    assert float(cross_entropy(torch.ones(1, 2, 4),
                               torch.tensor([[-1, -1]]))) == 0.0


# --- schedule --------------------------------------------------------------

@pytest.mark.parametrize("tcfg", [
    TrainConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100),
    TrainConfig(), TrainConfig(warmup_steps=0, total_steps=7)])
def test_lr_schedule_matches_jax(tcfg):
    jcfg = JaxTrainConfig(**dataclasses.asdict(tcfg))
    for s in range(tcfg.total_steps + 11):
        want = float(jax_lr_schedule(jnp.asarray(s, jnp.int32), jcfg))
        for step in (s, torch.tensor(s, dtype=torch.int32)):
            got = lr_schedule(step, tcfg)
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12)


# --- AdamW -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [1e-5, 10.0])  # clip off / on
def test_adamw_update_matches_jax(dtype, grad_scale):
    """Two updates from the same params and grads (the second with the
    bias corrections of step 2), the clip inactive and active."""
    cfg, params, jcfg, jp = _both("qwen2-0.5b", 1)
    dt = getattr(jnp, dtype)
    jp = jax.tree.map(lambda a: a.astype(dt), jp)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(2)
    jg = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape) * grad_scale, jnp.float32), jp)
    grads = params_from_jax(cfg, jax.tree.map(np.asarray, jg), device="cpu")
    tcfg = TrainConfig(warmup_steps=2)
    jtcfg = JaxTrainConfig(warmup_steps=2)
    jo = jax_init_opt_state(jp)
    opt = init_opt_state(params)
    for _ in range(2):
        jlr = jax_lr_schedule(jo["step"], jtcfg)
        jp, jo, jm = jax_adamw_update(jp, jg, jo, jtcfg, jlr)
        params, opt, m = adamw_update(params, grads, opt, tcfg,
                                      lr_schedule(opt["step"], tcfg))
    clip = min(1.0, 1.0 / float(jm["grad_norm"]))
    assert (clip < 1.0) == (grad_scale > 1.0)
    assert int(opt["step"]) == int(jo["step"]) == 2
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-5)
    assert all(t.dtype == getattr(torch, dtype)
               for t in param_leaves(params))
    _assert_trees_close(cfg, params, jp,
                        **(TOL if dtype == "float32" else BF16_TOL))
    _assert_trees_close(cfg, opt["m"], jo["m"], **TOL)
    _assert_trees_close(cfg, opt["v"], jo["v"], **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_update_in_pieces_gives_the_same_bits(monkeypatch, dtype):
    """AdamW's update in pieces (``UPDATE_CHUNK`` values: small leaves
    grouped, large contiguous ones sliced, a non-contiguous one whole) is
    the update over all leaves at once, bit for bit, and the norm of a
    leaf taken in pieces is its norm."""
    from repro_torch.optim import adamw
    gen = torch.Generator().manual_seed(0)
    shapes = [(3000,), (10, 7), (500,), (2500,), (40, 40)]
    params = [torch.randn(s, generator=gen).to(dtype) for s in shapes]
    params[-1] = params[-1].t()  # a transposed leaf stays whole
    grads = [torch.randn(p.shape, generator=gen) for p in params]
    tcfg, lr = TrainConfig(), torch.tensor(1e-3)
    runs = []
    for chunk in (adamw.UPDATE_CHUNK, 1000):
        monkeypatch.setattr(adamw, "UPDATE_CHUNK", chunk)
        p = [t.clone() for t in params]
        state = init_opt_state(p)
        for _ in range(2):
            p, state, m = adamw_update(p, grads, state, tcfg, lr)
        runs.append((p, state, m))
    (p0, s0, m0), (p1, s1, m1) = runs
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert all(torch.equal(a, b) for k in ("m", "v")
               for a, b in zip(s0[k], s1[k]))
    assert float(m1["grad_norm"]) == pytest.approx(float(m0["grad_norm"]),
                                                   rel=1e-12)


def test_global_norm_holds_f32_accuracy_over_large_leaves():
    """The clip norm over a 4M-value leaf (qwen2-0.5b's MLP matrices have
    4.4M values, its embedding 136M) within 1e-6 of the f64 norm, on the
    CPU as on the card: PyTorch's f32 norm on the CPU drifts at this size
    (about 2e-4 on those matrices; ``chip_smoke.py``'s ``train_parity``
    line measures it on the card machine's host)."""
    x = torch.randn(1 << 22, generator=torch.Generator().manual_seed(0))
    leaves = [x * 1e-3, torch.ones(7, 3), (x[:1000] * 5).bfloat16()]
    want = math.sqrt(sum(float(t.double().square().sum()) for t in leaves))
    got = global_norm(leaves)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("acc", [torch.float32, torch.float64])
def test_global_norm_matches_jax(acc, dtype):
    """The port sums each leaf's norm in f64 where JAX's ``global_norm``
    is f32 throughout; at smoke size either accumulation agrees with JAX
    within the 1e-5 of the step tests, so the departure stays visible."""
    cfg, params, jcfg, jp = _both("granite-3-8b", seed=3)
    if dtype == "bfloat16":
        params = tree_map(lambda t: t.bfloat16(), params)
        jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    want = float(jax_global_norm(jp))
    got = global_norm(params, acc=acc)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-5)


def test_train_step_remat_is_one_setting():
    """``make_train_step``'s keyword spells ``TrainConfig.remat`` and may
    not contradict it."""
    cfg = smoke_config("qwen2-0.5b")
    make_train_step(cfg, TrainConfig(remat=True), remat=True)
    with pytest.raises(ValueError, match="remat"):
        make_train_step(cfg, TrainConfig(remat=True), remat=False)


@given(scale=st.floats(0.1, 100.0))
@settings(max_examples=10, deadline=None)
def test_grad_clip_bounds_update(scale):
    """Port of tests/test_train_features.py:83-96: the clipped gradient's
    norm never exceeds grad_clip."""
    cfg = smoke_config("qwen2-0.5b")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    tcfg = TrainConfig(grad_clip=1.0, weight_decay=0.0, remat=False)
    grads = [torch.full_like(p, scale) for p in param_leaves(params)]
    _, _, metrics = adamw_update(params, grads, init_opt_state(params), tcfg,
                                 torch.tensor(1e-3))
    gnorm = float(metrics["grad_norm"])
    assert gnorm == pytest.approx(float(global_norm(grads)))
    assert gnorm * min(1.0, tcfg.grad_clip / gnorm) <= tcfg.grad_clip * 1.001
