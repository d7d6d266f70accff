"""The port's training step against the JAX package's on the dense
configs (qwen2-0.5b's microbatches and bf16 gradients, granite with and
without remat), and the step's other properties: remat changes no
number, the eval step (alone and on a mesh), serving parameters left
without gradients, the microbatch check, and the learning test of
tests/test_system.py::test_training_learns_synthetic_pattern."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.launch.ranks import spawn_ranks
from torch_context import open_gates, stub_context
from torch_tp_ranks import tp_eval
from torch_train_cases import (_batch, _both, check_train_step, init_opt_state,
                               init_params, jax_make_eval_step, make_batches,
                               make_eval_step, make_prefill, make_train_step,
                               param_leaves, params_from_jax,
                               params_to_jax_layout, smoke_config, step_cases,
                               TrainConfig)


@pytest.mark.parametrize("arch,overrides,remat",
                         step_cases(("qwen2-0.5b", "granite-3-8b")))
def test_train_step_matches_jax(arch, overrides, remat):
    """One step from shared params, state and batch against the JAX
    package's (``torch_train_cases.check_train_step``)."""
    check_train_step(arch, overrides, remat)


def test_remat_equals_no_remat():
    """tests/test_train_features.py:59-70 on the port: checkpointing each
    layer changes no number of the step."""
    cfg, params, _, _ = _both("granite-3-8b")
    batch = _batch(cfg)
    outs = []
    for remat in (False, True):
        p = params_from_jax(cfg, params_to_jax_layout(cfg, params),
                            device="cpu")
        p, o, m = make_train_step(cfg, TrainConfig(remat=remat))(
            p, init_opt_state(p), batch)
        outs.append((m, list(param_leaves(p)), list(param_leaves(o["m"]))))
    (ma, pa, oa), (mb, pb, ob) = outs
    assert float(ma["loss"]) == pytest.approx(float(mb["loss"]), rel=1e-6)
    for a, b in zip(pa + oa, pb + ob):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


def test_eval_step_matches_jax():
    cfg, params, jcfg, jp = _both("h2o-danube-1.8b")
    batch = _batch(cfg, 3)
    got = make_eval_step(cfg)(params, batch)
    want = jax_make_eval_step(jcfg)(jp, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    assert got.grad_fn is None
    assert float(got) == pytest.approx(float(want), rel=1e-5)


EVAL_ARCHS = ("qwen2-0.5b", "seamless-m4t-medium")


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_eval_step_on_a_mesh_matches_single_rank(mesh):
    """``make_eval_step(cfg, ctx)``: on a model axis the vocabulary-parallel
    loss of the rank's blocks (the encoder's too), on the data axes the
    ranks' rows summed, give every rank the single rank's mean
    cross-entropy of the same draw and batch."""
    rng = np.random.default_rng(0)
    inputs = {}
    for arch in EVAL_ARCHS:
        cfg = smoke_config(arch)
        tok = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int64)
        labels = np.roll(tok, -1, 1)
        labels[0, :3] = -1  # ignored labels: the count is the batch's
        inputs[arch] = {"tokens": tok, "labels": labels}
        context = stub_context(cfg, 4, seed=1)
        if context is not None:
            inputs[arch]["context"] = context
    ranks = spawn_ranks(tp_eval, mesh[0] * mesh[1], mesh, EVAL_ARCHS,
                        inputs, timeout_s=300)
    for arch in EVAL_ARCHS:
        cfg = smoke_config(arch)
        params = open_gates(init_params(
            cfg, torch.Generator().manual_seed(0), device="cpu"))
        want = float(make_eval_step(cfg)(params, inputs[arch]))
        for r in ranks:
            assert r[arch] == pytest.approx(want, rel=1e-5), (arch, r)
        assert len({r[arch] for r in ranks}) == 1


def test_step_leaves_serving_params_without_grad():
    """The step differentiates detached copies: the caller's tensors keep
    requires_grad=False, so serving from them records no graph."""
    cfg, params, _, _ = _both("qwen2-0.5b")
    step = make_train_step(cfg, TrainConfig(remat=False))
    params, opt, _ = step(params, init_opt_state(params), _batch(cfg))
    assert not any(t.requires_grad for t in param_leaves(params))
    assert not any(t.requires_grad for t in param_leaves(opt))
    logits = make_prefill(cfg)(params, torch.zeros(1, 8, dtype=torch.long))
    assert logits.grad_fn is None


def test_batch_not_divisible_by_microbatches_raises():
    cfg, params, _, _ = _both("qwen2-0.5b")
    step = make_train_step(cfg, TrainConfig(microbatches=3, remat=False))
    with pytest.raises(ValueError, match="microbatches"):
        step(params, init_opt_state(params), _batch(cfg))


def test_training_learns_synthetic_pattern():
    """Port of tests/test_system.py:24-42: 40 steps on the bigram pattern
    take the loss from near uniform to below 0.8x uniform."""
    cfg = smoke_config("qwen2-0.5b")
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=5, total_steps=60,
                       remat=False)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    opt = init_opt_state(params)
    step = make_train_step(cfg, tcfg)
    first = last = None
    for i, batch in zip(range(40), make_batches(cfg, batch_size=8,
                                                seq_len=64)):
        params, opt, m = step(params, opt, batch)
        if i == 0:
            first = float(m["loss"])
        last = float(m["loss"])
    uniform = math.log(cfg.vocab_size)
    assert first == pytest.approx(uniform, rel=0.2)
    assert last < 0.8 * uniform, f"loss {first}->{last}, uniform {uniform}"


# the kernels' launches a call: K1-bwd 3, K6 3, K6-bwd 4, K5 1, K5-bwd 2
