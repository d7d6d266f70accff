"""The port's training slice against the JAX package, at smoke size on the
CPU: data, loss, schedule, AdamW, the chunked attention path and the whole
step (ports of tests/test_train_features.py and
test_system.py::test_training_learns_synthetic_pattern).  Weights and
optimizer state are the JAX package's, carried over by the bridge; inputs
are made with numpy from a seed.  The JAX side runs as its own tests run
it: jitted, on the CPU, through the plain attention path."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import smoke_config as jax_smoke_config
from repro.core.types import TrainConfig as JaxTrainConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.data.pipeline import make_batches as jax_make_batches
from repro.models import init_params as jax_init_params
from repro.models.attention import _flash_attention_jnp
from repro.models.attention import multihead_attention as jax_mha
from repro.optim.adamw import adamw_update as jax_adamw_update
from repro.optim.adamw import global_norm as jax_global_norm
from repro.optim.adamw import init_opt_state as jax_init_opt_state
from repro.optim.schedule import lr_schedule as jax_lr_schedule
from repro.parallel.planner import ParallelCtx
from repro.train.loss import cross_entropy as jax_cross_entropy
from repro.train.step import make_eval_step as jax_make_eval_step
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.bridge import (opt_state_from_jax, params_from_jax,
                                params_to_jax_layout)
from repro_torch.configs import smoke_config
from repro_torch.core.types import TrainConfig
from repro_torch.data import SyntheticLM, make_batches
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention.ops import LAUNCHES_PER_CALL
from repro_torch.kernels.moe_gmm.ops import \
    BWD_LAUNCHES_PER_CALL as GMM_BWD_LAUNCHES
from repro_torch.kernels.ssd_scan.ops import \
    BWD_LAUNCHES_PER_CALL as SSD_BWD_LAUNCHES
from repro_torch.kernels.ssd_scan.ops import \
    LAUNCHES_PER_CALL as SSD_LAUNCHES
from repro_torch.models import (forward, init_params, param_leaves,
                                train_launches, tree_map)
from repro_torch.models.attention import (_flash_attention_chunked,
                                          multihead_attention)
from repro_torch.optim import (adamw_update, global_norm, init_opt_state,
                               lr_schedule)
from repro_torch.serve import make_prefill
from repro_torch.train import cross_entropy, make_eval_step, make_train_step
from torch_context import open_gates, stub_context

# tests/test_train_features.py:28-41 (f32) and :44-56 (bf16 grads)
TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def _both(arch, seed=0):
    """(port cfg, port params, JAX cfg, JAX params) sharing the weights,
    the cross-attention gates opened (``torch_context``)."""
    cfg, jcfg = smoke_config(arch), jax_smoke_config(arch)
    jp = open_gates(jax.tree.map(
        np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(seed))))
    params = params_from_jax(cfg, jp, device="cpu")
    return cfg, params, jcfg, jax.tree.map(jnp.asarray, jp)


def _batch(cfg, seed=0, shape=(4, 32)):
    """tests/test_train_features.py::_setup's batch, drawn with numpy, and
    the stub context of the configs that take one (as the JAX launcher
    and tests/test_arch_smoke.py::_batch add it)."""
    tok = np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)
    tok = tok.astype(np.int32)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, 1)}
    context = stub_context(cfg, shape[0], seed)
    if context is not None:
        batch["context"] = context
    return batch


def _leaves(tree):
    return jax.tree_util.tree_leaves(jax.tree.map(np.asarray, tree))


def _assert_trees_close(cfg, port_tree, jax_tree, **tol):
    got = jax.tree_util.tree_leaves(params_to_jax_layout(cfg, port_tree))
    want = _leaves(jax_tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), **tol)


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


# --- the step --------------------------------------------------------------

# tests/test_train_features.py's cases (microbatches 1, 2, 4; bf16 grads;
# granite with and without remat) and the SSM, MoE, hybrid, MLA (with MoE),
# cross-attention and encoder-decoder families (the last also in two
# microbatches under remat: the context split by rows, the encoder
# checkpointed)
STEP_CASES = [
    ("qwen2-0.5b", dict(microbatches=1), False),
    ("qwen2-0.5b", dict(microbatches=2), False),
    ("qwen2-0.5b", dict(microbatches=4), False),
    ("qwen2-0.5b", dict(grad_dtype="bf16"), False),
    ("granite-3-8b", {}, False),
    ("granite-3-8b", {}, True),
    ("mamba2-130m", {}, False),
    ("dbrx-132b", {}, False),
    ("jamba-1.5-large-398b", {}, False),
    ("deepseek-v2-236b", {}, False),
    ("llama-3.2-vision-90b", {}, False),
    ("seamless-m4t-medium", {}, False),
    ("seamless-m4t-medium", dict(microbatches=2), True),
]


@pytest.mark.parametrize("arch,overrides,remat", STEP_CASES)
def test_train_step_matches_jax(arch, overrides, remat):
    """One step from shared params, state and batch: loss, ce, aux, lr,
    grad_norm, and the updated params, m and v leaf for leaf
    (``params_to_jax_layout``), at the JAX tests' 1e-5 (2e-2 for the bf16
    gradient cast, whose rounding moves m and v by up to a bf16 ulp).
    mamba2 and jamba hold grad_norm to 5e-5: the port's plain SSD scan
    sums each segment on its own, the JAX package's takes differences of
    one cumsum, which loses up to 2.9e-5 of the scan's scale (ROADMAP,
    Queue 3)."""
    cfg, params, jcfg, jp = _both(arch)
    batch = _batch(cfg)
    tcfg = TrainConfig(remat=remat, **overrides)
    jstep = jax.jit(jax_make_train_step(
        jcfg, JaxTrainConfig(remat=False, **overrides),
        ParallelCtx(remat=True) if remat else None))
    jp2, jo2, jm = jstep(jp, jax_init_opt_state(jp),
                         {k: jnp.asarray(v) for k, v in batch.items()})
    opt = opt_state_from_jax(cfg, jax.tree.map(np.asarray,
                                               jax_init_opt_state(jp)),
                             device="cpu")
    params, opt, m = make_train_step(cfg, tcfg)(params, opt, batch)
    assert set(m) == set(jm) == {"ce", "aux", "loss", "lr", "grad_norm"}
    ssm = any(s.mixer == "mamba" for s in cfg.layer_specs())
    for k in ("loss", "ce", "aux", "lr", "grad_norm"):
        rel = 5e-5 if ssm and k == "grad_norm" else 1e-5
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=rel,
                                            abs=1e-7), k
    assert int(opt["step"]) == 1
    bf16 = overrides.get("grad_dtype") == "bf16"
    _assert_trees_close(cfg, params, jp2, **TOL)
    for name in ("m", "v"):
        _assert_trees_close(cfg, opt[name], jo2[name],
                            **(BF16_TOL if bf16 else TOL))


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
K1B, K6, K6B, K5B = LAUNCHES_PER_CALL, SSD_LAUNCHES, SSD_BWD_LAUNCHES, \
    GMM_BWD_LAUNCHES


@pytest.mark.parametrize("arch,microbatches,remat,want", [
    # 24 attention layers x 2 microbatches, forward twice under remat
    ("qwen2-0.5b", 2, True, {"flash_attention": 24 * 2 * 2,
                             "flash_attention_bwd": 24 * 2 * K1B}),
    ("qwen2-0.5b", 1, False, {"flash_attention": 24,
                              "flash_attention_bwd": 24 * K1B}),
    # smoke: one attention + dense layer, one Mamba + MoE layer
    ("jamba-1.5-large-398b", 3, False, {
        "flash_attention": 3, "flash_attention_bwd": 3 * K1B,
        "ssd_scan": 3 * K6, "ssd_scan_bwd": 3 * K6B,
        "moe_gmm": 3 * 3, "moe_gmm_bwd": 3 * 3 * K5B}),
    # smoke: two Mamba layers
    ("mamba2-130m", 4, True, {"ssd_scan": 2 * 4 * 2 * K6,
                              "ssd_scan_bwd": 2 * 4 * K6B}),
    # smoke: two attention + MoE layers
    ("dbrx-132b", 2, True, {
        "flash_attention": 2 * 2 * 2, "flash_attention_bwd": 2 * 2 * K1B,
        "moe_gmm": 3 * 2 * 2 * 2, "moe_gmm_bwd": 3 * 2 * 2 * K5B})])
def test_train_launches(arch, microbatches, remat, want):
    """Each forward kernel once a layer and microbatch (twice under remat,
    whose checkpointed layer runs again in the backward), each backward
    kernel once: K1 and its backward per attention layer, K6 and its
    backward per Mamba layer, K5 and its backward per expert product
    (three a MoE layer); kernels that do not launch are left out.
    qwen2-0.5b at full depth, the others at smoke size."""
    cfg = get_config(arch) if arch == "qwen2-0.5b" else smoke_config(arch)
    assert train_launches(cfg, microbatches, remat) == want


@pytest.mark.parametrize("arch,seq,want,moe", [
    ("deepseek-v2-236b", None, 0, 59),  # MLA: q and v head dims differ
    ("llama-3.2-vision-90b", 512, 80, 0),  # self layers; cross T 1601
    ("llama-3.2-vision-90b", 1601, 100, 0),  # cross layers at S == T too
    ("seamless-m4t-medium", 512, 24, 0),  # encoder + decoder self
    ("seamless-m4t-medium", 1024, 36, 0)])  # + the cross blocks at S == T
def test_train_launches_with_context(arch, seq, want, moe):
    """K1 launches a step of the context families at full size, one
    microbatch: MLA none, a cross-attention layer or cross block one
    only where the sequence is as long as the context, the encoder's
    layers one each (the loss encodes); deepseek-v2's 59 MoE layers K5
    three times and its backward's two launches three times each."""
    got = train_launches(get_config(arch), 1, False, seq)
    want = {"flash_attention": want,
            "flash_attention_bwd": want * LAUNCHES_PER_CALL,
            "moe_gmm": 3 * moe, "moe_gmm_bwd": 3 * moe * K5B}
    assert got == {k: n for k, n in want.items() if n}


# --- the chunked CPU attention path -----------------------------------------

def _mha_inputs(seed, b, sq, sk, kv, g, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, kv, g, hd), dtype=np.float32),
            rng.standard_normal((b, sk, kv, hd), dtype=np.float32),
            rng.standard_normal((b, sk, kv, hd), dtype=np.float32))


@pytest.mark.parametrize("shape,causal,window,chunks", [
    ((2, 96, 96, 2, 3, 16), True, None, (32, 32)),
    ((1, 100, 100, 2, 2, 8), True, 24, (32, 16)),      # ragged tails
    ((1, 70, 130, 1, 4, 8), False, 40, (16, 48)),      # Sq != Sk
    ((1, 90, 50, 2, 1, 16), True, 16, (32, 32)),       # rows with no key
    ((2, 64, 64, 1, 2, 32), False, None, (64, 64)),
])
def test_chunked_attention_matches_jax(shape, causal, window, chunks):
    """``_flash_attention_chunked`` against the JAX package's
    ``_flash_attention_jnp`` with the same small chunks, its output and its
    gradients (torch autograd against jax.grad of sum(out * w))."""
    b, sq, sk, kv, g, hd = shape
    q, k, v = _mha_inputs(sum(shape), b, sq, sk, kv, g, hd)
    w = np.random.default_rng(1).standard_normal(
        (b, sq, kv, g, hd)).astype(np.float32)
    qc, kc = chunks
    pos_q, pos_k = np.arange(sq), np.arange(sk)

    def jax_loss(q, k, v):
        out = _flash_attention_jnp(q, k, v, q_pos=jnp.asarray(pos_q),
                                   k_pos=jnp.asarray(pos_k), causal=causal,
                                   window=window, q_chunk=qc, kv_chunk=kc)
        return jnp.sum(out * w), out

    (_, jout), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = _flash_attention_chunked(tq, tk, tv, q_pos=torch.from_numpy(pos_q),
                                   k_pos=torch.from_numpy(pos_k),
                                   causal=causal, window=window, q_chunk=qc,
                                   kv_chunk=kc)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=2e-5, rtol=2e-5)
    for t, jg in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                                   atol=2e-5, rtol=2e-5)


def test_multihead_attention_goes_chunked_above_plain_limit():
    """Above 2048^2 scores the CPU path is the chunked one (default chunks
    of 1024), as the JAX package's dispatch: Sq = Sk = 2100 with a
    window, against JAX's ``multihead_attention``."""
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((1, 2100, n, 8), dtype=np.float32)
               for n in (2, 1, 1))
    pos = np.arange(2100)
    port = multihead_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               q_pos=torch.from_numpy(pos),
                               k_pos=torch.from_numpy(pos), causal=True,
                               window=300)
    ref = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  q_pos=jnp.asarray(pos), k_pos=jnp.asarray(pos),
                  causal=True, window=300)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


def test_forward_remat_matches_plain_forward_gradients():
    """forward(remat=True) under autograd gives the gradients of the plain
    forward (a hybrid config: attention, Mamba and MoE layers)."""
    cfg = smoke_config("jamba-1.5-large-398b")
    params = init_params(cfg, torch.Generator().manual_seed(1),
                         device="cpu")
    tok = torch.from_numpy(_batch(cfg, 2, (2, 16))["tokens"]).long()
    grads = []
    for remat in (False, True):
        leaves = [t.detach().requires_grad_(True)
                  for t in param_leaves(params)]
        it = iter(leaves)
        p = tree_map(lambda _: next(it), params)
        logits, aux = forward(cfg, p, tok, remat=remat)
        (logits.float().square().mean() + aux).backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)
