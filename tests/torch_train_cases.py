"""Shared parts of the port's training tests against the JAX package
(``tests/test_torch_train*.py``, split so that a run's workers spread
them): the imports, the weights and batches both sides share, the tree
comparison, and the one-step parity check of ``STEP_CASES``."""
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


def step_cases(archs):
    """The ``STEP_CASES`` of ``archs``, with the ids the cases have as one
    list (``<arch>-overrides<index>-<remat>``)."""
    return [pytest.param(arch, overrides, remat,
                         id=f"{arch}-overrides{i}-{remat}")
            for i, (arch, overrides, remat) in enumerate(STEP_CASES)
            if arch in archs]


def check_train_step(arch, overrides, remat):
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

