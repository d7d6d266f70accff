"""Mamba decode on a model axis that keeps the SSM heads whole and splits
the ``conv_x`` cache's channels (``TPLayout.conv_x``: the JAX package's
``cache_specs`` splits them wherever they divide the axis, while
``_mamba_head_axis`` keeps heads that do not divide it whole), against the
JAX package's single-device ``decode_step`` and the port's single rank, at
smoke size on the CPU.

The config is mamba2-130m's smoke config with SSM heads of 256: 2 heads
over 512 channels, so a (1, 4) mesh keeps the heads whole and gives each
rank 128 ``conv_x`` channels, as tp 16 does for the full config's 24 heads
over 1,536 channels.  One ``spawn_ranks`` of 4 gloo ranks
(``torch_mamba_ranks.mamba_cases``) runs 12 teacher-forced decode steps
from the JAX package's parameters (``init_params``, key 0) and tokens from
numpy (seed 0), sound and with each planted fault.

Tolerances: the logits ``tests/test_pallas_integration.py``'s (atol 5e-4,
rtol 1e-3, f32) against JAX; bit-equal to the port's single rank, and each
rank's ``conv_x`` bit-equal to its block of the single rank's cache (the
gather moves bits, and each channel's arithmetic is the single rank's).
The two planted faults (the gather skipped, a rank convolving another
rank's weight block) move the logits beyond five times the tolerance.
"""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.core.types import MeshConfig as JaxMeshConfig
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.parallel import planner as jax_planner
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.parallel.planner import ParallelCtx, tp_layout
from torch_dp_ranks import flatten, nest
from torch_mamba_ranks import (ARCH, HEAD_DIM, mamba_cases, mamba_config,
                               mamba_decode_run)

LOGIT_TOL = dict(atol=5e-4, rtol=1e-3)    # tests/test_pallas_integration.py
TP, ROWS, STEPS = 4, 4, 12
FAULTS = ("no_gather", "wrong_block")
FAULT_MARGIN = 5


def jax_config():
    return dataclasses.replace(jax_smoke_config(ARCH), ssm_head_dim=HEAD_DIM)


def _jax_decode(params, tokens) -> np.ndarray:
    """The JAX package's jitted ``decode_step`` on one device, ``tokens``
    teacher-forced from position 0: logits (B, steps, V_pad)."""
    cfg = jax_config()
    cache = jax_init_cache(cfg, params, tokens.shape[0], tokens.shape[1])
    step = jax.jit(lambda p, c, t, q: jax_decode_step(cfg, p, c, t, q))
    out = []
    for t in range(tokens.shape[1]):
        lg, cache = step(params, cache, jnp.asarray(tokens[:, t:t + 1]),
                         jnp.int32(t))
        out.append(np.asarray(lg[:, 0]))
    return np.stack(out, 1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results, JAX's logits, the port's single-rank run)."""
    cfg = mamba_config()
    tmp = tmp_path_factory.mktemp("tp_mamba_cache")
    jp = jax.tree.map(np.asarray,
                      jax_init_params(jax_config(), jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (ROWS, STEPS)).astype(np.int32)
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, tokens=tokens, **{f"params|{ARCH}|{k}": v
                                       for k, v in flatten(jp).items()})
    ranks = spawn_ranks(mamba_cases, TP, inputs, FAULTS, timeout_s=300)
    want = _jax_decode(jp, tokens)
    params = params_from_jax(cfg, nest(flatten(jp)), "cpu")
    single = mamba_decode_run(cfg, params, torch.from_numpy(tokens).long())
    return ranks, want, single


# the model axes of each config where the flag holds
CONV_SPLIT_TP = {"mamba2-130m": {16, 32}, "jamba-1.5-large-398b": set(),
                 "smoke": {4, 8, 16, 32}}


@pytest.mark.parametrize("tp", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("arch", sorted(CONV_SPLIT_TP))
def test_conv_x_flag_is_the_reference_rule(arch, tp):
    """``TPLayout.conv_x`` holds exactly where the JAX package's
    ``cache_specs`` puts the model axis on ``conv_x``'s channels and
    ``_mamba_head_axis`` keeps the heads whole: of the configs, mamba2's
    24 heads at tp 16 and 32 (jamba's 128 divide every axis here)."""
    if arch == "smoke":
        cfg, jcfg = mamba_config(), jax_config()
    else:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
    mcfg = JaxMeshConfig((1, tp))
    shape = jax.ShapeDtypeStruct((1, ROWS, cfg.ssm_conv_kernel - 1,
                                  cfg.ssm_d_inner), jnp.float32)
    spec = jax_planner.cache_specs(jcfg, mcfg, ROWS, {"conv_x": shape})
    split = spec["conv_x"][-1] == "model"
    whole_heads = jax_planner._mamba_head_axis(jcfg, mcfg) is None
    got = tp_layout(cfg, ParallelCtx(tp=tp)).conv_x
    assert got == (split and whole_heads)
    assert got == (tp in CONV_SPLIT_TP[arch])


def test_decode_matches_jax(runs):
    ranks, want, _ = runs
    for r in ranks:
        np.testing.assert_allclose(r["sound"]["logits"], want, **LOGIT_TOL)


def test_decode_bit_equal_to_single_rank(runs):
    ranks, _, single = runs
    for r in ranks:
        np.testing.assert_array_equal(r["sound"]["logits"],
                                      single["logits"])


def test_conv_x_is_the_rank_block(runs):
    """Each rank's ``conv_x`` holds its 128 channels, bit-equal to that
    block of the single rank's cache; ``conv_b``, ``conv_c`` and the
    state stay whole, as the spec says."""
    ranks, _, single = runs
    cfg = mamba_config()
    n = cfg.ssm_d_inner // TP
    for m, r in enumerate(ranks):
        for got, whole in zip(r["sound"]["cache"], single["cache"]):
            assert got["conv_x"].shape == (ROWS, cfg.ssm_conv_kernel - 1, n)
            np.testing.assert_array_equal(
                got["conv_x"], whole["conv_x"][..., m * n:(m + 1) * n])
            for leaf in ("conv_b", "conv_c", "ssm"):
                np.testing.assert_array_equal(got[leaf], whole[leaf])


def test_wire_bytes_equal_the_formula(runs):
    """A step's wire bytes: the embedding's all-reduce
    (``tp_forward_bytes``) and each layer's ``conv_x`` all-gather
    (``conv_gather_bytes``, (tp - 1) blocks of (rows, 128) f32)."""
    ranks, _, _ = runs
    cfg = mamba_config()
    gather = chip_smoke.conv_gather_bytes(cfg, TP, ROWS)
    assert gather == cfg.num_layers * (TP - 1) * ROWS * 128 * 4
    want = chip_smoke.tp_forward_bytes(cfg, TP, ROWS, 1, 4,
                                       gather=False) + gather
    for r in ranks:
        assert r["sound"]["bytes"] == [want] * STEPS


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_is_caught(runs, fault):
    ranks, _, single = runs
    want = single["logits"]
    err = float(np.abs(ranks[0][fault]["logits"] - want).max())
    bound = LOGIT_TOL["atol"] + LOGIT_TOL["rtol"] * float(np.abs(want).max())
    assert err > FAULT_MARGIN * bound, (fault, err, bound)
