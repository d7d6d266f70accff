"""The port's serving slice against the JAX package, at smoke size on the
CPU: ports of tests/test_pallas_integration.py, tests/test_decode.py,
test_system.py::test_serving_greedy_matches_forward_argmax and
tests/test_batcher.py.  Weights are the JAX package's, carried over by
``params_from_jax``; inputs are made with numpy from a seed."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.parallel.planner import ParallelCtx
from repro.serve.batcher import ContinuousBatcher as JaxBatcher
from repro.serve.step import make_serve_step as jax_make_serve_step
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.models import decode_step, forward, init_cache
from repro_torch.serve import make_prefill, make_serve_step
from repro_torch.serve.batcher import ContinuousBatcher

REPO = os.path.join(os.path.dirname(__file__), "..")
LOGIT_TOL = dict(atol=5e-4, rtol=1e-3)  # tests/test_pallas_integration.py


def _both(arch, seed, **overrides):
    """(port cfg, port params, JAX cfg, JAX params) sharing the weights."""
    cfg = dataclasses.replace(smoke_config(arch), **overrides)
    jcfg = dataclasses.replace(jax_smoke_config(arch), **overrides)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, params, jcfg, jp


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


@pytest.mark.parametrize("arch,overrides,batch", [
    ("granite-3-8b", dict(sliding_window=None, max_seq_len=256), 2),
    ("h2o-danube-1.8b", dict(sliding_window=128), 1),
])
def test_prefill_matches_jax_pallas(arch, overrides, batch):
    """Port of test_pallas_integration.py: granite full causal and danube
    SWA=128 at S 256, against the JAX forward through the interpret-mode
    Pallas kernel."""
    cfg, params, jcfg, jp = _both(arch, 0, **overrides)
    tok = _tokens(cfg, 0, (batch, 256))
    ref, _ = jax_forward(jcfg, jp, jnp.asarray(tok),
                         ctx=ParallelCtx(use_pallas=True))
    out = make_prefill(cfg)(params, torch.from_numpy(tok))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Port of test_decode.py::test_decode_matches_forward: step-by-step
    decode reproduces the forward logits, and the forward's logits and
    summed router loss (0 without MoE) match the JAX forward's."""
    b, s = 2, 16
    cfg, params, jcfg, jp = _both(arch, 0)
    tok = _tokens(cfg, 1, (b, s))
    full, aux = forward(cfg, params, torch.from_numpy(tok))
    ref, jaux = jax_forward(jcfg, jp, jnp.asarray(tok))
    np.testing.assert_allclose(full.numpy(), np.asarray(ref), **LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=0)
    cache = init_cache(cfg, params, b, s)
    for t in range(s):
        logits, cache = decode_step(cfg, params, cache,
                                    torch.from_numpy(tok[:, t:t + 1]), t)
        err = float((logits[:, 0] - full[:, t]).abs().max())
        assert err < 2e-4, f"{arch} step {t}: err={err}"


def test_sliding_window_ring_buffer():
    """Port of test_decode.py::test_sliding_window_ring_buffer: with window
    8 the ring buffer wraps three times over 24 steps."""
    b, s = 2, 24
    cfg, params, jcfg, jp = _both("h2o-danube-1.8b", 3, sliding_window=8)
    tok = _tokens(cfg, 3, (b, s))
    full, _ = forward(cfg, params, torch.from_numpy(tok))
    ref, _ = jax_forward(jcfg, jp, jnp.asarray(tok))
    np.testing.assert_allclose(full.numpy(), np.asarray(ref), **LOGIT_TOL)
    cache = init_cache(cfg, params, b, s)
    assert cache["layers"][0]["k"].shape[1] == 8  # ring slots == window
    for t in range(s):
        logits, cache = decode_step(cfg, params, cache,
                                    torch.from_numpy(tok[:, t:t + 1]), t)
        err = float((logits[:, 0] - full[:, t]).abs().max())
        assert err < 2e-4, f"wrap step {t}: err={err}"


def test_serving_greedy_matches_jax():
    """Port of test_system.py::test_serving_greedy_matches_forward_argmax:
    the port's greedy tokens equal the JAX serve step's, prompt and
    generation, and stay inside the true vocabulary."""
    cfg, params, jcfg, jp = _both("granite-3-8b", 1)
    prompt = _tokens(cfg, 1, (2, 8))
    jserve = jax.jit(jax_make_serve_step(jcfg))
    serve = make_serve_step(cfg)
    jcache = jax_init_cache(jcfg, jp, 2, 32)
    cache = init_cache(cfg, params, 2, 32)
    key = jax.random.PRNGKey(1)
    jtok, tok = jnp.asarray(prompt[:, :1]), torch.from_numpy(prompt[:, :1])
    for t in range(12):
        if t < 8:
            jtok = jnp.asarray(prompt[:, t:t + 1])
            tok = torch.from_numpy(prompt[:, t:t + 1])
        jtok, _, jcache = jserve(jp, jcache, jtok, t, key)
        tok, _, cache = serve(params, cache, tok, t)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        assert int(tok.max()) < cfg.vocab_size
    full, _ = forward(cfg, params, torch.from_numpy(prompt))
    assert full[:, -1].argmax(-1).tolist() == \
        np.asarray(jax_forward(jcfg, jp, jnp.asarray(prompt))[0][:, -1]
                   .argmax(-1)).tolist()


def test_sampling_is_seeded_and_in_vocab():
    cfg, params, _, _ = _both("qwen2-0.5b", 0)
    serve = make_serve_step(cfg, temperature=1.0)
    tok = torch.from_numpy(_tokens(cfg, 0, (4, 1)))
    draws = []
    for _ in range(2):
        cache = init_cache(cfg, params, 4, 8)
        gen = torch.Generator().manual_seed(5)
        out = [serve(params, cache, tok, t, gen)[0] for t in range(3)]
        draws.append(torch.cat(out, 1))
    assert torch.equal(draws[0], draws[1])
    assert int(draws[0].max()) < cfg.vocab_size


def _run(batcher_cls, cfg, params, reqs, max_slots, max_len=64):
    b = batcher_cls(cfg, params, max_slots=max_slots, max_len=max_len)
    for rid, (prompt, n) in enumerate(reqs):
        b.submit(prompt, n, rid=rid)
    return {r.rid: r for r in b.run()}


def _lifecycle(done):
    return {rid: (r.out, r.t_admit, r.t_first, r.t_finish)
            for rid, r in done.items()}


def test_staggered_requests_match_solo_and_jax():
    """Port of test_batcher.py::test_staggered_requests_match_solo
    [granite-3-8b]: 2 slots, 3 requests, the third admitted mid-flight
    into a recycled slot."""
    cfg, params, jcfg, jp = _both("granite-3-8b", 0)
    reqs = [([1, 2, 3, 4, 5], 6), ([7, 8, 9], 6), ([11, 12, 13, 14], 6)]
    done = _run(ContinuousBatcher, cfg, params, reqs, 2)
    assert set(done) == {0, 1, 2}
    assert done[2].t_admit > 0
    for i, req in enumerate(reqs):
        solo = _run(ContinuousBatcher, cfg, params, [req], 1)
        assert done[i].out == solo[0].out
    assert _lifecycle(done) == _lifecycle(_run(JaxBatcher, jcfg, jp, reqs, 2))


@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-1.5-large-398b"])
def test_staggered_ssm_requests_match_solo_and_jax(arch):
    """Port of test_batcher.py::test_staggered_requests_match_solo for the
    SSM and the hybrid (Mamba + attention + MoE): the third request lands
    in a recycled slot mid-flight; token lists and lifecycle equal solo
    runs and the JAX batcher's."""
    cfg, params, jcfg, jp = _both(arch, 0)
    reqs = [([1, 2, 3, 4, 5], 6), ([7, 8, 9], 6), ([11, 12, 13, 14], 6)]
    done = _run(ContinuousBatcher, cfg, params, reqs, 2)
    assert set(done) == {0, 1, 2}
    assert done[2].t_admit > 0
    for i, req in enumerate(reqs):
        solo = _run(ContinuousBatcher, cfg, params, [req], 1)
        assert done[i].out == solo[0].out
    assert _lifecycle(done) == _lifecycle(_run(JaxBatcher, jcfg, jp, reqs, 2))


def test_recycled_ssm_slot_is_zeroed(monkeypatch):
    """A recycled Mamba slot starts from zero conv history and SSM state:
    the second request's tokens equal a solo run's.  The reset is needed,
    not a safeguard: without it the previous request's state leaks."""
    cfg, params, _, _ = _both("mamba2-130m", 1)
    solo = _run(ContinuousBatcher, cfg, params, [([3, 1, 4], 5)], 1)
    reqs = [([9, 9, 9, 9, 9, 9], 4), ([3, 1, 4], 5)]  # pollute the slot
    done = _run(ContinuousBatcher, cfg, params, reqs, 1)
    assert done[1].out == solo[0].out

    b = ContinuousBatcher(cfg, params, max_slots=1, max_len=64)
    b.submit(*reqs[0], rid=0)
    b.run()
    assert any(float(t.abs().max()) > 0 for layer in b.cache["layers"]
               for t in layer.values())
    b.submit(*reqs[1], rid=1)
    b._admit()
    for layer in b.cache["layers"]:
        for t in layer.values():
            assert float(t.abs().max()) == 0.0

    logits = {}
    for reset in (True, False):
        if not reset:
            monkeypatch.setattr(ContinuousBatcher, "_reset_slot_state",
                                lambda self, slot: None)
        b = ContinuousBatcher(cfg, params, max_slots=1, max_len=64)
        for rid, req in enumerate(reqs):
            b.submit(*req, rid=rid)
        while b.active:
            b.step()
            if b.slot_req[0] is not None and b.slot_req[0].rid == 1:
                break
        logits[reset] = decode_step(cfg, params, b.cache,
                                    torch.tensor([[3]]), 0)[0]
    assert float((logits[True] - logits[False]).abs().max()) > 1e-3


def test_slot_recycling_isolated():
    """Port of test_batcher.py::test_slot_recycling_isolated."""
    cfg, params, jcfg, jp = _both("qwen2-0.5b", 1)
    solo = _run(ContinuousBatcher, cfg, params, [([3, 1, 4], 5)], 1)
    reqs = [([9, 9, 9, 9, 9, 9], 4), ([3, 1, 4], 5)]  # pollute the slot
    done = _run(ContinuousBatcher, cfg, params, reqs, 1)
    assert done[1].out == solo[0].out
    assert _lifecycle(done) == _lifecycle(_run(JaxBatcher, jcfg, jp, reqs, 1))


def test_request_lifecycle_step_indices():
    """Port of test_batcher.py::test_request_lifecycle_step_indices: the
    step indices equal the JAX batcher's."""
    cfg, params, jcfg, jp = _both("qwen2-0.5b", 0)
    reqs = [([1, 2, 3], 4), ([5, 6], 3)]  # rid 1 queues behind rid 0
    done = _run(ContinuousBatcher, cfg, params, reqs, 1)
    for r in done.values():
        assert r.t_admit <= r.t_first <= r.t_finish
        assert r.t_finish - r.t_first == len(r.out) - 1
    assert done[1].t_admit >= done[0].t_finish
    assert _lifecycle(done) == _lifecycle(_run(JaxBatcher, jcfg, jp, reqs, 1))


def test_long_prompt_rejected_up_front():
    """Port of test_batcher.py::test_long_prompt_rejected_up_front."""
    cfg, params, _, _ = _both("qwen2-0.5b", 0)
    b = ContinuousBatcher(cfg, params, max_slots=1, max_len=8)
    with pytest.raises(ValueError, match="prompt"):
        b.submit(list(range(1, 10)), 3, rid=0)
    b.submit(list(range(1, 8)), 3, rid=1)
    assert len(b.run()[0].out) >= 1


def test_port_imports_no_jax():
    """Every repro_torch module (the SSM, MoE, the codecs, the collectives,
    the trainer, optimizer and data pipeline, and every kernel included)
    and chip_smoke.py import without jax or the
    JAX package; run in a fresh interpreter because conftest imports
    jax."""
    script = """
import importlib, pkgutil, sys
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
for name in ("repro_torch.train.step", "repro_torch.train.loss",
             "repro_torch.optim.adamw", "repro_torch.optim.schedule",
             "repro_torch.data.pipeline"):
    assert name in names, name
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 46, proc.stdout
