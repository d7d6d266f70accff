"""The port's continuous batcher against the JAX package's, at smoke size
on the CPU: ports of tests/test_batcher.py for every family (staggered
requests against solo runs and the JAX batcher's lifecycle, recycled
slots, the context families' contexts and caches, the zeroed-context
fault).  Weights are the JAX package's, carried over by
``params_from_jax``; inputs are made with numpy from a seed.  Shared parts
are ``test_torch_serve.py``'s."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.serve.batcher import ContinuousBatcher as JaxBatcher
from repro_torch.bridge import params_from_jax
from repro_torch.configs import smoke_config
from repro_torch.models import decode_step, forward
from repro_torch.serve.batcher import ContinuousBatcher
from test_torch_serve import (CONTEXT_ARCHS, LOGIT_TOL, _both, _contexts,
                              _tokens)
from torch_context import open_gates


def _run(batcher_cls, cfg, params, reqs, max_slots, max_len=64,
         context=None):
    b = batcher_cls(cfg, params, max_slots=max_slots, max_len=max_len,
                    context=context)
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


@pytest.mark.parametrize("arch", CONTEXT_ARCHS)
def test_staggered_context_requests_match_solo_and_jax(arch):
    """test_batcher.py::test_staggered_requests_match_solo for MLA (its
    latent cache invalidates itself from the position), cross-attention
    and the encoder-decoder (one shared context of max_slots equal rows,
    its K/V kept across slot reuse), gates open: the third request lands
    in a recycled slot mid-flight; token lists and lifecycle equal solo
    runs and the JAX batcher's."""
    cfg, params, jcfg, jp = _both(arch, 0)
    context, jcontext = _contexts(cfg, jcfg, params, jp, 2, same_rows=True)
    reqs = [([1, 2, 3, 4, 5], 6), ([7, 8, 9], 6), ([11, 12, 13, 14], 6)]
    done = _run(ContinuousBatcher, cfg, params, reqs, 2, context=context)
    assert set(done) == {0, 1, 2}
    assert done[2].t_admit > 0
    for i, req in enumerate(reqs):
        solo = _run(ContinuousBatcher, cfg, params, [req], 1,
                    context=None if context is None else context[:1])
        assert done[i].out == solo[0].out
    assert _lifecycle(done) == _lifecycle(
        _run(JaxBatcher, jcfg, jp, reqs, 2, context=jcontext))


def test_reset_slot_keeps_cross_kv():
    """Port of test_batcher.py::test_reset_slot_skips_aliased_axes: a
    recycled slot is zeroed in every self-attention cache, while the cross
    K/V, whose batch is the context's (here 1, equal to max_slots), stay
    whole."""
    cfg, params, _, _ = _both("llama-3.2-vision-90b", 0)
    context = torch.ones((1, 6, cfg.d_model))
    b = ContinuousBatcher(cfg, params, max_slots=1, max_len=16,
                          context=context)
    for layer in b.cache["layers"]:
        for t in layer.values():
            t.fill_(1.0)
    b._reset_slot_state(0)
    kinds = [s.mixer for s in cfg.layer_specs()]
    assert "cross_attn" in kinds
    for kind, layer in zip(kinds, b.cache["layers"]):
        for t in layer.values():
            assert float(t[0].abs().max()) == (
                1.0 if kind == "cross_attn" else 0.0)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b",
                                  "seamless-m4t-medium"])
def test_context_recycled_slot_matches_solo(arch):
    """Port of test_batcher.py::test_cross_attn_arch_recycles_slots_
    consistently, gates open: a request admitted into a recycled slot
    reproduces its solo output (the cross K/V survive the earlier
    tenants' admits)."""
    cfg, params, jcfg, jp = _both(arch, 2)
    context, _ = _contexts(cfg, jcfg, params, jp, 1)
    solo = _run(ContinuousBatcher, cfg, params, [([3, 1, 4], 5)], 1,
                max_len=32, context=context)
    done = _run(ContinuousBatcher, cfg, params,
                [([9, 9, 9, 9], 4), ([3, 1, 4], 5)], 1, max_len=32,
                context=context)
    assert done[1].out == solo[0].out


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b",
                                  "seamless-m4t-medium"])
def test_zeroed_context_is_caught_only_with_open_gates(arch):
    """Why every parity test opens the gates: a planted fault (the
    context zeroed on the port's side) takes the logits beyond LOGIT_TOL
    of JAX's with the gates open, and passes unseen with the gates at
    their init value 0."""
    tok = _tokens(smoke_config(arch), 4, (2, 16))
    for opened in (True, False):
        cfg = smoke_config(arch)
        jcfg = jax_smoke_config(arch)
        jp = jax.tree.map(np.asarray,
                          jax_init_params(jcfg, jax.random.PRNGKey(3)))
        if opened:
            jp = open_gates(jp)
        params = params_from_jax(cfg, jp, device="cpu")
        jp = jax.tree.map(jnp.asarray, jp)
        context, jcontext = _contexts(cfg, jcfg, params, jp, 2)
        ref, _ = jax_forward(jcfg, jp, jnp.asarray(tok), context=jcontext)
        ok, _ = forward(cfg, params, torch.from_numpy(tok), context=context)
        bad, _ = forward(cfg, params, torch.from_numpy(tok),
                         context=torch.zeros_like(context))
        np.testing.assert_allclose(ok.numpy(), np.asarray(ref), **LOGIT_TOL)
        close = np.allclose(bad.numpy(), np.asarray(ref), **LOGIT_TOL)
        assert close != opened, opened


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
