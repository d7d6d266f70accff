"""The check of ``chip_smoke.py``'s model-axis phases at router near-ties.

A token whose k-th and (k+1)-th router logits lie within ``ROUTER_TIE``
may take the (k+1)-th expert under the rounding of the model axis's sums.
The check re-runs the single-card reference with the experts the
model-axis run took at such ties (``_forced_routes``, weights the softmax
of the reference's own logits over them) and holds every position, ties
included, at ``PARITY_TOL`` and the greedy token (``_tie_parity``).

Here, on the CPU at deepseek-v2's smoke size (a dense layer, then a MoE
layer of 4 experts, top 2): a run that flips one tie to its (k+1)-th
expert, as the model axis may, passes the check; a run whose dispatch
sends that token to a wrong expert while its router picked the flipped
ones is caught, though holding the tie out of the comparison (the check
before) lets it pass.
"""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402

ARCH = "deepseek-v2-236b"


def _flipping(real, pos, rank_of_last):
    """``route`` whose token ``pos`` takes, for its k-th expert, the one
    of rank ``rank_of_last`` (0-based) of its router logits, weighted as
    ``route`` weights its own picks."""
    def route(p, cfg_, x, ctx=None):
        ids, weights, aux = real(p, cfg_, x, ctx)
        logits = x.float() @ p["router"]
        order = logits.argsort(dim=-1, descending=True)
        ids = ids.clone()
        ids[pos + (cfg_.top_k - 1,)] = order[pos + (rank_of_last,)]
        w = torch.softmax(logits, dim=-1).gather(-1, ids)
        w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
        return ids, w.to(x.dtype), aux
    return route


@pytest.fixture(scope="module")
def runs():
    """The reference prefill, its router gaps, one tie planted by setting
    ``ROUTER_TIE`` between the two smallest gaps, and three runs of the
    same prefill: one flipping the tie (the model axis's legitimate
    answer, its picks recorded), one dispatching that token to a wrong
    expert (a fault), and the reference forced to the flipped picks."""
    mp = pytest.MonkeyPatch()
    mp.setattr(cs, "DEVICE", "cpu")
    cfg = smoke_config(ARCH)
    params = cs._tpf_params(cfg, 3, torch.float32, None, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 48)))

    def prefill():
        return cs.make_prefill(cfg)(params, tokens, None)

    real = moe_mod.route
    with torch.no_grad():
        ref, gaps, _ = cs._router_gaps(prefill)
        (gap,) = gaps  # one MoE layer
        flat = gap.flatten().sort().values
        mp.setattr(cs, "ROUTER_TIE", float(flat[0] + flat[1]) / 2)
        pos = tuple(int(i) for i in np.unravel_index(
            int(gap.argmin()), tuple(gap.shape)))
        k = cfg.top_k
        try:
            moe_mod.route = _flipping(real, pos, k)
            sound, _, picks = cs._router_gaps(prefill)
            moe_mod.route = _flipping(real, pos, k + 1)
            fault = prefill()
        finally:
            moe_mod.route = real
        forced, changed = cs._forced_routes(prefill, picks)
    yield dict(cfg=cfg, ref=ref, gap=gap, pos=pos, sound=sound,
               fault=fault, forced=forced, changed=changed)
    mp.undo()


def test_one_tie_is_planted(runs):
    assert int(cs._ties(runs["gap"]).sum()) == 1
    assert runs["changed"] == 1
    assert moe_mod.route.__name__ == "route"  # every patch undone


def test_a_flip_at_the_tie_passes(runs):
    got = cs._tie_parity(runs["sound"], runs["forced"], runs["gap"],
                         runs["cfg"].vocab_size, runs["changed"])
    assert got["excess"] <= 0 and got["greedy_equal"], got
    assert got["router_ties"] == 1 and got["forced_positions"] == 1


def test_a_wrong_expert_at_the_tie_is_caught(runs):
    v = runs["cfg"].vocab_size
    got = cs._tie_parity(runs["fault"], runs["forced"], runs["gap"], v,
                         runs["changed"])
    assert got["excess"] > 0 or not got["greedy_equal"], got
    # the fault shows at the tie only: holding the tie out passes it
    held_out = cs._logit_err(runs["fault"], runs["ref"], v,
                             cs._ties(runs["gap"]))
    assert held_out["excess"] <= 0 and held_out["greedy_equal"]
    err = (runs["fault"] - runs["forced"]).abs().amax(-1)
    assert err.flatten().argmax() == np.ravel_multi_index(
        runs["pos"], tuple(runs["gap"].shape))


def test_forcing_needs_every_call_picked(runs):
    cfg = runs["cfg"]
    params = cs._tpf_params(cfg, 3, torch.float32, None, "cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with torch.no_grad(), pytest.raises(StopIteration):
        cs._forced_routes(lambda: cs.make_prefill(cfg)(params, tokens,
                                                       None), [])
    assert moe_mod.route.__name__ == "route"
