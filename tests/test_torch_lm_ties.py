"""The greedy check of ``chip_smoke.py``'s parity phases at near-ties of
the LM head (``_logit_err``).

Where the reference's top two logits at a position lie within PARITY_TOL
of each other (``lm_head_ties``), a run held to PARITY_TOL may pick
either token, so the greedy token is not required to agree there; the
position is counted, and its logits stay held to PARITY_TOL.  Everywhere
else the greedy token must agree, even where every logit lies within
PARITY_TOL.

Here on synthetic logits over a vocabulary of 64 (the top logits near 6,
spaced 0.1 apart: no tie), with one position planted: a gap of 1.5
tolerances flipped by moves of 0.765 tolerances each (no tie: caught by
the greedy token alone), a gap of 0.5 tolerances flipped by 0.3 each (a
tie: counted, passes), and the same tie with a move of 3 tolerances
(caught by the excess).
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

V, POS = 64, (1, 3)   # the vocabulary; the planted (row, step)


def _tol(x: float) -> float:
    return cs.PARITY_TOL["atol"] + cs.PARITY_TOL["rtol"] * abs(x)


def _planted(gap_tols: float, move_tols: float):
    """(want, got): ``want`` random logits (2, 5, V) whose top two at POS
    lie ``gap_tols`` tolerances apart; ``got`` is ``want`` with those two
    moved ``move_tols`` tolerances towards (and past) each other, padded
    ids beyond V at -1e30 in both."""
    rng = np.random.default_rng(0)
    want = np.stack([[rng.permutation(V) * 0.1 for _ in range(5)]
                     for _ in range(2)]).astype(np.float32)
    row = want[POS]
    i1, i2 = np.argsort(row)[-1], np.argsort(row)[-2]
    tol = _tol(row[i1])
    row[i2] = row[i1] - gap_tols * tol
    got = want.copy()
    got[POS + (i1,)] -= move_tols * tol
    got[POS + (i2,)] += move_tols * tol
    pad = np.full((2, 5, 8), -1e30, np.float32)
    return (torch.from_numpy(np.concatenate([want, pad], -1)),
            torch.from_numpy(np.concatenate([got, pad], -1)))


def test_no_tie_but_the_planted_one():
    want, _ = _planted(0.5, 0.0)
    ties = cs.lm_head_ties(want, V)
    assert int(ties.sum()) == 1 and bool(ties[POS])
    want, _ = _planted(1.5, 0.0)
    assert int(cs.lm_head_ties(want, V).sum()) == 0


def test_a_wrong_token_away_from_a_tie_is_caught():
    """Every logit within PARITY_TOL, the top two 1.5 tolerances apart and
    swapped: not a tie, so the greedy token fails the check."""
    want, got = _planted(1.5, 0.765)
    err = cs._logit_err(got, want, V)
    assert err["excess"] <= 0
    assert not err["greedy_equal"], err
    assert err["lm_head_ties"] == 0 and err["flips_at_lm_head_ties"] == 0


def test_a_flip_at_a_tie_is_counted_and_passes():
    want, got = _planted(0.5, 0.3)
    assert bool((got[POS].argmax() != want[POS].argmax()))
    err = cs._logit_err(got, want, V)
    assert err["excess"] <= 0 and err["greedy_equal"], err
    assert err["lm_head_ties"] == 1 and err["flips_at_lm_head_ties"] == 1
    assert cs.lm_tie_counts([err, err]) == {"lm_head_ties": 2,
                                            "flips_at_lm_head_ties": 2}


@pytest.mark.parametrize("router_ties", [False, True])
def test_an_excess_at_a_tie_still_fails(router_ties):
    """A move of 3 tolerances at the tie: the token is excused, the excess
    is not (a router tie elsewhere changes nothing)."""
    want, got = _planted(0.5, 3.0)
    ties = torch.zeros(want.shape[:2], dtype=torch.bool)
    ties[0, 0] = True
    err = cs._logit_err(got, want, V, ties if router_ties else None)
    assert err["greedy_equal"]
    assert err["excess"] > 0, err
