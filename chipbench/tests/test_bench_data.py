"""The feed's rows are the frozen bigram generator's, and its copy is the
port's generator as it stands."""
import numpy as np
import torch

from cb.data import BigramFeed, SyntheticLM


def test_feed_equals_frozen_loop():
    feed = BigramFeed(997, 50, 3, seed=2 ** 31 + 17, device="cpu")
    for step in (0, 1, 5, 400):
        got = {k: v.numpy() for k, v in feed.batch(step).items()}
        want = feed.batch_np(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])
        assert np.array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])


def test_rows_of_a_run_differ():
    feed = BigramFeed(500, 8, 4, seed=3, device="cpu")
    starts = np.concatenate([feed.start_tokens(s) for s in range(125)])
    assert len(set(starts.tolist())) == 500


def test_frozen_copy_matches_the_port():
    from repro_torch.data.pipeline import SyntheticLM as Port
    lm = SyntheticLM(300, 20, seed=5)
    port = Port(300, 20, seed=5, pattern="bigram")
    for i in range(4):
        row = port.sequence(0, i)
        np.testing.assert_array_equal(lm.from_start(int(row[0])), row)


def test_feed_is_seeded():
    a = BigramFeed(400, 16, 2, seed=11, device="cpu").batch(3)["tokens"]
    b = BigramFeed(400, 16, 2, seed=11, device="cpu").batch(3)["tokens"]
    c = BigramFeed(400, 16, 2, seed=12, device="cpu").batch(3)["tokens"]
    assert torch.equal(a, b) and not torch.equal(a, c)
