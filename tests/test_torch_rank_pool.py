"""``RankPool``: one set of processes for a sequence of multi-rank runs.

Each run is a process group of its own over the first ``world_size``
processes, and each starts from the state of a fresh process (the launch
and exchange counters at 0, the matmul precision at its start value),
whatever the run before it left.  A failed rank raises in the caller with
its traceback and closes the pool.  Gloo on the CPU.
"""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import os

import pytest

from repro_torch.launch.ranks import RankPool, spawn_ranks

from torch_pool_ranks import fail_on, state


@pytest.fixture(scope="module")
def runs():
    """Three runs on one pool of 4: world 4, then 2, then 4 again."""
    with RankPool(4) as pool:
        out = [pool.run(state, 4, 0), pool.run(state, 2, 10),
               pool.run(state, 4, 20)]
    return out


def test_runs_share_the_processes(runs):
    first, second, third = ([r["pid"] for r in run] for run in runs)
    assert len(set(first)) == 4
    assert second == first[:2] and third == first
    assert os.getpid() not in first


@pytest.mark.parametrize("i,world,tag", [(0, 4, 0), (1, 2, 10), (2, 4, 20)])
def test_each_run_is_a_group_of_its_own(runs, i, world, tag):
    got = runs[i]
    assert [r["rank"] for r in got] == list(range(world))
    assert all(r["world"] == world for r in got)
    want = float(sum(range(world)) + world * tag)
    assert all(r["sum"] == [want] * 4 for r in got)


@pytest.mark.parametrize("i", [1, 2])
def test_each_run_starts_fresh(runs, i):
    fresh = runs[0][0]
    for r in runs[i]:
        assert r["launches"] == 0
        assert r["seconds"] == 0.0
        assert r["precision"] == fresh["precision"]
    # the wire counters start at 0: each rank's bytes equal the first run's
    # on a group of the same size
    if len(runs[i]) == 4:
        assert [r["sent"] for r in runs[i]] == [r["sent"] for r in runs[0]]
        assert [r["staged"] for r in runs[i]] == \
            [r["staged"] for r in runs[0]]


def test_a_failed_rank_raises_and_closes_the_pool():
    pool = RankPool(3)
    try:
        # the first failure to arrive: rank 1's own, or a peer's lost
        # connection to it
        with pytest.raises(RuntimeError, match=r"rank \d of 3 failed"):
            pool.run(fail_on, 3, 1, timeout_s=60)
        with pytest.raises(RuntimeError, match="closed"):
            pool.run(fail_on, 3, 5)
        assert not any(p.is_alive() for p in pool._procs)
    finally:
        pool.close()


def test_spawn_ranks_is_a_pool_of_one_run():
    got = spawn_ranks(state, 2, 3)
    assert [r["sum"] for r in got] == [[7.0] * 4] * 2
    assert got[0]["pid"] != got[1]["pid"]
