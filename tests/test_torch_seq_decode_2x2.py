"""The sequence-split decode of ``tests/test_torch_seq_decode.py`` on the
(2, 2) mesh: the model axis splits the query heads (and the smoke
configs' 2 KV heads, and deepseek-v2-236b's experts under expert
parallelism) beside the two data ranks' blocks of the slots; and a batch
of 3 on the 2 data ranks, each sequence at its own position, each with its
own owner.  One ``spawn_ranks`` of 4 gloo ranks and one JAX subprocess on 4
forced devices, as there, with its checks and tolerances."""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import pytest

from test_torch_seq_decode import (check_matches_jax,
                                   check_matches_single_rank,
                                   check_ranks_bit_equal, check_shard_shapes,
                                   check_wire_bytes, seq_mesh_runs,
                                   steps_from, STEPS)

CASES = {
    "tp_gqa": dict(config="qwen2-0.5b", max_len=64,
                   positions=[0, 1, 2, 31, 32, 33]),
    "tp_mla": dict(config="deepseek-v2-236b", max_len=64,
                   positions=[0, 1, 2, 31, 32, 33]),
    # a ring of 128, 64 slots a data rank: the third sequence's owner moves
    # from rank 0 to rank 1 at its second step
    "rows3": dict(config="qwen2-0.5b", max_len=128, batch=3,
                  positions=[[5 + t, 40 + t, 63 + t] for t in range(STEPS)]),
    "tp_swa_ring": dict(config="qwen2-0.5b-swa16", max_len=256,
                        positions=steps_from(90)),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on the (2, 2) mesh's 4 ranks and on JAX's 4 devices."""
    return seq_mesh_runs((2, 2), tmp_path_factory.mktemp("seq2x2"), CASES,
                         CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_seq_decode_2x2_matches_jax(runs, name):
    check_matches_jax(runs, name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_seq_decode_2x2_matches_single_rank(runs, name):
    check_matches_single_rank(runs, name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_seq_decode_2x2_ranks_bit_equal(runs, name):
    check_ranks_bit_equal(runs, name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_seq_cache_2x2_shards_are_jax_cache_specs(runs, name):
    check_shard_shapes(runs, name, split=True)


@pytest.mark.parametrize("name", sorted(CASES))
def test_seq_decode_2x2_wire_bytes_equal_the_formula(runs, name):
    check_wire_bytes(runs, name)
