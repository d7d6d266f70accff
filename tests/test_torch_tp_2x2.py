"""The model-axis cases of ``tests/test_torch_tp.py`` on the (2, 2) mesh.
A file of its own, so that a run's workers take the two meshes' runs at
the same time; the cases are that file's, collected here with this file's
``runs``."""
import pytest

from test_torch_tp import (MESHES,  # noqa: F401 - collected here
                           test_planted_faults_are_caught,
                           test_tp_batcher_ranks_emit_the_same_tokens,
                           test_tp_cache_holds_this_ranks_heads,
                           test_tp_forward_and_decode_match_jax,
                           test_tp_forward_and_decode_match_single_rank,
                           test_tp_init_gathers_to_the_single_draw,
                           test_tp_step_matches_jax,
                           test_tp_step_matches_single_rank,
                           test_tp_wire_bytes_equal_the_ring_formula, tp_runs)


@pytest.fixture(scope="module", params=MESHES[1:], ids=["2x2"])
def runs(request, tmp_path_factory):
    """Every case on the (2, 2) mesh's 4 ranks and on JAX's 4 devices."""
    return tp_runs(request.param, tmp_path_factory)
