"""The model-axis cases of ``tests/test_torch_tp_families.py`` on the
(2, 2) mesh.  A file of its own, so that a run's workers take the two
meshes' runs at the same time; the cases are that file's, collected here
with this file's ``runs``."""
import pytest

from test_torch_tp import MESHES
from test_torch_tp_families import (  # noqa: F401 - collected here
    families_runs, test_planted_gradient_faults_are_caught,
    test_tp_batcher_ranks_emit_the_same_tokens,
    test_tp_context_caches_hold_this_ranks_heads,
    test_tp_forward_and_decode_match_jax,
    test_tp_forward_and_decode_match_single_rank,
    test_tp_init_gathers_to_the_single_draw, test_tp_step_matches_jax,
    test_tp_step_matches_single_rank)


@pytest.fixture(scope="module", params=MESHES[1:], ids=["2x2"])
def runs(request, tmp_path_factory):
    """Every case on the (2, 2) mesh's 4 ranks and on JAX's 4 devices."""
    return families_runs(request.param, tmp_path_factory)
