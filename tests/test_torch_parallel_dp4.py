"""The data-parallel cases of ``tests/test_torch_parallel.py`` on 4 gloo
CPU ranks against the JAX package on 4 forced devices.  A file of its own,
so that a run's workers take the two meshes' runs at the same time; the
cases are that file's, collected here with this file's ``runs``."""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import pytest

from test_torch_parallel import (dp_runs,  # noqa: F401 - collected here
                                 test_dp_step_matches_jax,
                                 test_lossless_dp_equals_single_process_step,
                                 test_quantized_sync_matches_jax_and_its_envelope,
                                 test_ranks_identical_after_two_steps,
                                 test_zero1_holds_a_shard_of_the_moments)


@pytest.fixture(scope="module", params=[4], ids=["dp4"])
def runs(request, tmp_path_factory):
    """Every case on 4 ranks and on JAX's 4 devices."""
    return dp_runs(request.param, tmp_path_factory)
