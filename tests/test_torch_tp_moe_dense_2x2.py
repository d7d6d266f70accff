"""The cases of ``tests/test_torch_tp_moe_dense.py`` on the (2, 2) mesh: a
MoE config on a model axis of 2 without expert parallelism beside a data
axis of 2 (the training step ZeRO-1 over it, the pick fractions of the
router's loss summed over it).  The smoke configs of dbrx-132b,
deepseek-v2-236b and jamba-1.5-large-398b, whose 4 experts split in two.
A file of its own, so that a run's workers take the two meshes' runs at
the same time; the checks are that file's, run here on this file's
``runs``."""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import pytest

from test_torch_tp import (MESHES, MOE_ARCHS,
                           check_tp_batcher_ranks_emit_the_same_tokens,
                           check_tp_forward_and_decode_match_jax,
                           check_tp_forward_and_decode_match_single_rank,
                           check_tp_init_gathers_to_the_single_draw,
                           check_tp_step_matches_jax,
                           check_tp_step_matches_single_rank)
from test_torch_tp_moe_dense import (GRAD_FAULTS, TEMPERATURE,
                                     check_planted_gradient_fault,
                                     check_wire_bytes, dense_runs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on the (2, 2) mesh's 4 ranks and on JAX's 4 devices."""
    return dense_runs(MESHES[1], tmp_path_factory, MOE_ARCHS)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dense_forward_and_decode_match_jax(runs, arch):
    check_tp_forward_and_decode_match_jax(runs, arch)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dense_forward_and_decode_match_single_rank(runs, arch):
    check_tp_forward_and_decode_match_single_rank(runs, arch)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dense_step_matches_jax(runs, arch):
    check_tp_step_matches_jax(runs, arch)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dense_step_matches_single_rank(runs, arch):
    check_tp_step_matches_single_rank(runs, arch)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dense_init_gathers_to_the_single_draw(runs, arch):
    check_tp_init_gathers_to_the_single_draw(runs, arch)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dense_batcher_ranks_emit_the_same_tokens(runs, arch):
    check_tp_batcher_ranks_emit_the_same_tokens(runs, arch, TEMPERATURE)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dense_wire_bytes_equal_the_ring_formula(runs, arch):
    check_wire_bytes(runs, arch)


@pytest.mark.parametrize("fault,arch", GRAD_FAULTS)
def test_moe_dense_planted_gradient_faults_are_caught(runs, fault, arch):
    check_planted_gradient_fault(runs, fault, arch)
