"""The port's training step against the JAX package's on the SSM, MoE,
hybrid and MLA families (mamba2-130m, dbrx-132b, jamba-1.5-large-398b,
deepseek-v2-236b), at smoke size on the CPU."""
import pytest

from torch_train_cases import check_train_step, step_cases


@pytest.mark.parametrize("arch,overrides,remat", step_cases((
    "mamba2-130m", "dbrx-132b", "jamba-1.5-large-398b", "deepseek-v2-236b")))
def test_train_step_matches_jax(arch, overrides, remat):
    """One step from shared params, state and batch against the JAX
    package's (``torch_train_cases.check_train_step``)."""
    check_train_step(arch, overrides, remat)
