"""The training half of ``tests/test_torch_arch_smoke.py`` for the
architectures that file leaves out (a file of its own, so that a run's
workers spread the two)."""
import pytest

from repro_torch.configs import ARCHS
from test_torch_arch_smoke import TRAIN_ARCHS, check_train_step_reduces_loss


@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in TRAIN_ARCHS])
def test_train_step_reduces_loss_and_finite(arch):
    check_train_step_reduces_loss(arch)
