"""The port on the card: the CUDA kernel against its plain version, and the
model's prefill on the card against the same model on the CPU.

Every test here is marked ``cuda`` and skips where there is no card.  The
file imports no jax, so it also runs where jax is not installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.models import init_params
from repro_torch.serve import make_prefill

pytestmark = pytest.mark.cuda

# tests/test_kernels.py:15-17
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
LOGIT_TOL = dict(atol=5e-4, rtol=1e-3)  # tests/test_pallas_integration.py

# the sweep of tests/test_kernels.py:21-28, group size 7, head dims 32 and
# 80, a ragged length and Sq > Sk with rows that keep no key
SHAPES = [(1, 2, 2, 128, 128, 64), (2, 4, 2, 256, 256, 64),
          (1, 8, 1, 256, 512, 128), (1, 14, 2, 128, 128, 64),
          (1, 4, 2, 128, 128, 80), (2, 4, 2, 200, 200, 32),
          (1, 4, 2, 300, 100, 64)]
MASKS = [(True, None), (False, None), (True, 128), (True, 32)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
def test_kernel_matches_plain(cuda, shape, causal, window, dtype):
    b, h, kv, sq, sk, d = shape
    rng = np.random.default_rng(sum(shape))
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to(cuda, dtype)
               for s in ((b, h, sq, d), (b, kv, sk, d), (b, kv, sk, d)))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    ref = attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dtype
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_on_card_runs_the_kernel_and_matches_cpu(cuda, arch):
    cfg = smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    tok = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 200)))
    before = flash_attention.launches
    out = make_prefill(cfg)(_to(params, cuda), tok.to(cuda))
    torch.cuda.synchronize()
    assert flash_attention.launches - before == cfg.num_layers
    ref = make_prefill(cfg)(params, tok)
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), **LOGIT_TOL)
