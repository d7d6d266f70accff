"""The port on the card: each CUDA kernel against its plain version, and
the model's prefill on the card against the same model on the CPU.

Every test here is marked ``cuda`` and skips where there is no card.  The
file imports no jax, so it also runs where jax is not installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_ref
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
from repro_torch.models import forward, init_params, prefill_launches
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


# tests/test_kernels.py:53-58, a ragged L, and the mamba2-130m heads
SSD_SHAPES = [(1, 2, 256, 64, 32, 64), (2, 4, 512, 64, 128, 128),
              (1, 2, 256, 128, 64, 256), (1, 3, 200, 32, 16, 256),
              (2, 24, 256, 64, 128, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_scan_kernel_matches_plain(cuda, shape, dtype):
    """K6 against its plain version: |err| / max(|ref|, 1) within 3e-5 in
    f32 and 3e-2 in bf16 (tests/test_kernels.py:72-76, whose 3e-2 rtol is
    kept for bf16 only, so that f32 holds the kernel to f32); x and dt as
    the model passes them (permuted views of (B,L,H,P) and (B,L,H))."""
    b, h, l, p, n, chunk = shape
    rng = np.random.default_rng(sum(shape))

    def mk(*s, scale=1.0):
        return torch.from_numpy(rng.standard_normal(s, dtype=np.float32)
                                * scale).to(cuda)

    x = mk(b, l, h, p, scale=0.5).to(dtype).permute(0, 2, 1, 3)
    dt = torch.nn.functional.softplus(mk(b, l, h)).permute(0, 2, 1)
    a = -torch.linspace(1.0, 16.0, h, device=cuda)  # the model's decays
    bb, cc = mk(b, l, n, scale=0.3).to(dtype), mk(b, l, n, scale=0.3).to(dtype)
    before = ssd_scan.launches
    out = ssd_scan(x, dt, a, bb, cc, chunk=chunk)
    ref = ssd_scan_ref(x, dt, a, bb, cc, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert out.dtype == dtype and bool(torch.isfinite(out.float()).all())
    scale = max(float(ref.float().abs().max()), 1.0)
    np.testing.assert_allclose(
        out.float().cpu().numpy() / scale, ref.float().cpu().numpy() / scale,
        **(dict(atol=3e-2, rtol=3e-2) if dtype == torch.bfloat16
           else dict(atol=3e-5, rtol=0.0)))


# tests/test_kernels.py:102-107, the ragged decode shape and odd d, f
GMM_SHAPES = [(2, 128, 256, 128), (4, 256, 512, 384), (16, 128, 256, 256),
              (16, 4, 640, 1000), (3, 77, 100, 60)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GMM_SHAPES)
@pytest.mark.parametrize("broadcast", [False, True])
def test_moe_gmm_kernel_matches_plain(cuda, shape, dtype, broadcast):
    """K5 against its plain version; ``broadcast`` passes the tokens
    expanded over experts (expert stride 0), as moe_dense does."""
    e, c, d, f = shape
    rng = np.random.default_rng(sum(shape))
    xs = (c, d) if broadcast else (e, c, d)
    x = torch.from_numpy(rng.standard_normal(xs, dtype=np.float32)).to(
        cuda, dtype)
    if broadcast:
        x = x.expand(e, c, d)
    w = torch.from_numpy(rng.standard_normal((e, d, f), dtype=np.float32)
                         * 0.05).to(cuda, dtype)
    before = moe_gmm.launches
    out = moe_gmm(x, w)
    ref = moe_gmm_ref(x, w)
    torch.cuda.synchronize()
    assert moe_gmm.launches == before + 1
    assert out.dtype == dtype and out.shape == (e, c, f)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_on_card_runs_the_kernel_and_matches_cpu(cuda, arch):
    cfg = smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    tok = torch.from_numpy(  # S 200: within the Mamba scan's chunk of 256
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 200)))
    before = launch_counts()
    out = make_prefill(cfg)(_to(params, cuda), tok.to(cuda))
    torch.cuda.synchronize()
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == \
        prefill_launches(cfg)
    ref = make_prefill(cfg)(params, tok)
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), **LOGIT_TOL)


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if any(sp.ffn == "moe" for sp in
                                         smoke_config(a).layer_specs())])
def test_router_loss_on_card_matches_cpu(cuda, arch):
    """forward's summed router loss with the MoE FFNs on the card (K5, and
    K1 or K6 in the mixers) against the same model on the CPU."""
    cfg = smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    tok = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 64)))
    _, aux = forward(cfg, _to(params, cuda), tok.to(cuda))
    _, ref = forward(cfg, params, tok)
    assert float(ref) > 0
    np.testing.assert_allclose(float(aux), float(ref), rtol=1e-5)
