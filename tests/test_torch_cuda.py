"""The port on the card: each CUDA kernel against its plain version, the
model's prefill and the codecs on the card against the same on the CPU, a
quantized ring over gloo with CUDA tensors, and the data-, expert- and
tensor-parallel steps over gloo ranks sharing the card.

Every test here is marked ``cuda`` and skips where there is no card.  The
file imports no jax, so it also runs where jax is not installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.compress import LowRankCodec, get_codec
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.kernels import launch_counts
from repro_torch.kernels.compress import ops as cops
from repro_torch.kernels.compress import ref as cref
from repro_torch.kernels.flash_attention import (
    attention_bwd_ref, attention_lse_ref, attention_ref, flash_attention,
    flash_attention_bwd, flash_attention_stats)
from repro_torch.kernels.flash_attention.ops import \
    LAUNCHES_PER_CALL as BWD_LAUNCHES
from repro_torch.kernels.moe_gmm import (moe_gmm, moe_gmm_bwd,
                                         moe_gmm_bwd_ref, moe_gmm_ref)
from repro_torch.kernels.moe_gmm.ops import \
    BWD_LAUNCHES_PER_CALL as GMM_BWD_LAUNCHES
from repro_torch.kernels.moe_gmm.ops import (gmm_bwd_split, gmm_bwd_tiles,
                                             gmm_bwd_walk)
from repro_torch.kernels.ssd_scan import (ssd_scan, ssd_scan_bwd,
                                          ssd_scan_bwd_ref, ssd_scan_ref,
                                          ssd_scan_workspace)
from repro_torch.kernels.ssd_scan.ops import \
    BWD_LAUNCHES_PER_CALL as SSD_BWD_LAUNCHES
from repro_torch.kernels.ssd_scan.ops import LAUNCHES_PER_CALL as SSD_LAUNCHES
from repro_torch.core.types import TrainConfig
from repro_torch.data import make_batches
from repro_torch.models import (decode_step, encode, encode_launches,
                                ep_launches, forward, init_cache,
                                init_params, param_leaves, prefill_launches,
                                train_launches, tree_map)
from repro_torch.parallel import expert_flags
from repro_torch.optim import init_opt_state
from repro_torch.train import make_train_step
from repro_torch.launch.ranks import build_kernels, spawn_ranks
from repro_torch.serve import make_prefill
from torch_ccl_ranks import compressed_ring_emulation, ring_q8_on_card
from torch_dp_ranks import dp_on_card, update_errors
from torch_ep_ranks import card_tokens, ep_on_card, ep_train_on_card
from torch_tp_ranks import card_context as tp_card_context
from torch_tp_ranks import card_params as tp_card_params
from torch_tp_ranks import card_tokens as tp_card_tokens
from torch_tp_ranks import tp_on_card
from torch_context import open_gates, stub_context

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
# the backward's grid over query heads at its edges: a granite-like GQA
# shape at D 128 (several waves of blocks), H = KV (one head a KV head),
# Sq > Sk with rows that keep no key under both windows, and a length that
# is not a whole number of 64-row tiles
BWD_SHAPES = SHAPES + [(2, 32, 8, 512, 512, 128), (2, 4, 4, 192, 192, 64),
                       (1, 6, 2, 333, 150, 80), (1, 3, 3, 77, 77, 32)]


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


# bf16 on the tensor cores: every head dim, ragged lengths, Sq != Sk under
# causal and window masks, and the serving paths' prefill shapes
BF16_CASES = [((1, 4, 2, 200, 200, 32), True, None),
              ((1, 4, 2, 330, 330, 64), True, 96),
              ((1, 8, 2, 256, 256, 80), True, 128),
              ((1, 4, 1, 100, 300, 128), False, 64),
              ((1, 4, 2, 300, 100, 64), True, 32),
              ((1, 4, 2, 129, 257, 80), True, 100),
              ((1, 4, 2, 257, 129, 128), False, None),
              ((4, 14, 2, 512, 512, 64), True, None),
              ((2, 48, 8, 256, 256, 128), True, None)]


@pytest.mark.parametrize("layout", ["bhsd", "bshd_views"])
@pytest.mark.parametrize("shape,causal,window", BF16_CASES)
def test_bf16_kernel_on_tensor_cores(cuda, shape, causal, window, layout):
    """K1's wgmma variant against the plain version, on contiguous
    (B,H,S,D) tensors and on the model's (B,S,H,D) tensors passed as
    transposed views; the views give the contiguous inputs' result, and
    the output keeps q's layout."""
    b, h, kv, sq, sk, d = shape
    rng = np.random.default_rng(sum(shape))
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to(cuda, torch.bfloat16)
               for s in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    if layout == "bhsd":
        q, k, v = (t.contiguous() for t in (q, k, v))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    ref = attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert flash_attention.last_variant == "wgmma"
    assert out.stride() == q.stride()
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(),
                               **TOL[torch.bfloat16])
    if layout == "bshd_views":
        same = flash_attention(*(t.contiguous() for t in (q, k, v)),
                               causal=causal, window=window)
        assert torch.equal(out, same)


def _bwd_inputs(seed, shape, dtype, device, views=False):
    """q, k, v and dO of one sweep shape, (B,H,S,D) (or, with ``views``,
    transposed (B,S,H,D) tensors as the model passes them)."""
    b, h, kv, sq, sk, d = shape
    rng = np.random.default_rng(seed)

    def mk(n, s):
        if views:
            return torch.from_numpy(rng.standard_normal(
                (b, s, n, d), dtype=np.float32)).to(device, dtype) \
                .transpose(1, 2)
        return torch.from_numpy(rng.standard_normal(
            (b, n, s, d), dtype=np.float32)).to(device, dtype)
    return mk(h, sq), mk(kv, sk), mk(kv, sk), mk(h, sq)


def _bwd_f64(q, k, v, do, causal, window):
    """The gradient in f64 on the card: the reference of the kernel."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    o = attention_ref(q, k, v, causal=causal, window=window)
    lse = attention_lse_ref(q, k, causal=causal, window=window)
    return attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                             window=window)


def _max_err(a, b):
    return float((a.double() - b.double()).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BWD_SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
def test_backward_kernel_matches_plain(cuda, shape, causal, window, dtype):
    """K1-bwd over the forward's sweep (rows that keep no key included)
    and the edges of its grid over query heads against the f64 gradient.  f32: within 2e-5 (TOL, the forward's f32
    tolerance).  bf16, FlashAttention's own convention: the kernel's max
    error is at most twice that of the plain version run in bf16 (which
    rounds P and dS to bf16 as the kernel does) plus 1e-3."""
    q, k, v, do = _bwd_inputs(sum(shape) + 3, shape, dtype, cuda)
    o, lse = flash_attention_stats(q, k, v, causal=causal, window=window)
    before = flash_attention_bwd.launches
    grads = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                window=window)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + BWD_LAUNCHES
    assert flash_attention_bwd.last_variant == \
        ("f32" if dtype == torch.float32 else "wgmma")
    ref = _bwd_f64(q, k, v, do, causal, window)
    if dtype == torch.float32:
        for got, want in zip(grads, ref):
            assert got.dtype == dtype
            np.testing.assert_allclose(got.cpu().numpy(),
                                       want.float().cpu().numpy(),
                                       **TOL[torch.float32])
        return
    o_p = attention_ref(q, k, v, causal=causal, window=window)
    lse_p = attention_lse_ref(q, k, causal=causal, window=window)
    plain = attention_bwd_ref(q, k, v, o_p, lse_p, do, causal=causal,
                              window=window)
    for name, got, p, want in zip("qkv", grads, plain, ref):
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        err, err_plain = _max_err(got, want), _max_err(p, want)
        assert err <= 2 * err_plain + 1e-3, (name, err, err_plain)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,causal,window", [
    ((4, 14, 2, 512, 512, 64), True, None),
    ((2, 32, 8, 512, 512, 128), True, None),
    ((1, 6, 2, 333, 150, 80), True, 32)])
def test_backward_kernel_is_deterministic(cuda, shape, causal, window, dtype):
    """K1-bwd sums the G query heads of a KV head in a fixed order and uses
    no atomics: two calls on the same inputs give the same bits."""
    q, k, v, do = _bwd_inputs(sum(shape) + 7, shape, dtype, cuda,
                              views=True)
    o, lse = flash_attention_stats(q, k, v, causal=causal, window=window)
    first = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                window=window)
    second = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                 window=window)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
def test_forward_statistics_match_plain(cuda, shape, causal, window, dtype):
    """The row statistics K1 writes for the backward against
    ``attention_lse_ref`` (+inf on the same rows), and the output written
    beside them equal to the output of the launch without them."""
    q, k, v, _ = _bwd_inputs(sum(shape) + 5, shape, dtype, cuda)
    out, lse = flash_attention_stats(q, k, v, causal=causal, window=window)
    ref = attention_lse_ref(q, k, causal=causal, window=window)
    torch.cuda.synchronize()
    assert torch.equal(torch.isinf(lse), torch.isinf(ref))
    fin = ~torch.isinf(ref)
    np.testing.assert_allclose(lse[fin].cpu().numpy(), ref[fin].cpu().numpy(),
                               atol=2e-5, rtol=2e-5)
    with torch.no_grad():
        assert torch.equal(out, flash_attention(q, k, v, causal=causal,
                                                window=window))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,causal,window", [
    ((2, 14, 2, 128, 128, 64), True, None), ((1, 4, 2, 200, 200, 80), True, 64),
    ((1, 4, 2, 300, 100, 64), True, 32), ((2, 8, 1, 96, 96, 128), False, None)])
def test_autograd_function_on_card(cuda, shape, causal, window, dtype):
    """``flash_attention`` on the model's transposed (B,S,H,D) views with
    requires_grad: one forward launch, three backward launches, gradients
    in the inputs' strides, equal to autograd of ``attention_ref`` on the
    same card (f32 within TOL; bf16 within twice the plain bf16 error of
    the f64 gradient plus 1e-3, as above)."""
    q, k, v, do = _bwd_inputs(sum(shape), shape, dtype, cuda, views=True)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    n0 = launch_counts()
    out = flash_attention(*leaves, causal=causal, window=window)
    out.backward(do)
    torch.cuda.synchronize()
    n1 = launch_counts()
    assert n1["flash_attention"] == n0["flash_attention"] + 1
    assert n1["flash_attention_bwd"] == \
        n0["flash_attention_bwd"] + BWD_LAUNCHES
    for t in leaves:
        assert t.grad.stride() == t.stride()
    plain = [t.detach().requires_grad_(True) for t in (q, k, v)]
    attention_ref(*plain, causal=causal, window=window).backward(do)
    ref = _bwd_f64(q, k, v, do, causal, window)
    for got, p, want in zip(leaves, plain, ref):
        if dtype == torch.float32:
            np.testing.assert_allclose(got.grad.cpu().numpy(),
                                       p.grad.cpu().numpy(),
                                       **TOL[torch.float32])
        else:
            assert _max_err(got.grad, want) <= \
                2 * _max_err(p.grad, want) + 1e-3


# tests/test_kernels.py:53-58, a ragged L, the mamba2-130m heads, a long
# scan (64 chunks of the kernel's 64 to carry) and an L ragged against the
# kernel's chunk (1000 = 15 x 64 + 40, the caller's chunk 200)
SSD_SHAPES = [(1, 2, 256, 64, 32, 64), (2, 4, 512, 64, 128, 128),
              (1, 2, 256, 128, 64, 256), (1, 3, 200, 32, 16, 256),
              (2, 24, 256, 64, 128, 256), (1, 4, 4096, 64, 128, 256),
              (2, 3, 1000, 64, 64, 200)]


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
    # three stages: chunk states, the carry, the outputs
    assert ssd_scan.launches == before + SSD_LAUNCHES == before + 3
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


# (E, C, d, f, x expanded over experts, x's row padding, variant): C on
# both sides of the swap-AB threshold and at each of its widths (8, 16,
# 32, 64), d and f off the tiles, unaligned row strides, decode's C = 4
GMM_VARIANT_CASES = [
    (4, 64, 256, 512, True, 0, "wgmma"), (4, 128, 256, 256, False, 0, "wgmma"),
    (3, 200, 200, 1000, True, 0, "wgmma"), (3, 200, 200, 1000, False, 0, "wgmma"),
    (2, 512, 512, 384, False, 0, "wgmma"), (16, 512, 640, 1000, True, 0, "wgmma"),
    (2, 128, 264, 256, False, 8, "wgmma"),  # padded rows, still aligned
    (3, 128, 100, 1000, True, 0, "mma_sync"),  # 200-byte rows
    (2, 128, 128, 256, False, 3, "mma_sync"),  # rows 131 values apart
    (16, 4, 640, 1000, True, 0, "wgmma_swap"),
    (16, 4, 1000, 640, False, 0, "wgmma_swap"),
    (2, 63, 128, 256, False, 0, "wgmma_swap"), (3, 9, 200, 1000, True, 0, "wgmma_swap"),
    (3, 20, 264, 256, False, 8, "wgmma_swap"), (2, 1, 64, 64, False, 0, "wgmma_swap"),
    (16, 4, 100, 1000, True, 0, "mma_sync")]


@pytest.mark.parametrize("e,c,d,f,broadcast,pad,variant", GMM_VARIANT_CASES)
def test_moe_gmm_bf16_variants(cuda, e, c, d, f, broadcast, pad, variant):
    """K5 bf16 against its plain version, each case on the variant its
    layout picks: x expanded over experts or per expert, rows padded by
    ``pad`` values (a view of a wider tensor)."""
    rng = np.random.default_rng(e * c + d + f + pad)
    xs = (c, d + pad) if broadcast else (e, c, d + pad)
    x = torch.from_numpy(rng.standard_normal(xs, dtype=np.float32)).to(
        cuda, torch.bfloat16)[..., :d]
    if broadcast:
        x = x.expand(e, c, d)
    w = torch.from_numpy(rng.standard_normal((e, d, f), dtype=np.float32)
                         * 0.05).to(cuda, torch.bfloat16)
    before = moe_gmm.launches
    out = moe_gmm(x, w)
    ref = moe_gmm_ref(x, w)
    torch.cuda.synchronize()
    assert moe_gmm.launches == before + 1
    assert moe_gmm.last_variant == variant
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(),
                               **TOL[torch.bfloat16])


# K6's backward: P 32 / 64 / 128, N 16 to 128, one chunk, several to carry
# and a ragged last chunk (of the kernel's 64), mamba2-130m's heads
SSD_BWD_SHAPES = [(1, 2, 64, 32, 16), (2, 3, 256, 64, 32),
                  (1, 2, 200, 128, 64), (2, 4, 512, 64, 128),
                  (1, 3, 1000, 32, 128), (2, 24, 256, 64, 128),
                  (1, 2, 130, 128, 16)]


def _ssd_bwd_inputs(shape, device, seed):
    """The model's layouts (x and dt permuted views) and decays; dy too a
    permuted view, as autograd hands it back through the model's permute."""
    b, h, l, p, n = shape
    rng = np.random.default_rng(seed)

    def mk(*s, scale=1.0):
        return torch.from_numpy(rng.standard_normal(s, dtype=np.float32)
                                * scale).to(device)

    x = mk(b, l, h, p, scale=0.5).permute(0, 2, 1, 3)
    dt = torch.nn.functional.softplus(mk(b, l, h)).permute(0, 2, 1)
    a = -torch.linspace(1.0, 16.0, h, device=device)
    bb, cc = mk(b, l, n, scale=0.3), mk(b, l, n, scale=0.3)
    dy = mk(b, l, h, p).permute(0, 2, 1, 3)
    return x, dt, a, bb, cc, dy


def _scaled(got, want) -> float:
    return float((got.double() - want.double()).abs().max()) / max(
        float(want.double().abs().max()), 1.0)


# the head groups of chunk_grad (a block takes the heads of one (b,
# chunk)): odd head counts that leave a short last group, P 128 with N
# 128 (h and G in slices of 16 columns), several groups of 8 heads
SSD_BWD_GROUP_SHAPES = [(1, 5, 320, 64, 128), (3, 7, 192, 64, 128),
                        (1, 3, 200, 128, 128), (1, 33, 128, 32, 64),
                        (2, 11, 448, 128, 32), (1, 48, 512, 64, 128)]


@pytest.mark.parametrize("shape", SSD_BWD_SHAPES + SSD_BWD_GROUP_SHAPES)
def test_ssd_scan_bwd_kernel_matches_plain(cuda, shape):
    """K6-bwd (four launches, reading the forward's workspace) against its
    plain version on the card at the kernel's chunk of 64, within 5e-5 of
    each gradient's scale, and against the f64 autograd gradient of the
    plain forward (one chunk of L) within 5e-5; two calls bit-equal (the head and chunk sums
    are taken in a fixed order)."""
    x, dt, a, bb, cc, dy = _ssd_bwd_inputs(shape, cuda, sum(shape))
    _, work = ssd_scan_workspace(x, dt, a, bb, cc)
    before = ssd_scan_bwd.launches
    got = ssd_scan_bwd(x, dt, a, bb, cc, dy, workspace=work)
    again = ssd_scan_bwd(x, dt, a, bb, cc, dy, workspace=work)
    torch.cuda.synchronize()
    assert ssd_scan_bwd.launches == before + 2 * SSD_BWD_LAUNCHES
    want = ssd_scan_bwd_ref(x, dt, a, bb, cc, dy, chunk=64)
    ins = [t.double().requires_grad_(True) for t in (x, dt, a, bb, cc)]
    exact = torch.autograd.grad(ssd_scan_ref(*ins, chunk=shape[2]), ins,
                                dy.double())
    for g, g2, w, t, v in zip(got, again, want, exact, (x, dt, a, bb, cc)):
        assert g.shape == v.shape and g.dtype == torch.float32
        assert torch.equal(g, g2)
        assert bool(torch.isfinite(g).all())
        assert _scaled(g, w) <= 5e-5 and _scaled(g, t) <= 5e-5


GMM_BWD_SHAPES = [(2, 128, 256, 128), (4, 256, 512, 384), (3, 77, 100, 60),
                  (16, 4, 640, 1000), (2, 63, 64, 200), (160, 8, 64, 48),
                  (8, 160, 256, 512)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GMM_BWD_SHAPES)
@pytest.mark.parametrize("layout", ["expanded", "strided", "contiguous"])
def test_moe_gmm_bwd_kernel_matches_plain(cuda, shape, dtype, layout):
    """K5-bwd (two launches: dx with w read transposed, dw with x read
    through its strides) against its plain version: x expanded over the
    experts (dx their one sum), x a row-padded view, or contiguous; C
    below and above one 64-row tile, d and f off the tiles, E 160.
    Scaled by max(|ref|, 1), within TOL; two calls bit-equal."""
    e, c, d, f = shape
    rng = np.random.default_rng(sum(shape))

    def mk(*s, scale=1.0):
        return torch.from_numpy(rng.standard_normal(s, dtype=np.float32)
                                * scale).to(cuda, dtype)

    expanded = layout == "expanded"
    if expanded:
        x = mk(c, d)
    elif layout == "strided":
        x = mk(e, c, d + 8)[..., :d]
    else:
        x = mk(e, c, d)
    w, dy = mk(e, d, f, scale=0.05), mk(e, c, f)
    before = moe_gmm_bwd.launches
    got = moe_gmm_bwd(x, w, dy, expanded=expanded)
    again = moe_gmm_bwd(x, w, dy, expanded=expanded)
    torch.cuda.synchronize()
    assert moe_gmm_bwd.launches == before + 2 * GMM_BWD_LAUNCHES
    want = moe_gmm_bwd_ref(x, w, dy, expanded=expanded)
    for g, g2, ref, v in zip(got, again, want, (x, w)):
        assert g.shape == v.shape and g.dtype == dtype
        assert torch.equal(g, g2)
        scale = max(float(ref.float().abs().max()), 1.0)
        np.testing.assert_allclose(g.float().cpu().numpy() / scale,
                                   ref.float().cpu().numpy() / scale,
                                   **TOL[dtype])


# (E, C, d, f, x layout, variant): the wgmma variant's paths -- C 160
# (an EP rank: a last tile of 32 rows, taken as a 64-row half tile), the
# 64-row edge exactly (C 192) and past it (C 200: a full last tile), dx's
# K walk split into several part counts (expanded tokens and too few
# tiles for the card), a padded-row view that stays aligned -- and the
# layouts that take mma_sync (d 100; rows 131 values apart)
GMM_BWD_PATH_CASES = [
    (8, 160, 256, 512, "contiguous", "wgmma"),
    (4, 192, 256, 256, "contiguous", "wgmma"),
    (3, 200, 384, 320, "strided", "wgmma"),
    (2, 130, 256, 512, "expanded", "wgmma"),
    (2, 128, 256, 128, "expanded", "wgmma"),
    (4, 256, 512, 384, "expanded", "wgmma"),
    (16, 512, 640, 1024, "expanded", "wgmma"),
    (3, 77, 100, 60, "expanded", "mma_sync"),
    (2, 128, 128, 256, "padded3", "mma_sync")]


@pytest.mark.parametrize("e,c,d,f,layout,variant", GMM_BWD_PATH_CASES)
def test_moe_gmm_bwd_variants_and_split(cuda, e, c, d, f, layout, variant):
    """K5-bwd bf16 on the variant its layout picks, against its plain
    version within TOL of max(|ref|, 1); the split of dx's K walk is the
    plan's for this card (``gmm_bwd_split``), several counts above 1
    among these cases; two calls bit-equal (the parts are summed in a
    fixed order)."""
    rng = np.random.default_rng(e + c + d + f)

    def mk(*s, scale=1.0):
        return torch.from_numpy(rng.standard_normal(s, dtype=np.float32)
                                * scale).to(cuda, torch.bfloat16)

    expanded = layout == "expanded"
    pad = {"strided": 8, "padded3": 3}.get(layout, 0)
    x = mk(c, d) if expanded else mk(e, c, d + pad)[..., :d]
    w, dy = mk(e, d, f, scale=0.05), mk(e, c, f)
    before = moe_gmm_bwd.launches
    got = moe_gmm_bwd(x, w, dy, expanded=expanded)
    again = moe_gmm_bwd(x, w, dy, expanded=expanded)
    torch.cuda.synchronize()
    assert moe_gmm_bwd.launches == before + 2 * GMM_BWD_LAUNCHES
    assert moe_gmm_bwd.last_variant == variant
    if variant == "wgmma":
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        want_split = gmm_bwd_split(gmm_bwd_tiles(e, c, d, expanded),
                                   gmm_bwd_walk(e, f, expanded), sms)
        assert moe_gmm_bwd.last_split == want_split
    want = moe_gmm_bwd_ref(x, w, dy, expanded=expanded)
    for g, g2, ref, v in zip(got, again, want, (x, w)):
        assert g.shape == v.shape and g.dtype == torch.bfloat16
        assert torch.equal(g, g2)
        scale = max(float(ref.float().abs().max()), 1.0)
        np.testing.assert_allclose(g.float().cpu().numpy() / scale,
                                   ref.float().cpu().numpy() / scale,
                                   **TOL[torch.bfloat16])


def test_moe_gmm_bwd_splits_at_several_counts(cuda):
    """On this card the split cases above cut dx's walk into more than one
    distinct count of parts (the last part of each tile sums them)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits = {gmm_bwd_split(gmm_bwd_tiles(e, c, d, True),
                            gmm_bwd_walk(e, f, True), sms)
              for e, c, d, f, layout, _ in GMM_BWD_PATH_CASES
              if layout == "expanded" and d % 8 == 0}
    assert len(splits - {1}) >= 2, splits


def test_ssd_scan_and_moe_gmm_record_their_backward_kernels(cuda):
    """On CUDA tensors that require grad, ``ssd_scan`` and ``moe_gmm``
    (expanded as moe_dense calls it, and not) record their autograd
    Functions: the forward kernel once, the backward kernel in the
    backward, and autograd's gradients of the plain forward (f32)."""
    x, dt, a, bb, cc, dy = _ssd_bwd_inputs((2, 4, 256, 64, 32), cuda, 3)
    ins = [t.detach().clone().requires_grad_(True)
           for t in (x, dt, a, bb, cc)]
    n0 = launch_counts()
    got = torch.autograd.grad(ssd_scan(*ins, chunk=64), ins, dy)
    torch.cuda.synchronize()
    n1 = launch_counts()
    assert n1["ssd_scan"] - n0["ssd_scan"] == SSD_LAUNCHES
    assert n1["ssd_scan_bwd"] - n0["ssd_scan_bwd"] == SSD_BWD_LAUNCHES
    want = torch.autograd.grad(ssd_scan_ref(*ins, chunk=64), ins, dy)
    for g, w in zip(got, want):
        assert _scaled(g, w) <= 5e-5
    g = torch.Generator(device=cuda).manual_seed(0)
    for expanded in (True, False):
        xs = (16, 64) if expanded else (4, 16, 64)
        xg = torch.randn(*xs, device=cuda, generator=g).requires_grad_(True)
        wg = (0.05 * torch.randn(4, 64, 32, device=cuda, generator=g)
              ).requires_grad_(True)
        dyg = torch.randn(4, 16, 32, device=cuda, generator=g)
        n0 = launch_counts()
        got = torch.autograd.grad(moe_gmm(xg, wg, expanded=expanded),
                                  (xg, wg), dyg)
        torch.cuda.synchronize()
        n1 = launch_counts()
        assert n1["moe_gmm"] - n0["moe_gmm"] == 1
        assert n1["moe_gmm_bwd"] - n0["moe_gmm_bwd"] == GMM_BWD_LAUNCHES
        want = torch.autograd.grad(moe_gmm_ref(xg, wg, expanded=expanded),
                                   (xg, wg), dyg)
        for gv, wv in zip(got, want):
            torch.testing.assert_close(gv, wv, **TOL[torch.float32])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_on_card_runs_the_kernel_and_matches_cpu(cuda, arch):
    """make_prefill on the card against the CPU, the launches counted
    against ``prefill_launches`` (and, for the encoder-decoder, the
    encoder's ``encode_launches``); the context families with their stub
    context and their cross-attention gates opened."""
    cfg = smoke_config(arch)
    params = open_gates(init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu"))
    tok = torch.from_numpy(  # S 200: within the Mamba scan's chunk of 256
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 200)))
    context = stub_context(cfg, 2)

    def run(p, device):
        c = None if context is None else torch.from_numpy(context).to(device)
        if cfg.is_encoder_decoder:
            c = encode(cfg, p, c)
        return make_prefill(cfg)(p, tok.to(device), c)

    p_gpu = _to(params, cuda)
    before = launch_counts()
    out = run(p_gpu, cuda)
    torch.cuda.synchronize()
    after = launch_counts()
    launched = {k: after[k] - before[k] for k in after}
    want = prefill_launches(cfg, 200)
    want["flash_attention"] += encode_launches(cfg)["flash_attention"]
    assert {k: n for k, n in launched.items() if n} == \
        {k: n for k, n in want.items() if n}
    ref = run(params, "cpu")
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


# quantize: the JAX test's shapes (tests/test_compress.py:186-188, as the
# payload-level rows), ragged rows, the short/long boundary (4096) and long
# rows that take the two-pass path
Q_SHAPES = [(1, 256), (8, 256), (2, 256), (3, 100), (7, 33), (2, 4096),
            (1, 4097), (3, 10001), (1, 1 << 20), (2, 65536 + 3)]


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", Q_SHAPES)
def test_quantize_kernel_matches_plain(cuda, shape, dtype, bits, stochastic):
    """K2a and K2b against their plain versions: q, scales and the decode
    bit-equal (the same true division and half-to-even rounding; the same
    uint32 bits for the stochastic path)."""
    rng = np.random.default_rng(sum(shape) + bits)
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * 3
                         ).to(cuda, dtype)
    rand = torch.from_numpy(rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
                            .view(np.int32)).to(cuda) if stochastic else None
    before = cops.quantize_kernel.launches
    q, s = cops.quantize_kernel(x, rand, bits=bits, stochastic=stochastic)
    torch.cuda.synchronize()
    assert cops.quantize_kernel.launches == \
        before + (1 if shape[1] <= 4096 else 2)
    q_ref, s_ref = cref.quantize_ref(x, bits, stochastic, rand, per_row=True)
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
    before = cops.dequantize_kernel.launches
    out = cops.dequantize_kernel(q, s)
    torch.cuda.synchronize()
    assert cops.dequantize_kernel.launches == before + 1
    assert torch.equal(out, cref.dequantize_ref(q, s))


# (m, n, byte offset of q in its allocation, K2b's variant): one row (a
# ring hop) and rows of 256 (the payload), a row index by multiply-shift
# through a divisor that is no power of two (n / 16 = 3, 257), ragged n,
# and views at 4 and 1 bytes off 16
DQ_CASES = [(1, 4096, 0, "vec16"), (1, 1 << 22, 0, "vec16"),
            (64, 256, 0, "vec16"), (1000, 48, 0, "vec16"),
            (3, 4112, 0, "vec16"), (5, 100, 0, "vec4"), (1, 100, 0, "vec4"),
            (7, 33, 0, "scalar"), (1, 33, 0, "scalar"),
            (4, 256, 4, "vec4"), (4, 256, 1, "scalar"),
            (1, 4096, 3, "scalar")]


@pytest.mark.parametrize("m,n,offset,variant", DQ_CASES)
def test_dequantize_kernel_variants(cuda, m, n, offset, variant):
    """K2b on each variant: bit-equal to dequantize_ref and torch.mul."""
    rng = np.random.default_rng(m + n + offset)
    flat = torch.from_numpy(rng.integers(-127, 128, offset + m * n,
                                         dtype=np.int8)).to(cuda)
    q = flat[offset:].view(m, n)
    s = torch.from_numpy(rng.uniform(0.01, 2.0, (m, 1)).astype(
        np.float32)).to(cuda)
    before = cops.dequantize_kernel.launches
    out = cops.dequantize_kernel(q, s)
    torch.cuda.synchronize()
    assert cops.dequantize_kernel.last_variant == variant
    assert cops.dequantize_kernel.launches == before + 1
    assert torch.equal(out, cref.dequantize_ref(q, s))
    assert torch.equal(out, torch.mul(q, s))


# rows of 256, 100 and 33 (vector items, a row index through a divisor
# that is no power of two, scalar), one row of 513 values (scalar), the
# unrolled loop's tail over many rows (5 x 4124: 5,155 items of 4) and one
# long row on both variants (1,000,004 and 1,000,003 values)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 256), (3, 100), (1, 513), (7, 33),
                                   (5, 4 * 1031), (1, 1_000_003),
                                   (1, 1_000_004)])
def test_sparsify_kernel_matches_plain(cuda, shape, dtype):
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
        cuda, dtype)
    t = torch.from_numpy(rng.uniform(0.2, 1.5, (shape[0], 1)).astype(
        np.float32)).to(cuda)
    before = cops.sparsify_kernel.launches
    out = cops.sparsify_kernel(x, t)
    torch.cuda.synchronize()
    assert cops.sparsify_kernel.launches == before + 1
    assert torch.equal(out, cref.sparsify_ref(x, t))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_payload_sparsify_on_card_matches_cpu(cuda, dtype):
    """The payload-level sparsify (one row, one threshold) on the card:
    one launch, bit-equal to the CPU's and to the zero-padded rows of 256
    on the card."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 333_333), dtype=np.float32)).to(dtype)
    before = cops.sparsify_kernel.launches
    out = cops.sparsify(x.to(cuda), 1.0)
    torch.cuda.synchronize()
    assert cops.sparsify_kernel.launches == before + 1
    assert torch.equal(out.cpu(), cops.sparsify(x, 1.0))
    rows, n = cops._as_rows(x.to(cuda))
    padded = cops.sparsify_kernel(rows, torch.ones(rows.shape[0], 1,
                                                   device=cuda))
    assert torch.equal(out, padded.reshape(-1)[:n].reshape(x.shape))


# (m, k, n, layout of a, layout of b, route in f32, route in bf16):
# tests/test_compress.py:227-232, ragged, n of 5-8, the transposed view of
# M^T @ P, k <= 8 (the decode), a general shape, few rows over a long k and
# its decode (split over blocks: the o-projection gradient as 14 x 57,344),
# a skinny operand larger than shared memory, and the layouts of M^T @ P,
# streamed from 48 MiB of M: P column-major (QR's) and row-major, a ragged
# last quad (898 of 904 columns), a ragged last block (k = 15003), five
# column slices (the MLP's 4,864 columns), rank 8; the MLP's 17 MB below
# the line.  a: "rows" row-major, "t" a row-major M transposed, "t_slice"
# the first m columns of a wider M transposed.
MM_SHAPES = [(128, 64, 4, "rows", "rows", "rows", "rows"),
             (100, 37, 3, "rows", "rows", "rows", "rows"),
             (50, 40, 6, "rows", "rows", "rows", "rows"),
             (64, 5000, 4, "t", "rows", "cols", "cols"),
             (33, 4, 7, "t", "rows", "cols", "cols"),
             (1000, 4, 96, "rows", "rows", "smallk", "smallk"),
             (70, 50, 40, "rows", "rows", "tiled", "tiled"),
             (40, 30, 20, "t", "rows", "tiled", "tiled"),
             (4, 13000, 4, "rows", "rows", "rows", "rows"),
             (14, 57344, 4, "rows", "rows", "rows", "rows"),
             (14, 4, 57344, "rows", "rows", "smallk", "smallk"),
             (3, 8, 7000, "rows", "rows", "smallk", "smallk"),
             (4864, 896, 4, "t", "cols", "cols", "cols"),
             (896, 15000, 4, "t", "cols", "cols_bulk", "cols"),
             (896, 15000, 4, "t", "rows", "cols_bulk", "cols"),
             (896, 15000, 8, "t", "cols", "cols_bulk", "cols"),
             (898, 15000, 4, "t_slice", "cols", "cols_bulk", "cols"),
             (896, 15003, 4, "t", "cols", "cols_bulk", "cols"),
             (4864, 2700, 4, "t", "cols", "cols_bulk", "cols"),
             (896, 30000, 4, "t", "cols", "cols_bulk", "cols_bulk"),
             (4862, 5500, 3, "t_slice", "rows", "cols_bulk", "cols_bulk")]


def _mm_operands(m, k, n, a_layout, b_layout, dtype, device):
    rng = np.random.default_rng(m + k + n)

    def mk(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(device, dtype)
    if a_layout == "rows":
        a = mk(m, k)
    elif a_layout == "t":
        a = mk(k, m).T
    else:  # rows of the wider M 16-byte aligned for both dtypes
        a = mk(k, (m + 8) // 8 * 8)[:, :m].T
    b = mk(k, n) if b_layout == "rows" else mk(n, k).T
    return a, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,a_layout,b_layout,f32_route,bf16_route",
                         MM_SHAPES)
def test_matmul_kernel_matches_plain(cuda, m, k, n, a_layout, b_layout,
                                     f32_route, bf16_route, dtype):
    """K4 against its plain version, on the route the layout gives: f32
    accumulation in another order (bf16 inputs are exact in f32).  Within
    atol and rtol 1e-5 up to the JAX test's k = 64
    (tests/test_compress.py:227-232); beyond it the difference of two
    summation orders grows with the terms, not with their sum, so there
    rtol 1e-5 applies to |a| @ |b|."""
    a, b = _mm_operands(m, k, n, a_layout, b_layout, dtype, cuda)
    out = cops.matmul_kernel(a, b)
    torch.cuda.synchronize()
    assert cops.matmul_kernel.last_variant == (
        f32_route if dtype == torch.float32 else bf16_route)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    ref = cref.matmul_ref(a, b)
    scale = cref.matmul_ref(a.abs(), b.abs()) if k > 64 else ref.abs()
    err = (out - ref).abs()
    assert bool((err <= 1e-5 + 1e-5 * scale).all()), float(err.max())


@pytest.mark.parametrize("name", ["q8", "q4", "topk"])
def test_codec_on_card_matches_cpu(cuda, name):
    """The codec's wire tensors and decode on the card equal the CPU's."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (300, 77), dtype=np.float32))
    codec = get_codec(name)
    enc_c, st_c = codec.encode(x, codec.init_state(x))
    enc_g, st_g = codec.encode(x.to(cuda), codec.init_state(x.to(cuda)))
    for a, b in zip(enc_c.arrays, enc_g.arrays):
        assert torch.equal(a, b.cpu())
    assert torch.equal(codec.decode(enc_c), codec.decode(enc_g).cpu())


def test_lowrank_codec_on_card_matches_cpu(cuda, monkeypatch):
    """The same Q0 on both (the CPU generator's); the decode, which does
    not depend on QR's column signs, within 1e-4 relative; K4 launched."""
    def q0(self, n, r, device):
        gen = torch.Generator().manual_seed(r + n % 9973)
        return torch.randn((n, r), generator=gen).to(device)

    monkeypatch.setattr(LowRankCodec, "_test_matrix", q0)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (500, 96), dtype=np.float32))
    codec = get_codec("lowrank")
    dec_c = codec.decode(codec.encode(x)[0])
    before = cops.matmul_kernel.launches
    dec_g = codec.decode(codec.encode(x.to(cuda))[0])
    torch.cuda.synchronize()
    assert cops.matmul_kernel.launches >= before + 3
    rel = float((dec_g.cpu() - dec_c).norm() / dec_c.norm())
    assert rel <= 1e-4, rel


def test_ring_q8_over_gloo_with_cuda_tensors(cuda):
    """Two ranks on the card, gloo between them: every hop through K2a/K2b,
    both ranks hold the same result, bit-equal to the JAX package's hop
    algebra in IEEE f32."""
    n, seed = 1 << 16, 5
    res = spawn_ranks(ring_q8_on_card, 2, n, seed, timeout_s=300)
    xs = np.stack([torch.randn(n, generator=torch.Generator().manual_seed(
        seed + r)).numpy() for r in range(2)])
    for r in res:
        assert r["device"].startswith("cuda")
        assert r["quantize"] >= 2 and r["dequantize"] >= 2
        np.testing.assert_array_equal(r["result"],
                                      compressed_ring_emulation(xs, 8)[0])


def _refused(name, cuda):
    """One call of the wrapper ``name`` on CUDA inputs that require grad."""
    g = torch.Generator(device=cuda).manual_seed(0)

    def rnd(*shape, grad=True):
        return torch.randn(*shape, device=cuda, generator=g) \
            .requires_grad_(grad)
    if name == "quantize":
        return cops.quantize_kernel(rnd(4, 256))
    if name == "dequantize":
        q = torch.zeros(4, 256, dtype=torch.int8, device=cuda)
        return cops.dequantize_kernel(q, rnd(4, 1).abs())
    if name == "sparsify":
        return cops.sparsify_kernel(rnd(4, 256), rnd(4, 1, grad=False).abs())
    return cops.matmul_kernel(rnd(64, 32), rnd(32, 4))


@pytest.mark.parametrize("name", ["quantize", "dequantize", "sparsify",
                                  "matmul"])
def test_kernels_without_backward_refuse_grad(cuda, name):
    """The compression kernels have no backward kernel (their inputs are
    detached gradients): on CUDA inputs that require grad they raise
    (naming the missing backward) instead of returning a tensor that cuts
    the graph; under no_grad they launch."""
    before = launch_counts()
    with pytest.raises(NotImplementedError, match="backward"):
        _refused(name, cuda)
    assert launch_counts() == before
    with torch.no_grad():
        _refused(name, cuda)
    torch.cuda.synchronize()
    assert launch_counts() != before


@pytest.mark.parametrize("arch", ["mamba2-130m", "dbrx-132b"])
def test_training_ssm_and_moe_on_card(cuda, arch):
    """A Mamba and a MoE model train on the card: 8 f32 steps on one
    batch at smoke size lower the loss, every step launching the forward
    and backward kernels of ``train_launches`` (K6 and K6-bwd; K1, K5 and
    K5-bwd)."""
    cfg = smoke_config(arch)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    opt = init_opt_state(params)
    batch = next(make_batches(cfg, 2, 64))
    step = make_train_step(cfg, TrainConfig(remat=False, learning_rate=3e-3,
                                            warmup_steps=1))
    losses = []
    n0 = launch_counts()
    for _ in range(8):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    n1 = launch_counts()
    assert all(np.isfinite(losses)) and losses[-1] < 0.9 * losses[0], losses
    assert {k: n1[k] - n0[k] for k in n1 if n1[k] != n0[k]} == {
        k: 8 * n for k, n in train_launches(cfg, 1, False).items()}


@pytest.mark.parametrize("arch,microbatches,remat", [
    ("qwen2-0.5b", 1, False), ("qwen2-0.5b", 2, True),
    ("h2o-danube-1.8b", 2, False), ("granite-3-8b", 1, True),
    ("llama-3.2-vision-90b", 1, False), ("seamless-m4t-medium", 2, True),
    ("mamba2-130m", 2, True), ("dbrx-132b", 1, False),
    ("deepseek-v2-236b", 1, False), ("jamba-1.5-large-398b", 1, False)])
def test_train_step_on_card_matches_cpu(cuda, arch, microbatches, remat):
    """One f32 step at smoke size on the card (K1, K6 and K5 and their
    backward kernels, counted against ``train_launches``; the encoder's
    layers included)
    against the same step on the CPU (held to JAX by
    tests/test_torch_train.py): loss and grad_norm within 1e-5, params and
    m within TOL.  The context families take their stub context, gates
    open."""
    cfg = smoke_config(arch)
    params = open_gates(init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu"))
    batch = next(make_batches(cfg, 4, 128, seed=1))
    context = stub_context(cfg, 4, 1)
    if context is not None:
        batch["context"] = context
    tcfg = TrainConfig(microbatches=microbatches, remat=remat)
    step = make_train_step(cfg, tcfg)
    p_gpu = _to(params, cuda)
    n0 = launch_counts()
    p_gpu, o_gpu, m_gpu = step(p_gpu, init_opt_state(p_gpu), batch)
    torch.cuda.synchronize()
    n1 = launch_counts()
    launched = {k: n1[k] - n0[k] for k in n1 if n1[k] != n0[k]}
    assert launched == train_launches(cfg, microbatches, remat, 128)
    p_cpu, o_cpu, m_cpu = step(params, init_opt_state(params), batch)
    for k in ("loss", "grad_norm"):
        assert float(m_gpu[k]) == pytest.approx(float(m_cpu[k]), rel=1e-5)
    for tree_g, tree_c in ((p_gpu, p_cpu), (o_gpu["m"], o_cpu["m"])):
        for a, b in zip(param_leaves(tree_g), param_leaves(tree_c)):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                       **TOL[torch.float32])


@pytest.mark.parametrize("zero1,microbatches,remat", [
    (True, 1, False), (False, 1, False), (True, 2, True)])
def test_dp_on_card_matches_single_card_step(cuda, zero1, microbatches,
                                             remat):
    """DP-2 (2 gloo ranks sharing the card, gradients staged through the
    host) against the single-card step on the whole batch, both through
    the kernels, at lr 1e-3 from the first step: loss and grad_norm within
    1e-5, m and v within TOL, the parameters within 1e-3 x lr of AdamW
    written out from the run's own moments and each leaf's update within
    1e-2 of the single-card step's (``update_errors``); both ranks'
    parameters bit-equal; each rank launches the kernels of a step on its
    half of every microbatch."""
    arch = "qwen2-0.5b"
    tcfg = dict(zero1=zero1, microbatches=microbatches, remat=remat,
                learning_rate=1e-3, warmup_steps=1)
    build_kernels()
    ranks = spawn_ranks(dp_on_card, 2, arch, tcfg, 0, timeout_s=300)
    cfg = smoke_config(arch)
    params = _to(init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu"), cuda)
    p0 = dict(enumerate(t.cpu().numpy() for t in param_leaves(params)))
    batch = next(make_batches(cfg, 4, 128, seed=1))
    params, opt, m = make_train_step(cfg, TrainConfig(**tcfg))(
        params, init_opt_state(params), batch)
    got = ranks[0]
    assert all(r["device"] == "cuda:0" for r in ranks)
    assert ranks[0]["checksum"] == ranks[1]["checksum"]
    for r in ranks:
        assert r["launches"] == train_launches(cfg, microbatches, remat)
    for k in ("loss", "grad_norm"):
        assert got["metrics"][k] == pytest.approx(float(m[k]), rel=1e-5)
    for k in ("m", "v"):
        for a, b in zip(got[k], param_leaves(opt[k])):
            np.testing.assert_allclose(a, b.cpu().numpy(),
                                       **TOL[torch.float32])
    want = dict(enumerate(t.cpu().numpy() for t in param_leaves(params)))
    err = update_errors(p0, dict(enumerate(got["params"])), want,
                        dict(enumerate(got["m"])), dict(enumerate(got["v"])),
                        tcfg, got["metrics"]["lr"])
    assert err["adamw"] <= 1e-3 and err["update"] <= 1e-2, err


def test_remat_on_card_matches_no_remat(cuda):
    """forward(remat=True) on the card: K1's forward twice a layer, and the
    gradients of the forward without remat (the recomputed statistics are
    the first run's: the kernels are deterministic)."""
    cfg = smoke_config("qwen2-0.5b")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(3),
                         device=cuda)
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 128))).to(cuda)
    grads, counts = [], []
    for remat in (False, True):
        leaves = [t.detach().requires_grad_(True)
                  for t in param_leaves(params)]
        it = iter(leaves)
        p = tree_map(lambda _: next(it), params)
        n0 = launch_counts()
        logits, _ = forward(cfg, p, tok, remat=remat)
        logits.float().square().mean().backward()
        torch.cuda.synchronize()
        n1 = launch_counts()
        counts.append({k: n1[k] - n0[k] for k in n1 if n1[k] != n0[k]})
        grads.append([t.grad for t in leaves])
    assert counts[0] == train_launches(cfg, 1, False)
    assert counts[1] == train_launches(cfg, 1, True)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


def test_ep_on_card_matches_dense(cuda):
    """dbrx's smoke config in f32 on two gloo ranks sharing the card, a
    (1, 2) mesh at capacity factor 4 (no drops): each rank's experts,
    drawn from the seed on the card, bit-equal to its half of the full
    draw; prefill (``moe_ep_train``, two all-to-alls a layer) and decode
    (``moe_ep_decode``) logits within LOGIT_TOL of the single-card dense
    model's; each rank launches K1 once and K5 three times a MoE layer in
    the prefill and K5 three times a MoE layer a decode step
    (``ep_launches``)."""
    steps = 4
    build_kernels()
    ranks = spawn_ranks(ep_on_card, 2, 0, steps, timeout_s=300)
    cfg = smoke_config("dbrx-132b")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    tokens = card_tokens(cfg).to(cuda)
    with torch.no_grad():
        want, _ = forward(cfg, params, tokens)
        cache = init_cache(cfg, params, tokens.shape[0], steps)
        dec = [decode_step(cfg, params, cache, tokens[:, t:t + 1], t)[0][:, 0]
               for t in range(steps)]
    experts = [t for t, e in zip(param_leaves(params), expert_flags(params))
               if e]
    for m, r in enumerate(ranks):
        assert r["device"] == "cuda:0"
        for got, full in zip(r["experts"], experts):
            half = full.shape[0] // 2
            np.testing.assert_array_equal(
                got, full[m * half:(m + 1) * half].cpu().numpy())
        np.testing.assert_allclose(r["logits"], want.cpu().numpy(),
                                   **LOGIT_TOL)
        np.testing.assert_allclose(r["decode"],
                                   torch.stack(dec, 1).cpu().numpy(),
                                   **LOGIT_TOL)
        assert r["prefill_launches"] == {
            **{k: n for k, n in prefill_launches(cfg).items() if n},
            **ep_launches(cfg)}
        assert r["decode_launches"] == {
            k: n * steps for k, n in ep_launches(cfg).items()}


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
def test_ep_training_on_card_matches_single_card_step(cuda, mesh):
    """An expert-parallel f32 training step of dbrx's smoke config on 4
    gloo ranks sharing the card (two all-to-alls a MoE layer forward and
    two backward, K5-bwd on each rank's experts), at capacity factor 16
    (no drops), against the single-card dense step on the same batch:
    loss and grad_norm within 1e-5, every rank's first moments after the
    step (0.1 x the clipped gradient), gathered from the model ranks
    (experts and attention heads), within TOL; each rank launches a step's
    ``train_launches`` (K5 and K5-bwd on its own experts, K1 and K1-bwd on
    its heads)."""
    tcfg = dict(remat=False, zero1=False)
    build_kernels()
    ranks = spawn_ranks(ep_train_on_card, 4, mesh, 0, tcfg, timeout_s=300)
    cfg = smoke_config("dbrx-132b")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    batch = next(make_batches(cfg, 4, 64, seed=1))
    _, opt, m = make_train_step(cfg, TrainConfig(**tcfg))(
        params, init_opt_state(params), batch)
    want = [t.cpu().numpy() for t in param_leaves(opt["m"])]
    for r in ranks:
        assert r["launches"] == train_launches(cfg, 1, False)
        for k in ("loss", "grad_norm"):
            assert r["metrics"][k] == pytest.approx(float(m[k]), rel=1e-5)
        for got, full in zip(r["m"], want):
            np.testing.assert_allclose(got, full, **TOL[torch.float32])


# the local heads of tensor parallelism at tp 4 (B 2 x S 256): granite-3-8b
# (8 of 32 query heads, 2 of 8 KV heads, D 128), starcoder2-3b's mixed case
# (6 of 24 query heads reading 1 of its 2 KV heads, a slice of the
# projected K/V), mamba2-130m's SSD scan (6 of 24 heads)
TP_ATTN_SHAPES = [((2, 8, 2, 256, 256, 128), None),
                  ((2, 6, 2, 256, 256, 128), slice(0, 1))]
TP_SSD_SHAPE = (2, 6, 256, 64, 128, 256)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,sel", TP_ATTN_SHAPES)
def test_kernel_on_tp_local_heads(cuda, shape, sel, dtype):
    """K1 on a tensor-parallel rank's heads, on the model's (B,S,H,D)
    tensors as views; where the KV heads do not split, K and V are a head
    slice of the projected (B,S,KV,D) tensors: the kernel reads them
    through their strides and gives the contiguous inputs' result."""
    b, h, kv, s, _, d = shape
    rng = np.random.default_rng(sum(shape))
    q, k, v = (torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))
               .to(cuda, dtype)
               for sh in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
    if sel is not None:
        k, v = k[:, :, sel], v[:, :, sel]
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True)
    ref = attention_ref(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_on_tp_local_heads(cuda, dtype):
    """K6 on a tensor-parallel rank's 6 of mamba2's 24 heads, its x a head
    block of the (B,L,H,P) projection, as the model passes it."""
    b, h, l, p, n, chunk = TP_SSD_SHAPE
    rng = np.random.default_rng(sum(TP_SSD_SHAPE))

    def mk(*s, scale=1.0):
        return torch.from_numpy(rng.standard_normal(s, dtype=np.float32)
                                * scale).to(cuda)

    x = mk(b, l, h, p, scale=0.5).to(dtype).permute(0, 2, 1, 3)
    dt = torch.nn.functional.softplus(mk(b, l, h)).permute(0, 2, 1)
    a = -torch.linspace(1.0, 16.0, 4 * h, device=cuda)[h:2 * h]  # rank 1
    bb, cc = mk(b, l, n, scale=0.3).to(dtype), mk(b, l, n, scale=0.3).to(dtype)
    before = ssd_scan.launches
    out = ssd_scan(x, dt, a, bb, cc, chunk=chunk)
    ref = ssd_scan_ref(x, dt, a, bb, cc, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + SSD_LAUNCHES
    scale = max(float(ref.float().abs().max()), 1.0)
    np.testing.assert_allclose(
        out.float().cpu().numpy() / scale, ref.float().cpu().numpy() / scale,
        **(dict(atol=3e-2, rtol=3e-2) if dtype == torch.bfloat16
           else dict(atol=3e-5, rtol=0.0)))


@pytest.mark.parametrize("mesh", [(1, 2), (1, 4)], ids=["1x2", "1x4"])
def test_tp_on_card_matches_cpu_step(cuda, mesh):
    """granite's smoke config on tensor-parallel gloo ranks sharing the
    card (at tp 2 its KV heads split, at tp 4 only its query heads): the
    gathered prefill logits within LOGIT_TOL of the single-rank CPU
    forward, one f32 step's loss and grad_norm within 1e-5 and the
    gathered parameters and first moments within TOL of the single-rank
    CPU step (as test_train_step_on_card_matches_cpu); each rank launches
    K1 once a layer in the prefill and a step's ``train_launches``."""
    arch = "granite-3-8b"
    build_kernels()
    world = mesh[0] * mesh[1]
    ranks = spawn_ranks(tp_on_card, world, arch, mesh, 0, timeout_s=300)
    cfg = smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    tokens = tp_card_tokens(cfg)
    with torch.no_grad():
        want, _ = forward(cfg, params, tokens)
    params, opt, m = make_train_step(cfg, TrainConfig(remat=False))(
        params, init_opt_state(params),
        {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)})
    for r in ranks:
        assert r["device"] == "cuda:0"
        np.testing.assert_allclose(r["logits"], want.numpy(), **LOGIT_TOL)
        assert r["prefill_launches"] == {"flash_attention": cfg.num_layers}
        assert r["step_launches"] == train_launches(cfg, 1, False, 64)
        for k in ("loss", "grad_norm"):
            assert r["metrics"][k] == pytest.approx(float(m[k]), rel=1e-5)
        for got, tree in ((r["params"], params), (r["m"], opt["m"])):
            for a, b in zip(got, param_leaves(tree)):
                np.testing.assert_allclose(a, b.numpy(),
                                           **TOL[torch.float32])


@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v2-236b",
                                  "jamba-1.5-large-398b",
                                  "llama-3.2-vision-90b",
                                  "seamless-m4t-medium"])
def test_tp_beside_ep_on_card_matches_cpu_step(cuda, arch):
    """The model axis of every family on 2 gloo ranks sharing the card, a
    (1, 2) mesh: dbrx's, deepseek's (MLA and the shared experts) and
    jamba's (Mamba heads) attention and FFN on their halves beside K5 on
    each rank's experts (expert parallelism, capacity factor E: no drops),
    llama-3.2-vision's cross-attention layer and seamless's encoder and
    cross blocks on their heads (the gates opened); the gathered prefill
    logits within LOGIT_TOL of the single-rank CPU forward, one f32 step
    as ``test_tp_on_card_matches_cpu_step``; each rank launches K1 on its
    heads, K5 on its experts and K6 on its Mamba heads as
    ``prefill_launches`` (and the encoder's ``encode_launches``) and a
    step's ``train_launches`` say."""
    build_kernels()
    ranks = spawn_ranks(tp_on_card, 2, arch, (1, 2), 0, timeout_s=300)
    cfg = smoke_config(arch)
    params = tp_card_params(cfg, 0)
    tokens = tp_card_tokens(cfg)
    frames = tp_card_context(cfg)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    context = None
    with torch.no_grad():
        if frames is not None:
            batch["context"] = frames
            context = torch.from_numpy(frames)
            if cfg.is_encoder_decoder:
                context = encode(cfg, params, context)
        want, _ = forward(cfg, params, tokens, context=context)
    params, opt, m = make_train_step(cfg, TrainConfig(remat=False))(
        params, init_opt_state(params), batch)
    seq = tokens.shape[1]
    prefill = prefill_launches(cfg, seq)
    prefill["flash_attention"] += encode_launches(cfg)["flash_attention"] \
        if cfg.is_encoder_decoder else 0
    for r in ranks:
        assert r["device"] == "cuda:0"
        np.testing.assert_allclose(r["logits"], want.numpy(), **LOGIT_TOL)
        assert r["prefill_launches"] == {k: n for k, n in prefill.items()
                                         if n}
        assert r["step_launches"] == train_launches(cfg, 1, False, seq)
        for k in ("loss", "grad_norm"):
            assert r["metrics"][k] == pytest.approx(float(m[k]), rel=1e-5)
        for got, tree in ((r["params"], params), (r["m"], opt["m"])):
            for a, b in zip(got, param_leaves(tree)):
                np.testing.assert_allclose(a, b.numpy(),
                                           **TOL[torch.float32])
