"""The SSD scan's backward on the CPU: its plain version
(``ref.ssd_scan_bwd_ref``, the stages of ``csrc/ssd_scan_bwd.cu`` written
out in PyTorch) against ``jax.vjp`` of the JAX package's scan and against
autograd of the port's plain forward in f64, and ``SsdScan`` (the
autograd Function that ``ssd_scan`` records on the card) on CPU tensors
against autograd of the plain forward.  Inputs from numpy seeds; the CUDA
kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_scan_ref
from repro_torch.kernels import launch_counts
from repro_torch.kernels.ssd_scan import (SsdScan, ssd_scan, ssd_scan_bwd,
                                          ssd_scan_bwd_ref, ssd_scan_ref)

NAMES = ("dx", "ddt", "da", "db", "dc")

# (B, H, L, P, N, the JAX scan's chunk, the plain backward's chunk): one
# chunk; several chunks to carry; a ragged last chunk (L 200 in chunks of
# 64, against JAX in chunks of 40: at one chunk of 200 and the model's
# decays JAX's own gradient of dt and a is 4.7e-5 and 5.8e-5 of their scale
# off the f64 one, the port's 1.6e-5 and 6e-6); the kernel's own chunk of
# 64 over 512 rows against JAX's 128; P 128 with N 16
CASES = [(1, 2, 64, 32, 16, 64, 64), (2, 3, 256, 32, 16, 64, 64),
         (1, 3, 200, 32, 16, 40, 64), (2, 4, 512, 64, 32, 128, 64),
         (1, 2, 128, 128, 16, 32, 32)]


def _inputs(b, h, l, p, n, seed, model_decay=False):
    """tests/test_torch_ssm.py's distributions; dy standard normal."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, l, p), dtype=np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, h, l), dtype=np.float32)))
    a = -np.exp(rng.standard_normal(h, dtype=np.float32))
    if model_decay:
        a = -np.linspace(1.0, 16.0, h, dtype=np.float32)
    bb = rng.standard_normal((b, l, n), dtype=np.float32) * 0.3
    cc = rng.standard_normal((b, l, n), dtype=np.float32) * 0.3
    dy = rng.standard_normal((b, h, l, p), dtype=np.float32)
    return [v.astype(np.float32) for v in (x, dt, a, bb, cc, dy)]


def _scaled_err(got, want) -> float:
    """max |got - want| over max(|want|, 1): the scan's scaled error."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1.0)


@pytest.mark.parametrize("model_decay", [False, True])
@pytest.mark.parametrize("b,h,l,p,n,jchunk,chunk", CASES)
def test_plain_backward_matches_jax_vjp(b, h, l, p, n, jchunk, chunk,
                                        model_decay):
    """Within 5e-5 of each gradient's scale (f32): the JAX scan takes its
    segment sums as differences of one cumsum, which loses up to 2.9e-5 of
    the forward's scale at the model's decays (tests/test_torch_ssm.py),
    the port sums each segment on its own; and within 2e-5 of the f64
    gradient of the port's plain forward."""
    x, dt, a, bb, cc, dy = _inputs(b, h, l, p, n, seed=l + p + n,
                                   model_decay=model_decay)
    _, vjp = jax.vjp(lambda *v: jax_ssd_scan_ref(*v, chunk=jchunk),
                     *(jnp.asarray(v) for v in (x, dt, a, bb, cc)))
    want = vjp(jnp.asarray(dy))
    got = ssd_scan_bwd_ref(*(torch.from_numpy(v) for v in
                             (x, dt, a, bb, cc, dy)), chunk=chunk)
    ins = [torch.from_numpy(v).double().requires_grad_(True)
           for v in (x, dt, a, bb, cc)]
    exact = torch.autograd.grad(ssd_scan_ref(*ins, chunk=jchunk), ins,
                                torch.from_numpy(dy).double())
    for name, g, w, t in zip(NAMES, got, want, exact):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert _scaled_err(g.numpy(), w) <= 5e-5, name
        assert _scaled_err(g.numpy(), t.numpy()) <= 2e-5, name


SSD_BWD_TOL = 5e-5  # chip_smoke.py's and the card tests' tolerance


@pytest.mark.parametrize("model_decay", [False, True])
@pytest.mark.parametrize("b,h,l,p,n,jchunk,chunk", CASES)
def test_split_tf32_backward_keeps_the_tolerance(b, h, l, p, n, jchunk,
                                                 chunk, model_decay):
    """The precision rehearsal of the backward kernel's tensor-core
    products: with every matrix product in 3xTF32 (``product="3xtf32"``,
    the forward's states and C B^T included), the plain backward stays
    within ``SSD_BWD_TOL`` of each gradient's scale of the f64 autograd
    gradient and of JAX's vjp, as with f32 products (both within 1.6e-5 of
    f64 here); with one TF32 product it misses the tolerance (3e-4 to
    6e-3), so the kernel splits every product."""
    x, dt, a, bb, cc, dy = _inputs(b, h, l, p, n, seed=l + p + n,
                                   model_decay=model_decay)
    _, vjp = jax.vjp(lambda *v: jax_ssd_scan_ref(*v, chunk=jchunk),
                     *(jnp.asarray(v) for v in (x, dt, a, bb, cc)))
    want = vjp(jnp.asarray(dy))
    ins = [torch.from_numpy(v).double().requires_grad_(True)
           for v in (x, dt, a, bb, cc)]
    exact = torch.autograd.grad(ssd_scan_ref(*ins, chunk=jchunk), ins,
                                torch.from_numpy(dy).double())
    args = [torch.from_numpy(v) for v in (x, dt, a, bb, cc, dy)]
    split = ssd_scan_bwd_ref(*args, chunk=chunk, product="3xtf32")
    f32 = ssd_scan_bwd_ref(*args, chunk=chunk, product="f32")
    for name, g, g32, w, t in zip(NAMES, split, f32, want, exact):
        assert g.dtype == torch.float32 and g.shape == t.shape, name
        assert _scaled_err(g.numpy(), t.numpy()) <= SSD_BWD_TOL, name
        assert _scaled_err(g.numpy(), w) <= SSD_BWD_TOL, name
        assert _scaled_err(g.numpy(), t.numpy()) <= 2 * _scaled_err(
            g32.numpy(), t.numpy()) + 2e-6, name
    tf32 = ssd_scan_bwd_ref(*args, chunk=chunk, product="tf32")
    worst = max(_scaled_err(g.numpy(), t.numpy())
                for g, t in zip(tf32, exact))
    assert worst > 4 * SSD_BWD_TOL, worst


@pytest.mark.parametrize("b,h,l,p,n,jchunk,chunk", CASES)
def test_plain_backward_matches_f64_autograd(b, h, l, p, n, jchunk, chunk):
    """In f64 the staged backward is autograd of the port's plain forward
    (at the JAX chunk) to rounding: 1e-10 of each gradient's scale."""
    arrays = _inputs(b, h, l, p, n, seed=7 * l + n, model_decay=True)
    x, dt, a, bb, cc, dy = (torch.from_numpy(v).double() for v in arrays)
    ins = [t.clone().requires_grad_(True) for t in (x, dt, a, bb, cc)]
    want = torch.autograd.grad(ssd_scan_ref(*ins, chunk=jchunk), ins, dy)
    got = ssd_scan_bwd_ref(x, dt, a, bb, cc, dy, chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float64, name
        assert _scaled_err(g.numpy(), w.numpy()) <= 1e-10, name


@pytest.mark.parametrize("b,h,l,p,n,jchunk,chunk", CASES[:4])
def test_function_on_cpu_matches_autograd(b, h, l, p, n, jchunk, chunk):
    """``SsdScan`` on CPU tensors (the plain forward, the plain backward)
    gives autograd's gradients of the plain forward, through the model's
    permuted views of x and dt, with no kernel launched."""
    x, dt, a, bb, cc, dy = (torch.from_numpy(v) for v in
                            _inputs(b, h, l, p, n, seed=3 * l + p))
    # the model's layouts: (B,L,H,P) and (B,L,H), permuted without a copy
    xl = x.permute(0, 2, 1, 3).contiguous().requires_grad_(True)
    dtl = dt.permute(0, 2, 1).contiguous().requires_grad_(True)
    rest = [t.clone().requires_grad_(True) for t in (a, bb, cc)]
    views = (xl.permute(0, 2, 1, 3), dtl.permute(0, 2, 1))
    before = launch_counts()
    got = torch.autograd.grad(SsdScan.apply(*views, *rest, jchunk),
                              [xl, dtl, *rest], dy)
    want = torch.autograd.grad(ssd_scan_ref(*views, *rest, chunk=jchunk),
                               [xl, dtl, *rest], dy)
    assert launch_counts() == before
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        assert _scaled_err(g.numpy(), w.numpy()) <= 2e-5, name


def test_wrapper_on_cpu_is_the_plain_backward():
    """``ssd_scan_bwd`` on CPU tensors is ``ssd_scan_bwd_ref`` at the
    caller's chunk, and ``ssd_scan`` stays differentiable there."""
    arrays = [torch.from_numpy(v) for v in _inputs(1, 2, 128, 32, 16, 5)]
    got = ssd_scan_bwd(*arrays, chunk=64)
    want = ssd_scan_bwd_ref(*arrays, chunk=64)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    x = arrays[0].clone().requires_grad_(True)
    y = ssd_scan(x, *arrays[1:5], chunk=64)
    assert y.grad_fn is not None


def test_backward_shape_errors():
    arrays = [torch.from_numpy(v) for v in _inputs(1, 2, 64, 32, 16, 0)]
    with pytest.raises(ValueError, match="dy"):
        ssd_scan_bwd(*arrays[:5], arrays[5][:, :, :32], chunk=64)
