"""The grouped expert GEMM's backward on the CPU: its plain version
(``ref.moe_gmm_bwd_ref``: dx = dy w^T, dw = x^T dy; the one sum over the
experts for expanded tokens) against ``jax.vjp`` of the JAX package's
``moe_gmm_ref``, and ``MoeGmm`` (the autograd Function that ``moe_gmm``
records on the card) on CPU tensors against autograd of the plain forward.
Inputs from numpy seeds; the CUDA kernel is held against the plain version
on the card (tests/test_torch_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gmm.ref import moe_gmm_ref as jax_moe_gmm_ref
from repro_torch.kernels import launch_counts
from repro_torch.kernels.moe_gmm import (MoeGmm, moe_gmm, moe_gmm_bwd,
                                         moe_gmm_bwd_ref, moe_gmm_ref)

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),  # tests/test_kernels.py:15-17
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}

# (E, C, d, f): tests/test_kernels.py's sweep, a decode shape of 3 slots
# and a ragged one
SHAPES = [(2, 128, 256, 128), (4, 64, 96, 80), (16, 3, 64, 48),
          (3, 17, 40, 24)]


def _inputs(e, c, d, f, expanded, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((c, d) if expanded else (e, c, d),
                            dtype=np.float32)
    w = rng.standard_normal((e, d, f), dtype=np.float32) * 0.05
    dy = rng.standard_normal((e, c, f), dtype=np.float32)
    return x, w, dy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("expanded", [False, True])
@pytest.mark.parametrize("e,c,d,f", SHAPES)
def test_plain_backward_matches_jax_vjp(e, c, d, f, expanded, dtype):
    """dx and dw against ``jax.vjp`` of the JAX oracle (of the tokens
    broadcast over the experts where expanded), within the JAX kernel
    tests' tolerances (dx's scale grows with f, dw's with C)."""
    x, w, dy = _inputs(e, c, d, f, expanded, seed=e + c + d + f)
    jx, jw, jdy = (jnp.asarray(v).astype(dtype) for v in (x, w, dy))

    def fwd(xv, wv):
        if expanded:
            xv = jnp.broadcast_to(xv, (e, *xv.shape))
        return jax_moe_gmm_ref(xv, wv)

    _, vjp = jax.vjp(fwd, jx, jw)
    want = vjp(jdy)
    got = moe_gmm_bwd_ref(*(torch.from_numpy(v).to(getattr(torch, dtype))
                            for v in (x, w, dy)), expanded=expanded)
    for g, wv, ref_in in zip(got, want, (x, w)):
        assert g.dtype == getattr(torch, dtype)
        assert tuple(g.shape) == ref_in.shape
        scale = max(float(np.abs(np.asarray(wv, np.float32)).max()), 1.0)
        np.testing.assert_allclose(g.float().numpy() / scale,
                                   np.asarray(wv, np.float32) / scale,
                                   **TOL[dtype])


@pytest.mark.parametrize("expanded", [False, True])
@pytest.mark.parametrize("e,c,d,f", SHAPES)
def test_function_on_cpu_matches_autograd(e, c, d, f, expanded):
    """``MoeGmm`` on CPU tensors gives autograd's gradients of the plain
    forward (through the expanded view where expanded), with no kernel
    launched; ``moe_gmm`` on CPU tensors is that plain forward."""
    x, w, dy = (torch.from_numpy(v) for v in
                _inputs(e, c, d, f, expanded, seed=3 * e + f))
    xa, wa = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    xb, wb = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    before = launch_counts()
    out = MoeGmm.apply(xa, wa, expanded)
    got = torch.autograd.grad(out, (xa, wa), dy)
    ref_out = moe_gmm(xb, wb, expanded=expanded)
    want = torch.autograd.grad(ref_out, (xb, wb), dy)
    assert launch_counts() == before
    torch.testing.assert_close(out, ref_out, **TOL["float32"])
    for g, wv in zip(got, want):
        assert g.shape == wv.shape
        torch.testing.assert_close(g, wv, **TOL["float32"])


def test_expanded_is_the_broadcast_tokens():
    """``expanded`` reads the (C, d) tokens as every expert's: the same
    product as the expanded view, in both the forward and the backward."""
    x, w, dy = (torch.from_numpy(v) for v in _inputs(4, 5, 8, 6, True, 1))
    xe = x.expand(4, *x.shape)
    assert torch.equal(moe_gmm(x, w, expanded=True), moe_gmm(xe, w))
    assert torch.equal(moe_gmm_ref(x, w, expanded=True), moe_gmm_ref(xe, w))
    dx, dw = moe_gmm_bwd(x, w, dy, expanded=True)
    dxe, dwe = moe_gmm_bwd(xe, w, dy)
    torch.testing.assert_close(dx, dxe.sum(0), **TOL["float32"])
    torch.testing.assert_close(dw, dwe, **TOL["float32"])


def test_backward_shape_errors():
    x, w, dy = (torch.from_numpy(v) for v in _inputs(2, 4, 8, 6, False, 0))
    with pytest.raises(ValueError, match="dy"):
        moe_gmm_bwd(x, w, dy[:, :3])
    with pytest.raises(ValueError, match="expanded"):
        moe_gmm(x, w, expanded=True)
