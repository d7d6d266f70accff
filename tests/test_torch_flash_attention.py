"""The port's flash-attention module against the JAX package.

On the CPU the port's wrapper computes its plain version; that plain
version is held against the JAX reference and against the JAX Pallas kernel
in interpret mode, on the same inputs made with numpy from a seed.  The
CUDA kernel itself runs only on the card: tests/test_torch_cuda.py holds it
against the plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro.models.attention import multihead_attention as jax_mha
from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 attention_bwd_ref,
                                                 attention_lse_ref,
                                                 attention_ref,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_stats)
from repro_torch.kernels.flash_attention.ops import kernel_strides
from repro_torch.models.attention import kernel_attention, multihead_attention

# tests/test_kernels.py:15-17
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}

# the sweep of tests/test_kernels.py:21-28, plus group size 7 (qwen2) and
# head dim 80 (h2o-danube)
SHAPES = [(1, 2, 2, 128, 128, 64), (2, 4, 2, 256, 256, 64),
          (1, 8, 1, 256, 512, 128), (1, 14, 2, 128, 128, 64),
          (1, 4, 2, 128, 128, 80)]
MASKS = [(True, None), (False, None), (True, 128)]


def _inputs(seed, b, h, kv, sq, sk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d), dtype=np.float32),
            rng.standard_normal((b, kv, sk, d), dtype=np.float32),
            rng.standard_normal((b, kv, sk, d), dtype=np.float32))


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _jax(arrays, dtype):
    return [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
def test_plain_matches_jax_ref_and_interpret_kernel(shape, causal, window,
                                                    dtype):
    arrays = _inputs(sum(shape), *shape)
    port = flash_attention(*_torch(arrays, dtype), causal=causal,
                           window=window)
    jq, jk, jv = _jax(arrays, dtype)
    ref = jax_ref(jq, jk, jv, causal=causal, window=window)
    kern = jax_flash(jq, jk, jv, causal=causal, window=window)
    assert port.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(port), _np(ref), **TOL[dtype])
    np.testing.assert_allclose(_np(port), _np(kern), **TOL[dtype])


@pytest.mark.parametrize("shape,causal,window", [
    ((2, 4, 2, 200, 200, 32), True, None),   # ragged length
    ((1, 4, 1, 100, 300, 128), False, 64),   # rectangular, window only
    # Sq > Sk with a window: rows past Sk - 1 + window keep no key and
    # average all keys (finite NEG_INF, top-left causal alignment)
    ((1, 4, 2, 300, 100, 64), True, 32),
])
def test_plain_matches_jax_ref_ragged(shape, causal, window):
    arrays = _inputs(7, *shape)
    port = attention_ref(*_torch(arrays, "float32"), causal=causal,
                         window=window)
    ref = jax_ref(*_jax(arrays, "float32"), causal=causal, window=window)
    assert np.isfinite(_np(port)).all()
    np.testing.assert_allclose(_np(port), _np(ref), **TOL["float32"])


def test_cpu_wrapper_counts_no_launch():
    q, k, v = _torch(_inputs(0, 1, 4, 2, 64, 64, 32), "float32")
    before = launch_counts()["flash_attention"]
    out = flash_attention(q, k, v, causal=True)
    assert torch.equal(out, attention_ref(q, k, v, causal=True))
    assert launch_counts()["flash_attention"] == before


@pytest.mark.parametrize("case", ["head_dim", "dtype", "layout", "group",
                                  "window", "stride_alignment"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    q, k, v = _torch(_inputs(0, 1, 4, 2, 64, 64, 32), "float32")
    kw = dict(causal=True)
    err = ValueError
    if case == "head_dim":
        q, k, v = _torch(_inputs(0, 1, 4, 2, 64, 64, 48), "float32")
    elif case == "dtype":
        q, k, v = q.half(), k.half(), v.half()
        err = TypeError
    elif case == "layout":  # D not the unit-stride dimension
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "stride_alignment":  # rows 33 floats apart: not 16 bytes
        buf = torch.zeros(4 * 64 * 33)
        q = buf.as_strided((1, 4, 64, 32), (4 * 64 * 33, 64 * 33, 33, 1))
    elif case == "group":
        q, k, v = _torch(_inputs(0, 1, 3, 2, 64, 64, 32), "float32")
    else:
        kw["window"] = 0
    with pytest.raises(err):
        flash_attention(q, k, v, **kw)


def _bshd(seed, b, h, kv, s, d, dtype):
    """q, k, v as the model holds them, (B,S,heads,D) contiguous."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, s, n, d),
                                                 dtype=np.float32))
            .to(getattr(torch, dtype)) for n in (h, kv, kv)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal,window", [
    ((2, 4, 2, 128, 64), True, None), ((1, 14, 2, 200, 64), True, 64),
    ((1, 8, 1, 96, 128), False, None), ((2, 4, 2, 80, 80), True, 32),
])
def test_wrapper_takes_transposed_views(shape, causal, window, dtype):
    """(B,S,H,D) tensors passed as (B,H,S,D) views, without a copy, give
    the result of the same values made contiguous."""
    b, h, kv, s, d = shape
    q, k, v = _bshd(sum(shape), b, h, kv, s, d, dtype)
    views = [t.transpose(1, 2) for t in (q, k, v)]
    out = flash_attention(*views, causal=causal, window=window)
    want = flash_attention(*[t.contiguous() for t in views], causal=causal,
                           window=window)
    assert out.shape == (b, h, s, d) and out.dtype == q.dtype
    assert torch.equal(out, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,window", [
    ((2, 4, 2, 128, 64), None), ((1, 14, 2, 256, 64), 128),
    ((1, 8, 2, 128, 128), None), ((1, 4, 2, 128, 80), 64),
])
def test_model_kernel_views_match_jax(shape, window, dtype):
    """The model's kernel branch (``kernel_attention``: the (B,S,H,D)
    tensors handed to the wrapper as transposed views) against the JAX
    package's multihead_attention through its Pallas kernel (interpret
    mode) and its plain path, and against the port's plain path."""
    b, h, kv, s, d = shape
    q, k, v = _bshd(sum(shape) + 1, b, h, kv, s, d, dtype)
    pos = torch.arange(s)
    port = kernel_attention(q, k, v, causal=True, window=window)
    plain = multihead_attention(q, k, v, q_pos=pos, k_pos=pos, causal=True,
                                window=window)
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))
                  for t in (q, k, v))
    jpos = jnp.arange(s)
    for use_pallas in (True, False):
        ref = jax_mha(jq, jk, jv, q_pos=jpos, k_pos=jpos, causal=True,
                      window=window, use_pallas=use_pallas)
        np.testing.assert_allclose(_np(port), _np(ref), **TOL[dtype])
    np.testing.assert_allclose(_np(port), _np(plain), **TOL[dtype])


@pytest.mark.parametrize("shape,perm,want", [
    ((2, 4, 64, 32), (0, 1, 2, 3), (8192, 2048, 32)),   # contiguous
    ((2, 64, 4, 32), (0, 2, 1, 3), (8192, 32, 128)),    # (B,S,H,D) view
    ((1, 64, 4, 80), (0, 2, 1, 3), (20480, 80, 320)),   # B = 1: the span
    ((2, 1, 64, 64), (0, 1, 2, 3), (4096, 8192, 64)),   # one head
])
def test_kernel_strides(shape, perm, want):
    """Strides handed to the kernel: the tensor's own, except that a
    dimension of size 1 (never stepped) gets the span of the others."""
    t = torch.zeros(shape).permute(*perm)
    assert kernel_strides(t) == want


# the card tests' sweep (tests/test_torch_cuda.py:37-40): group size 7,
# head dims 32 and 80, a ragged length, Sq > Sk with rows that keep no key
BWD_SHAPES = [(1, 2, 2, 128, 128, 64), (2, 4, 2, 256, 256, 64),
              (1, 8, 1, 256, 512, 128), (1, 14, 2, 128, 128, 64),
              (1, 4, 2, 128, 128, 80), (2, 4, 2, 200, 200, 32),
              (1, 4, 2, 300, 100, 64)]
BWD_MASKS = [(True, None), (False, None), (True, 128), (True, 32)]


def _f64(seed, shape):
    q, k, v = (torch.from_numpy(a).double()
               for a in _inputs(seed, *shape))
    do = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        q.shape))
    return q, k, v, do


@pytest.mark.parametrize("shape", BWD_SHAPES)
@pytest.mark.parametrize("causal,window", BWD_MASKS)
def test_plain_backward_matches_autograd(shape, causal, window):
    """``attention_bwd_ref`` (P from the row statistics, keyless rows as
    P = 1/Sk with dS = 0) and ``attention_lse_ref`` against torch.autograd
    of ``attention_ref``, all in f64: within 1e-10.  The statistics are
    the log-sum-exp of the masked scores, +inf exactly on the rows that
    keep no key."""
    q, k, v, do = _f64(sum(shape), shape)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = attention_ref(*leaves, causal=causal, window=window)
    o.backward(do)
    lse = attention_lse_ref(q, k, causal=causal, window=window)
    grads = attention_bwd_ref(q, k, v, o.detach(), lse, do, causal=causal,
                              window=window)
    for got, t in zip(grads, leaves):
        np.testing.assert_allclose(got.numpy(), t.grad.numpy(), atol=1e-10,
                                   rtol=1e-10)
    b, h, sq, d = q.shape
    qpos, kpos = np.arange(sq)[:, None], np.arange(k.shape[2])[None, :]
    keep = np.ones((sq, k.shape[2]), bool)
    if causal:
        keep &= qpos >= kpos
    if window is not None:
        keep &= qpos - kpos < window
    keyless = ~keep.any(1)
    assert lse.shape == (b, h, sq)
    assert np.array_equal(np.isinf(lse.numpy()).all((0, 1)), keyless)
    s = np.einsum("bkgqd,bksd->bkgqs",
                  q.numpy().reshape(b, k.shape[1], -1, sq, d), k.numpy())
    s = np.where(keep, s / np.sqrt(d), -np.inf).reshape(b, h, sq, -1)
    want = np.log(np.exp(s).sum(-1))
    np.testing.assert_allclose(lse.numpy()[..., ~keyless],
                               want[..., ~keyless], atol=1e-10, rtol=1e-10)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal,window", [
    ((2, 14, 2, 64, 64, 64), True, None), ((1, 4, 2, 90, 40, 32), True, 16),
    ((1, 8, 1, 48, 80, 128), False, 24)])
def test_function_on_cpu_matches_plain_autograd(shape, causal, window,
                                                dtype):
    """``FlashAttention`` on CPU tensors (its forward the plain version
    with statistics, its backward ``attention_bwd_ref``) on the model's
    transposed views, directly and under torch.utils.checkpoint, against
    autograd of ``attention_ref``; gradients in the inputs' strides."""
    b, h, kv, sq, sk, d = shape
    rng = np.random.default_rng(sum(shape))
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (b, s, n, d), dtype=np.float32)).to(dt).transpose(1, 2)
        for n, s in ((h, sq), (kv, sk), (kv, sk)))
    do = torch.from_numpy(rng.standard_normal((b, h, sq, d),
                                              dtype=np.float32)).to(dt)

    def grads(fn):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves)
        out.backward(do)
        for t in leaves:  # the layout; a dimension of size 1 is not stepped
            assert [st for st, n in zip(t.grad.stride(), t.shape) if n > 1] \
                == [st for st, n in zip(t.stride(), t.shape) if n > 1]
        return out.detach(), [t.grad for t in leaves]

    o_ref, g_ref = grads(lambda *a: attention_ref(*a, causal=causal,
                                                  window=window))
    o_fn, g_fn = grads(lambda *a: FlashAttention.apply(*a, causal, window))
    o_ck, g_ck = grads(lambda *a: torch.utils.checkpoint.checkpoint(
        FlashAttention.apply, *a, causal, window, use_reentrant=False))
    tol = TOL[dtype]
    for got in (o_fn, o_ck):
        np.testing.assert_allclose(_np(got), _np(o_ref), **tol)
    for g in (g_fn, g_ck):
        for got, want in zip(g, g_ref):
            np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_stats_and_backward_wrappers_on_cpu():
    """On CPU tensors ``flash_attention_stats`` is (attention_ref,
    attention_lse_ref) and ``flash_attention_bwd`` is attention_bwd_ref,
    launching nothing; a statistics tensor of the wrong shape, dtype or
    layout, and an output gradient of another dtype, are refused."""
    q, k, v = _torch(_inputs(3, 1, 4, 2, 64, 64, 32), "float32")
    do = torch.ones_like(q)
    before = launch_counts()
    o, lse = flash_attention_stats(q, k, v, causal=True, window=16)
    assert torch.equal(o, attention_ref(q, k, v, causal=True, window=16))
    assert torch.equal(lse, attention_lse_ref(q, k, causal=True, window=16))
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=True, window=16)
    want = attention_bwd_ref(q, k, v, o, lse, do, causal=True, window=16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert launch_counts() == before
    for bad in (lse[:, :2], lse.double(), lse.transpose(1, 2)):
        with pytest.raises(ValueError):
            flash_attention_bwd(q, k, v, o, bad, do, causal=True)
    with pytest.raises(TypeError):
        flash_attention_bwd(q, k, v, o, lse, do.bfloat16(), causal=True)
