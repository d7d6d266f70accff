"""The port's SSD scan (K6's plain version and wrapper) and Mamba2 block
against the JAX package, at small size on the CPU: the same numpy inputs
through both sides.  Ports of tests/test_kernels.py::test_ssd_scan_sweep and
::test_ssd_scan_state_continuity, plus ssd_chunked, mamba_forward and
mamba_decode with the JAX package's weights."""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_scan_ref
from repro.models import ssm as jssm
from repro_torch.configs import smoke_config
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
from repro_torch.kernels.ssd_scan.ref import (KERNEL_CHUNK, ssd_scan_staged,
                                              tf32_round)
from repro_torch.models import ssm as tssm

# tests/test_kernels.py:53-58
SWEEP = [(1, 2, 256, 64, 32, 64), (2, 4, 512, 64, 128, 128),
         (1, 2, 256, 128, 64, 256)]


def _inputs(b, h, l, p, n, seed=0, model_decay=False):
    """The distributions of tests/test_kernels.py:60-68, drawn with numpy;
    with ``model_decay`` the decays of mamba2 (a = -linspace(1, 16, H))."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, l, p), dtype=np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, h, l), dtype=np.float32)))
    a = -np.exp(rng.standard_normal(h, dtype=np.float32))
    if model_decay:
        a = -np.linspace(1.0, 16.0, h, dtype=np.float32)
    bb = rng.standard_normal((b, l, n), dtype=np.float32) * 0.3
    cc = rng.standard_normal((b, l, n), dtype=np.float32) * 0.3
    return x, dt.astype(np.float32), a, bb, cc


def _assert_scaled_close(out, ref, dtype):
    """The tolerance of tests/test_kernels.py:72-76: errors scaled by
    max(|ref|, 1)."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(
        out / scale, ref / scale,
        atol=3e-2 if dtype == "bfloat16" else 3e-5, rtol=3e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,l,p,n,chunk", SWEEP)
def test_ssd_scan_plain_matches_jax(b, h, l, p, n, chunk, dtype):
    """The plain version against the JAX oracle and the interpret-mode
    Pallas kernel, on the same (bf16-rounded where asked) inputs."""
    x, dt, a, bb, cc = _inputs(b, h, l, p, n, seed=l + p)
    jx, jb, jc = (jnp.asarray(v).astype(dtype) for v in (x, bb, cc))
    tx, tb, tc = (torch.from_numpy(v).to(getattr(torch, dtype))
                  for v in (x, bb, cc))
    out = ssd_scan(tx, torch.from_numpy(dt), torch.from_numpy(a), tb, tc,
                   chunk=chunk)
    assert out.dtype == getattr(torch, dtype) and out.shape == tx.shape
    jdt, ja = jnp.asarray(dt), jnp.asarray(a)
    _assert_scaled_close(out.float(), jax_ssd_scan_ref(
        jx, jdt, ja, jb, jc, chunk=chunk), dtype)
    _assert_scaled_close(out.float(), jax_ssd_scan(
        jx, jdt, ja, jb, jc, chunk=chunk, interpret=True), dtype)


# the sweep, a ragged L (200: one short chunk of the kernel's 64; 1000
# against the caller's chunk of 200), and a long scan of 32 chunks of 64
STAGED = [(1, 2, 256, 64, 32, 64), (2, 4, 512, 64, 128, 128),
          (1, 2, 256, 128, 64, 256), (1, 3, 200, 32, 16, 256),
          (2, 3, 1000, 64, 64, 200), (1, 2, 2048, 32, 16, 256)]


@pytest.mark.parametrize("product", ["f32", "3xtf32"])
@pytest.mark.parametrize("model_decay", [False, True])
@pytest.mark.parametrize("b,h,l,p,n,chunk", STAGED)
def test_ssd_scan_staged_matches_jax(b, h, l, p, n, chunk, model_decay,
                                     product):
    """The kernel's three stages in plain PyTorch (chunks of 64 whatever
    the caller's chunk; products in f32 or split 3xTF32 as on the tensor
    cores) against the JAX oracle and the interpret-mode Pallas kernel at
    the caller's chunk, within the f32 scaled tolerance."""
    x, dt, a, bb, cc = _inputs(b, h, l, p, n, seed=l + p + n,
                               model_decay=model_decay)
    out = ssd_scan_staged(*(torch.from_numpy(v) for v in (x, dt, a, bb, cc)),
                          product=product)
    assert out.dtype == torch.float32 and out.shape == x.shape
    assert bool(torch.isfinite(out).all())
    jargs = [jnp.asarray(v) for v in (x, dt, a, bb, cc)]
    _assert_scaled_close(out, jax_ssd_scan_ref(*jargs, chunk=chunk),
                         "float32")
    _assert_scaled_close(out, jax_ssd_scan(*jargs, chunk=chunk,
                                           interpret=True), "float32")


def _recurrence_f64(x, dt, a, b, c):
    """y_t = C_t h_t with h_t = h_{t-1} exp(dt_t a) + x_t (dt_t B_t), one row
    at a time in f64: the scan without chunks."""
    x, dt, a, b, c = (torch.from_numpy(v).double() for v in (x, dt, a, b, c))
    bsz, h, l, p = x.shape
    state = torch.zeros(bsz, h, p, b.shape[-1], dtype=torch.float64)
    ys = []
    for t in range(l):
        decay = torch.exp(dt[:, :, t] * a)[..., None, None]
        state = state * decay + x[:, :, t, :, None] * \
            (dt[:, :, t, None, None] * b[:, None, t, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", state, c[:, t]))
    return torch.stack(ys, dim=2)


def test_ssd_scan_ref_stays_near_f64():
    """The plain version, the yardstick of the kernel on the card, at the
    model's decays and chunk 256 is within 3e-6 of the scan's scale of an
    f64 recurrence (its segment sums are taken one by one; as differences
    of one cumsum they lose up to 2.9e-5, tools/ssd_scan_accuracy.py), so
    that the kernel's 3e-5 tolerance measures the kernel."""
    x, dt, a, bb, cc = _inputs(1, 6, 512, 64, 128, seed=11, model_decay=True)
    ref = _recurrence_f64(x, dt, a, bb, cc)
    out = ssd_scan_ref(*(torch.from_numpy(v) for v in (x, dt, a, bb, cc)),
                       chunk=256)
    err = float((out.double() - ref).abs().max()) / max(
        float(ref.abs().max()), 1.0)
    assert err <= 3e-6, err


def test_tf32_round_masks_thirteen_bits():
    v = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, -1.0 - 2 ** -11,
                      0.1, 1e-30])
    r = tf32_round(v)
    assert bool(((r.view(torch.int32) & 0x1FFF) == 0).all())
    # half away from zero at the 11th bit; 10 mantissa bits kept
    assert r.tolist()[:4] == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10,
                              -1.0 - 2 ** -10]
    assert bool(((r - v).abs() <= v.abs() * 2 ** -11).all())


def test_split_tf32_products_keep_f32_accuracy():
    """At a mamba2 head's shape (P 64, N 128) and the model's decays, the
    staged scan with 3xTF32 products is within the kernel tolerance
    (|err| / max(|ref|, 1) <= 3e-5) of an f64 recurrence, as with f32
    products; one TF32 product is not (~5e-4), so the kernel splits every
    product."""
    x, dt, a, bb, cc = _inputs(1, 6, 512, 64, 128, seed=7, model_decay=True)
    ref = _recurrence_f64(x, dt, a, bb, cc)
    scale = max(float(ref.abs().max()), 1.0)
    args = [torch.from_numpy(v) for v in (x, dt, a, bb, cc)]
    err = {product: float((ssd_scan_staged(*args, q=KERNEL_CHUNK,
                                           product=product).double()
                           - ref).abs().max()) / scale
           for product in ("f32", "3xtf32", "tf32")}
    assert err["f32"] <= 3e-5 and err["3xtf32"] <= 3e-5, err
    assert err["3xtf32"] <= 2 * err["f32"] + 1e-6, err
    assert err["tf32"] > 1e-4, err


def test_ssd_scan_state_continuity():
    """Port of test_kernels.py::test_ssd_scan_state_continuity: scanning
    two chunks differs from scanning the halves independently, so the state
    crosses the chunk boundary."""
    x, dt, a, bb, cc = (torch.from_numpy(v)
                        for v in _inputs(1, 1, 256, 32, 16, seed=0))
    joint = ssd_scan(x, dt, a, bb, cc, chunk=128)
    h1 = ssd_scan(x[:, :, :128], dt[:, :, :128], a, bb[:, :128].contiguous(),
                  cc[:, :128].contiguous(), chunk=128)
    h2 = ssd_scan(x[:, :, 128:], dt[:, :, 128:], a, bb[:, 128:].contiguous(),
                  cc[:, 128:].contiguous(), chunk=128)
    assert np.allclose(joint[:, :, :128].numpy(), h1.numpy(), atol=1e-5)
    assert not np.allclose(joint[:, :, 128:].numpy(), h2.numpy(), atol=1e-3)


def test_ssd_chunked_matches_jax_with_state():
    """The model-level scan, with an initial state and a final state, at a
    decay as fast as the model's (a down to -16): no NaN from exp above the
    diagonal."""
    rng = np.random.default_rng(1)
    b, l, h, p, n = 2, 128, 3, 16, 8
    x = rng.standard_normal((b, l, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h), dtype=np.float32)))
    a = -np.linspace(1.0, 16.0, h, dtype=np.float32)
    bb = rng.standard_normal((b, l, n), dtype=np.float32)
    cc = rng.standard_normal((b, l, n), dtype=np.float32)
    h0 = rng.standard_normal((b, h, p, n), dtype=np.float32)
    y, hf = tssm.ssd_chunked(*(torch.from_numpy(v) for v in
                               (x, dt, a, bb, cc)), chunk=32,
                             h0=torch.from_numpy(h0))
    jy, jhf = jssm.ssd_chunked(*(jnp.asarray(v) for v in (x, dt, a, bb, cc)),
                               chunk=32, h0=jnp.asarray(h0))
    assert bool(torch.isfinite(y).all())
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(hf.numpy(), np.asarray(jhf), atol=1e-4,
                               rtol=1e-4)


def test_chunk_contract_raises_where_jax_asserts():
    x, dt, a, bb, cc = (torch.from_numpy(v)
                        for v in _inputs(1, 2, 384, 32, 16))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_scan(x, dt, a, bb, cc, chunk=256)
    xm, dtm = x.movedim(1, 2), dt.movedim(1, 2)  # the model's layout
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tssm.ssd_chunked(xm, dtm, a, bb, cc, chunk=256)
    with pytest.raises(AssertionError):
        jssm.ssd_chunked(*(jnp.asarray(v.numpy())
                           for v in (xm, dtm, a, bb, cc)), chunk=256)
    cfg = smoke_config("mamba2-130m")
    params = tssm.init_mamba(cfg, torch.float32, "cpu",
                             torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tssm.mamba_forward(params, cfg, torch.zeros(1, 300, cfg.d_model))


def test_ssd_scan_wrapper_guards():
    x, dt, a, bb, cc = (torch.from_numpy(v)
                        for v in _inputs(1, 2, 64, 32, 16))
    with pytest.raises(ValueError, match="not supported"):
        ssd_scan(x[..., :16], dt, a, bb, cc)
    with pytest.raises(TypeError, match="f32 dt"):
        ssd_scan(x, dt.double(), a, bb, cc)
    with pytest.raises(TypeError, match="all f32 or all bf16"):
        ssd_scan(x, dt, a, bb.bfloat16(), cc)
    with pytest.raises(ValueError, match="unit stride"):
        ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, a, bb,
                 cc)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x, dt, a, bb.transpose(1, 2).contiguous().transpose(1, 2),
                 cc)
    # strided views of the model's (B,L,H,P) layout are taken without copy
    out = ssd_scan(x.movedim(1, 2).contiguous().movedim(2, 1),
                   dt.movedim(1, 2).contiguous().movedim(2, 1), a, bb, cc)
    np.testing.assert_allclose(out.numpy(),
                               ssd_scan_ref(x, dt, a, bb, cc).numpy(),
                               atol=1e-6)


def _mamba_both(seed=0):
    cfg = smoke_config("mamba2-130m")
    jcfg = jax_smoke_config("mamba2-130m")
    jp = jssm.init_mamba(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = jax.tree.map(lambda v: torch.from_numpy(np.array(v)), jp)
    return cfg, jcfg, tp, jp


@pytest.mark.parametrize("seq", [64, 512])
def test_mamba_forward_matches_jax(seq):
    """The block at L <= chunk and at L = 2 chunks of 256."""
    cfg, jcfg, tp, jp = _mamba_both()
    x = np.random.default_rng(seq).standard_normal(
        (2, seq, cfg.d_model), dtype=np.float32)
    out = tssm.mamba_forward(tp, cfg, torch.from_numpy(x))
    ref = jssm.mamba_forward(jp, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


def test_mamba_decode_matches_jax_and_forward():
    """Step by step, the recurrent decode equals the JAX decode (output and
    every cache leaf) and the chunked forward at each position."""
    cfg, jcfg, tp, jp = _mamba_both(1)
    b, s = 2, 12
    x = np.random.default_rng(2).standard_normal((b, s, cfg.d_model),
                                                 dtype=np.float32)
    full = tssm.mamba_forward(tp, cfg, torch.from_numpy(x))
    cache = tssm.init_mamba_cache(cfg, b, torch.float32, "cpu")
    jcache = jssm.init_mamba_cache(jcfg, b, jnp.float32)
    for t in range(s):
        out, cache = tssm.mamba_decode(tp, cfg, torch.from_numpy(x[:, t:t + 1]),
                                       cache)
        jout, jcache = jssm.mamba_decode(jp, jcfg, jnp.asarray(x[:, t:t + 1]),
                                         jcache)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(out[:, 0].numpy(), full[:, t].numpy(),
                                   atol=1e-4, rtol=1e-4)
    for k in jcache:
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   atol=1e-5, rtol=1e-5)


def test_conv_step_keeps_cache_dtype():
    """_conv_step concatenates in the cache's dtype and sums in f32
    (repro/models/ssm.py:181-186)."""
    cfg = smoke_config("mamba2-130m")
    cache = tssm.init_mamba_cache(cfg, 2, torch.bfloat16, "cpu")
    assert cache["conv_x"].dtype == torch.bfloat16
    assert cache["ssm"].dtype == torch.float32
    new = torch.randn(2, cfg.ssm_state)
    w = torch.randn(cfg.ssm_conv_kernel, cfg.ssm_state)
    out = tssm._conv_step(cache["conv_b"], new, w, torch.zeros(cfg.ssm_state))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(cache["conv_b"][:, -1].float().numpy(),
                                  new.bfloat16().float().numpy())
