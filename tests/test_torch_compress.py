"""The port's compression kernels (K2a, K2b, K3, K4: plain versions and
wrappers) and gradient codecs against the JAX package, on the CPU: the same
numpy inputs through both sides.  Ports of tests/test_compress.py:42-232
(codec API, error feedback, Pallas kernels vs references), plus bit-level
parity with the JAX references and the interpret-mode Pallas kernels.

Stochastic rounding is compared by feeding the same numpy uint32 bits to
both sides (``jax.random`` is not re-implemented).  The low-rank codec is
compared with JAX's own Q0 put into ``LowRankCodec._test_matrix``."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import SPECS as JAX_SPECS
from repro.compress import get_codec as jax_get_codec
from repro.compress.lowrank import _matrix_shape as jax_matrix_shape
from repro.kernels.compress import ref as jref
from repro.kernels.compress.kernel import (dequantize_kernel as jax_deq_kernel,
                                           quantize_kernel as jax_q_kernel)
from repro.kernels.compress.ops import (dequantize as jax_dequantize,
                                        lowrank_project as jax_lowrank_project,
                                        quantize as jax_quantize,
                                        sparsify as jax_sparsify)
from repro_torch.compress import (SPECS, LowRankCodec, QuantCodec,
                                  base_algorithm, codec_spec, get_codec,
                                  split_algorithm)
from repro_torch.compress.lowrank import _matrix_shape
from repro_torch.kernels.compress import ops, ref


def _np(t):
    return t.detach().cpu().numpy()


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _uint32_bits(shape, seed):
    return np.random.default_rng(seed).integers(
        0, 2 ** 32, shape, dtype=np.uint32)


def _jax_q0(n, r):
    """The JAX codec's test matrix (repro/compress/lowrank.py:49)."""
    return torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(r + n % 9973), (n, r))))


@pytest.fixture
def jax_q0(monkeypatch):
    monkeypatch.setattr(LowRankCodec, "_test_matrix",
                        lambda self, n, r, device: _jax_q0(n, r).to(device))


# ---------------------------------------------------------------------------
# codec API: round trips, wire accounting, spec consistency
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,max_err", [
    ("q8", 0.02), ("q4", 0.25), ("topk", 1.0), ("lowrank", 1.0),
])
def test_codec_roundtrip_error_within_spec_regime(name, max_err):
    x = torch.from_numpy(_normal((64, 32), 0))
    codec = get_codec(name)
    enc, _ = codec.encode(x, codec.init_state(x))
    dec = codec.decode(enc)
    assert dec.shape == x.shape
    rel = float((dec - x).norm() / x.norm())
    assert rel <= max_err, (name, rel)
    assert enc.wire_bytes < x.numel() * 4
    big = torch.from_numpy(_normal((512, 512), 1))
    enc_big, _ = codec.encode(big)
    assert enc_big.wire_bytes <= \
        big.numel() * 4 * codec_spec(name).wire_ratio * 2


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(64, 32), (1001,), (3, 5, 7)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_codec_wire_arrays_equal_jax(bits, shape, dtype):
    """q8/q4 codec: the wire bytes (q or its nibble packing), the scale and
    the decode are bit-equal to the JAX codec's on the same input."""
    x = _normal(shape, 2)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jc, tc = jax_get_codec(f"q{bits}"), get_codec(f"q{bits}")
    jenc, _ = jc.encode(jx)
    tenc, _ = tc.encode(tx)
    assert tenc.wire_bytes == jenc.wire_bytes
    for t, j in zip(tenc.arrays, jenc.arrays):
        np.testing.assert_array_equal(_np(t), np.asarray(j))
    np.testing.assert_array_equal(_np(tc.decode(tenc)),
                                  np.asarray(jc.decode(jenc)))


def test_quantized_codec_decode_is_unbiased_with_stochastic_rounding():
    x = torch.from_numpy(_normal((512,), 1))
    codec = QuantCodec(bits=8, stochastic=True)
    dec = torch.stack([
        codec.decode(codec.encode(
            x, generator=torch.Generator().manual_seed(i))[0])
        for i in range(200)]).mean(0)
    det = get_codec("q8").decode(get_codec("q8").encode(x)[0])
    # the 200-sample mean must beat a single deterministic rounding
    assert float((dec - x).abs().max()) < float((det - x).abs().max())
    # a stochastic codec refuses to silently degrade to biased rounding
    with pytest.raises(ValueError):
        codec.encode(x)


def test_q4_payload_is_nibble_packed():
    """The q4 wire claim is real (half of q8's payload bytes) and the
    packing is the JAX package's, bit for bit."""
    x = torch.from_numpy(_normal((1001,), 9))
    e8, _ = get_codec("q8").encode(x)
    e4, _ = get_codec("q4").encode(x)
    assert e4.arrays[0].numel() == math.ceil(e8.arrays[0].numel() / 2)
    assert e4.arrays[0].dtype == torch.uint8
    assert get_codec("q4").decode(e4).shape == x.shape
    q = torch.arange(-7, 8, dtype=torch.int8)
    np.testing.assert_array_equal(_np(ref.unpack_int4(ref.pack_int4(q), 15)),
                                  _np(q))
    qs = np.random.default_rng(3).integers(-7, 8, 37).astype(np.int8)
    np.testing.assert_array_equal(
        _np(ref.pack_int4(torch.from_numpy(qs))),
        np.asarray(jref.pack_int4(jnp.asarray(qs))))


def test_topk_codec_keeps_largest_magnitudes():
    # distinct magnitudes, alternating signs, shuffled deterministically
    mags = np.arange(1.0, 65.0, dtype=np.float32) * \
        np.where(np.arange(64) % 2 == 0, 1, -1).astype(np.float32)
    x = torch.from_numpy(np.random.default_rng(5).permutation(mags))
    codec = get_codec("topk")
    dec = codec.decode(codec.encode(x)[0])
    kept = np.nonzero(_np(dec))[0]
    k = max(1, int(x.numel() * codec.fraction))
    assert len(kept) == k
    top = np.argsort(-np.abs(_np(x)))[:k]
    assert set(kept) == set(top)


@pytest.mark.parametrize("shape", [(64, 32), (1000,), (4, 3, 50)])
def test_topk_codec_decode_and_residual_equal_jax(shape):
    """Two error-feedback steps: decoded tensors and carried residuals equal
    the JAX codec's (random inputs: no tied magnitudes)."""
    x = _normal(shape, 4)
    jc, tc = jax_get_codec("topk"), get_codec("topk")
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jst, tst = jc.init_state(jx), tc.init_state(tx)
    for _ in range(2):
        jenc, jst = jc.encode(jx, jst)
        tenc, tst = tc.encode(tx, tst)
        assert tenc.wire_bytes == jenc.wire_bytes
        np.testing.assert_array_equal(_np(tc.decode(tenc)),
                                      np.asarray(jc.decode(jenc)))
        np.testing.assert_array_equal(_np(tst), np.asarray(jst))


def test_lowrank_codec_exact_on_low_rank_input():
    u = _normal((40, 3), 2)
    v = _normal((3, 30), 3)
    x = torch.from_numpy(u @ v)  # true rank 3 < codec rank 4
    codec = get_codec("lowrank")
    dec = codec.decode(codec.encode(x)[0])
    np.testing.assert_allclose(_np(dec), _np(x), atol=1e-3)


@pytest.mark.parametrize("shape", [(64, 32), (40, 30), (128,), (3, 5, 7),
                                   (97,)])
def test_lowrank_codec_matches_jax_with_jax_q0(jax_q0, shape):
    """With JAX's Q0, the decode (P P^T M, independent of QR column signs)
    and the residual match the JAX codec within 1e-5, over two
    error-feedback steps; the wire bytes are equal."""
    x = _normal(shape, 6)
    jc, tc = jax_get_codec("lowrank"), get_codec("lowrank")
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jst, tst = jc.init_state(jx), tc.init_state(tx)
    for _ in range(2):
        jenc, jst = jc.encode(jx, jst)
        tenc, tst = tc.encode(tx, tst)
        assert tenc.wire_bytes == jenc.wire_bytes
        assert [tuple(a.shape) for a in tenc.arrays] == \
            [a.shape for a in jenc.arrays]
        np.testing.assert_allclose(_np(tc.decode(tenc)),
                                   np.asarray(jc.decode(jenc)),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(tst), np.asarray(jst), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("shape", [(12,), (97,), (64, 32), (3, 5, 7),
                                   (36,), (1,)])
def test_matrix_shape_matches_jax(shape):
    assert _matrix_shape(shape) == jax_matrix_shape(shape)


def test_specs_equal_jax():
    """SPECS is a copy of the JAX package's, field by field."""
    assert list(SPECS) == list(JAX_SPECS)
    for name, spec in SPECS.items():
        assert dataclasses.asdict(spec) == \
            dataclasses.asdict(JAX_SPECS[name]), name
        assert spec.effective_error == JAX_SPECS[name].effective_error


def test_specs_effective_error_orders_budgets():
    assert SPECS["q8"].effective_error < SPECS["q4"].effective_error \
        < SPECS["lowrank"].effective_error
    for name, spec in SPECS.items():
        assert 0 < spec.wire_ratio < 1 and spec.passes >= 1, name
        if spec.error_feedback:
            assert spec.effective_error == spec.rel_error * 0.5


def test_algorithm_name_parsing():
    assert split_algorithm("ring+q8") == ("ring", "q8")
    assert split_algorithm("ring") == ("ring", None)
    assert base_algorithm("ps+topk") == "atp"
    assert base_algorithm("hierarchical+q8") == "hierarchical"
    with pytest.raises(KeyError):
        codec_spec("zstd")


# ---------------------------------------------------------------------------
# error feedback
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 7, 10])
def test_error_feedback_bounds_accumulated_bias(seed):
    """Port of the hypothesis property (seeds 0-10 there): without error
    feedback the accumulated bias grows linearly in T; with the residual it
    converges to a bounded fixed point."""
    x = torch.from_numpy(_normal((256,), seed))
    codec = get_codec("topk")
    t_short, t_long = 25, 100

    def bias(steps, with_ef):
        state = codec.init_state(x)
        acc = torch.zeros_like(x)
        for _ in range(steps):
            enc, new_state = codec.encode(x, state)
            if with_ef:
                state = new_state  # else: drop the residual every step
            acc = acc + codec.decode(enc)
        return float((acc - steps * x).norm())

    ef_s, ef_l = bias(t_short, True), bias(t_long, True)
    raw_s, raw_l = bias(t_short, False), bias(t_long, False)
    assert raw_l == pytest.approx(raw_s * t_long / t_short, rel=1e-3)
    assert ef_l < raw_l / 2
    assert ef_l < ef_s * 1.5


def test_error_feedback_residual_equals_accumulated_bias():
    """After any number of steps the carried residual IS exactly the total
    un-transmitted mass."""
    x = torch.from_numpy(_normal((128,), 7))
    codec = get_codec("lowrank")
    state = codec.init_state(x)
    acc = torch.zeros_like(x)
    for _ in range(5):
        enc, state = codec.encode(x, state)
        acc = acc + codec.decode(enc)
    np.testing.assert_allclose(_np(5 * x - acc), _np(state.reshape(x.shape)),
                               atol=1e-4)


# ---------------------------------------------------------------------------
# kernels' plain versions vs the JAX references and interpret-mode kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(256,), (8, 256), (3, 100)])
def test_quantize_matches_jax_kernel_and_ref(bits, shape):
    """Payload-level quantize/dequantize against the JAX package's (the
    interpret-mode Pallas kernels) and its per-row reference.  q is
    bit-equal to both; scales and decode are bit-equal to the reference.
    The Pallas kernel's scale is absmax * (1/qmax) once XLA has rewritten
    the division by a constant, 1 ulp from the true quotient on some rows,
    so against the kernel the scales and decode hold within the JAX test's
    own rtol of 1e-6 (tests/test_compress.py:214-219); given the same q
    and scale, the JAX kernel's dequantize is bit-equal."""
    x = _normal(shape, 1)
    q, scales, orig = ops.quantize(torch.from_numpy(x), bits=bits)
    dec = ops.dequantize(q, scales, orig)
    jq, js, jorig = jax_quantize(jnp.asarray(x), bits=bits)
    np.testing.assert_array_equal(_np(q), np.asarray(jq))
    np.testing.assert_allclose(_np(scales), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(_np(dec), np.asarray(
        jax_dequantize(jq, js, jorig)), rtol=1e-6)
    np.testing.assert_array_equal(_np(dec), np.asarray(jax_dequantize(
        jnp.asarray(_np(q)), jnp.asarray(_np(scales)), jorig)))
    rows = np.asarray(jnp.pad(jnp.asarray(x).reshape(-1),
                              (0, q.numel() - x.size))).reshape(q.shape)
    q_ref, s_ref = jref.quantize_ref(jnp.asarray(rows), bits=bits,
                                     per_row=True)
    np.testing.assert_array_equal(_np(q), np.asarray(q_ref))
    np.testing.assert_array_equal(_np(scales), np.asarray(s_ref))
    dec_ref = jref.dequantize_ref(q_ref, s_ref).reshape(-1)[:x.size]
    np.testing.assert_array_equal(_np(dec).reshape(-1), np.asarray(dec_ref))
    qmax = 2 ** (bits - 1) - 1
    assert float(np.abs(_np(dec) - x).max()) <= float(np.abs(x).max()) / qmax


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(8, 256), (3, 100), (1, 1000)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stochastic_quantize_kernel_same_bits_matches_jax(bits, shape, dtype):
    """The same numpy uint32 bits into the port's quantize_kernel and the
    JAX package's.  The port computes the reference's function
    (``quantize_ref``: scale = max(absmax, 1e-30) / qmax, then x / scale),
    so q and scale are bit-equal to it; for the stochastic path, which
    ``quantize_ref`` draws from a key, to its formula evaluated in IEEE f32
    by numpy.  The interpret-mode Pallas kernel computes its scale as
    absmax * (1/qmax) (XLA rewrites the division by a constant), 1 ulp off
    on some rows: there q is bit-equal where the two scales agree and
    within one step elsewhere (bf16 inputs land exactly on a rounding
    boundary often enough to show it; ROADMAP Queue 3).  Dequantize is
    bit-equal to the JAX kernel's on the same q and scale."""
    x = _normal(shape, 8)
    bits_u32 = _uint32_bits(shape, 9)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    rand = torch.from_numpy(bits_u32.view(np.int32))
    x32 = np.asarray(jx.astype(jnp.float32))
    q_ref, s_ref = jref.quantize_ref(jx, bits=bits, per_row=True)
    qmax = np.float32(2 ** (bits - 1) - 1)
    u = (bits_u32 >> 8).astype(np.float32) * np.float32(2.0 ** -24)
    q_sto = np.clip(np.floor(x32 / np.asarray(s_ref) + u), -qmax,
                    qmax).astype(np.int8)
    for stochastic, want in ((True, q_sto), (False, np.asarray(q_ref))):
        q, s = ops.quantize_kernel(tx, rand if stochastic else None,
                                   bits=bits, stochastic=stochastic)
        np.testing.assert_array_equal(_np(q), want)
        np.testing.assert_array_equal(_np(s), np.asarray(s_ref))
        jq, js = jax_q_kernel(jx, jnp.asarray(bits_u32) if stochastic
                              else None, bits=bits, stochastic=stochastic,
                              bm=1, interpret=True)
        np.testing.assert_allclose(_np(s), np.asarray(js), rtol=1e-6)
        same = (_np(s) == np.asarray(js))[:, 0]
        np.testing.assert_array_equal(_np(q)[same], np.asarray(jq)[same])
        assert int(np.abs(_np(q).astype(int) - np.asarray(jq)).max()) <= 1
        np.testing.assert_array_equal(
            _np(ops.dequantize_kernel(q, s)),
            np.asarray(jax_deq_kernel(jnp.asarray(_np(q)),
                                      jnp.asarray(_np(s)), bm=1,
                                      interpret=True)))


def test_quantize_ref_per_tensor_matches_jax_at_scale():
    """The per-tensor scale path of the codecs and the ring (2^20 values):
    q bit-equal to JAX's quantize_ref for q8 and q4, rows of one."""
    x = _normal((2 ** 20,), 12) * 3
    for bits in (8, 4):
        q, s = ref.quantize_ref(torch.from_numpy(x), bits=bits)
        jq, js = jref.quantize_ref(jnp.asarray(x), bits=bits)
        np.testing.assert_array_equal(_np(q), np.asarray(jq))
        np.testing.assert_array_equal(_np(s), np.asarray(js))
        qk, sk = ops.quantize_kernel(torch.from_numpy(x).reshape(1, -1),
                                     bits=bits)
        np.testing.assert_array_equal(_np(qk).reshape(-1), np.asarray(jq))
        assert float(sk) == float(js)


def test_quantize_kernel_stochastic_is_unbiased():
    # values that do NOT land on integer steps after absmax scaling
    x = torch.linspace(-0.9994, 1.0, 256)
    decs = []
    for i in range(300):
        q, s, shape = ops.quantize(x, stochastic=True,
                                   generator=torch.Generator().manual_seed(i))
        decs.append(ops.dequantize(q, s, shape))
    mean = torch.stack(decs).mean(0)
    det = ops.dequantize(*ops.quantize(x))
    assert float((mean - x).abs().max()) < float((det - x).abs().max())


@pytest.mark.parametrize("shape", [(512,), (3, 100)])
def test_sparsify_matches_jax(shape):
    x = _normal(shape, 2)
    thresh = float(np.quantile(np.abs(x), 0.9))
    out = ops.sparsify(torch.from_numpy(x), thresh)
    np.testing.assert_array_equal(_np(out), np.asarray(
        jax_sparsify(jnp.asarray(x), thresh)))
    np.testing.assert_array_equal(_np(out), np.asarray(
        jref.sparsify_ref(jnp.asarray(x), thresh)))
    assert 0 < int((out != 0).sum()) < x.size


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1000,), (3, 333), (2, 5, 77), (257,)])
def test_sparsify_one_row_equals_padded_rows_and_jax(shape, dtype):
    """The payload-level sparsify passes x as one row with one threshold;
    at sizes that are no multiple of 256 it equals the zero-padded rows of
    256 (the JAX package's layout) bit for bit, and the JAX op with its
    Pallas kernel in interpret mode."""
    x = _normal(shape, sum(shape))
    thresh = float(np.quantile(np.abs(x), 0.8))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    out = ops.sparsify(tx, thresh)
    assert out.dtype == torch.float32 and tuple(out.shape) == shape
    rows, n = ops._as_rows(tx)
    padded = ops.sparsify_kernel(rows, torch.full((rows.shape[0], 1), thresh))
    assert torch.equal(out, padded.reshape(-1)[:n].reshape(shape))
    np.testing.assert_array_equal(_np(out), np.asarray(jax_sparsify(
        jnp.asarray(x).astype(dtype), thresh, interpret=True)))
    assert 0 < int((out != 0).sum()) < x.size


def test_sparsify_hands_the_kernel_one_row_view(monkeypatch):
    """No padded copy and no threshold per row: the kernel gets the
    payload's own storage as (1, numel) and a (1, 1) threshold."""
    seen = []

    def spy(x, t):
        seen.append((x, t))
        return ref.sparsify_ref(x, t)

    monkeypatch.setattr(ops, "sparsify_kernel", spy)
    x = torch.from_numpy(_normal((7, 301), 9))
    ops.sparsify(x, 0.5)
    (rows, t), = seen
    assert tuple(rows.shape) == (1, x.numel())
    assert rows.data_ptr() == x.data_ptr()
    assert tuple(t.shape) == (1, 1) and float(t) == 0.5


@pytest.mark.parametrize("m,k,n", [(128, 64, 4), (100, 37, 3), (5, 4, 96)])
def test_lowrank_project_matches_jax(m, k, n):
    a, b = _normal((m, k), 3), _normal((k, n), 4)
    out = ops.lowrank_project(torch.from_numpy(a), torch.from_numpy(b))
    assert out.dtype == torch.float32 and tuple(out.shape) == (m, n)
    np.testing.assert_allclose(_np(out), np.asarray(jref.matmul_ref(
        jnp.asarray(a), jnp.asarray(b))), rtol=1e-5, atol=1e-5)
    if m % 8 == 0:  # the JAX kernel tiles m exactly
        np.testing.assert_allclose(_np(out), np.asarray(jax_lowrank_project(
            jnp.asarray(a), jnp.asarray(b))), rtol=1e-5, atol=1e-5)
    # the transposed view, as LowRankCodec passes M^T
    at = ops.matmul_kernel(torch.from_numpy(a).T, torch.from_numpy(
        _normal((m, n), 5)))
    np.testing.assert_allclose(_np(at), a.T @ _normal((m, n), 5), rtol=1e-5,
                               atol=1e-5)
    # ... with P from QR, column-major, as LowRankCodec passes it
    p, _ = torch.linalg.qr(out)
    if p.shape[1] > 1:
        assert p.stride(0) == 1, p.stride()
    pt = ops.lowrank_project(torch.from_numpy(a).T, p)
    jp = jnp.asarray(_np(p))
    np.testing.assert_allclose(_np(pt), np.asarray(jref.matmul_ref(
        jnp.asarray(a).T, jp)), rtol=1e-5, atol=1e-5)
    if k % 8 == 0:  # the JAX kernel tiles the rows of M^T exactly
        np.testing.assert_allclose(_np(pt), np.asarray(jax_lowrank_project(
            jnp.asarray(a).T, jp)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("length", [48, 37, 1])
def test_wire_codec_matches_jax(bits, length):
    """The collectives' encode/decode through the kernel wrappers (their
    plain versions on CPU tensors): payload, scale and decode bit-equal to
    JAX's."""
    v = _normal((length,), 11) * 5
    jenc, jdec = jref.wire_codec(bits, length)
    jq, js = jenc(jnp.asarray(v))
    enc, dec = ops.wire_codec(bits, length)
    q, s = enc(torch.from_numpy(v))
    np.testing.assert_array_equal(_np(q), np.asarray(jq))
    np.testing.assert_array_equal(_np(s), np.asarray(js))
    np.testing.assert_array_equal(_np(dec(q, s)), np.asarray(jdec(jq, js)))


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.randn(4, 8)
    with pytest.raises(TypeError):
        ops.quantize_kernel(x.double())
    with pytest.raises(ValueError):
        ops.quantize_kernel(x.reshape(-1))           # not 2D
    with pytest.raises(ValueError):
        ops.quantize_kernel(x.T)                     # not contiguous
    with pytest.raises(ValueError):
        ops.quantize_kernel(x, bits=2)
    with pytest.raises(ValueError):
        ops.quantize_kernel(x, stochastic=True)      # no bits
    with pytest.raises(ValueError):
        ops.quantize_kernel(x, torch.zeros(4, 7, dtype=torch.int32),
                            stochastic=True)
    with pytest.raises(TypeError):
        ops.dequantize_kernel(x, torch.ones(4, 1))   # q not int8
    with pytest.raises(ValueError):
        ops.dequantize_kernel(torch.zeros(4, 8, dtype=torch.int8),
                              torch.ones(4))         # scale not (m, 1)
    with pytest.raises(ValueError):
        ops.sparsify_kernel(x, torch.ones(3, 1))
    with pytest.raises(ValueError):
        ops.matmul_kernel(x, torch.randn(7, 2))
    with pytest.raises(TypeError):
        ops.matmul_kernel(x, torch.randn(8, 2, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        ops.matmul_kernel(torch.randn(0, 8), torch.randn(8, 2))


def _view(shape, strides, offset_bytes, dtype=torch.float32):
    """A view with the given strides starting ``offset_bytes`` into a
    fresh (64-byte aligned) CPU allocation."""
    size = torch.tensor([], dtype=dtype).element_size()
    span = 1 + sum((d - 1) * st for d, st in zip(shape, strides))
    base = torch.empty(offset_bytes // size + span + 16, dtype=dtype)
    start = (-base.data_ptr() % 64 + offset_bytes) // size
    return base.as_strided(shape, strides, start)


# (a shape, a strides, a offset in bytes, a dtype, n, K4's route): M^T @ P
# streamed from 48 MiB of M with 16-byte aligned rows of 512 bytes or more
MM_ROUTE_CASES = [
    ((128, 64), (64, 1), 0, torch.float32, 4, "rows"),
    ((896, 15000), (1, 896), 0, torch.float32, 4, "cols_bulk"),
    ((896, 30000), (1, 896), 0, torch.bfloat16, 8, "cols_bulk"),
    ((898, 15000), (1, 904), 0, torch.float32, 4, "cols_bulk"),
    ((4864, 2700), (1, 4864), 0, torch.float32, 4, "cols_bulk"),
    ((896, 15000), (1, 896), 0, torch.bfloat16, 4, "cols"),   # 27 MB
    ((4864, 896), (1, 4864), 0, torch.float32, 4, "cols"),    # 17 MB
    ((896, 15000), (1, 896), 4, torch.float32, 4, "cols"),    # base off 16
    ((64, 300000), (1, 64), 0, torch.float32, 4, "cols"),     # 256-byte rows
    ((33, 4), (1, 33), 0, torch.float32, 7, "cols"),          # rows off 16
    ((37, 300), (1, 37), 0, torch.bfloat16, 3, "cols"),
    ((100, 4), (4, 1), 0, torch.float32, 96, "smallk"),
    ((70, 50), (50, 1), 0, torch.float32, 40, "tiled"),
    ((40, 30), (1, 40), 0, torch.float32, 20, "tiled"),
]


@pytest.mark.parametrize("shape,strides,offset,dtype,n,route",
                         MM_ROUTE_CASES)
def test_matmul_variant_from_layout(shape, strides, offset, dtype, n, route):
    """K4's route from shape, strides and alignment, as on the card."""
    a = _view(shape, strides, offset, dtype)
    assert a.stride() == strides and a.data_ptr() % 64 == offset
    assert ops.matmul_variant(a, torch.empty(shape[1], n, dtype=dtype)) \
        == route


@pytest.mark.parametrize("rows,cols,route", [(152064, 896, "cols_bulk"),
                                             (896, 4864, "cols")])
def test_matmul_variant_of_the_codec_products(rows, cols, route):
    """LowRankCodec's three products on qwen2-0.5b's embedding gradient
    and an MLP gradient: M @ Q0 on rows, M^T @ P (P column-major, as QR
    gives it) streamed only for the embedding, the decode on the small-k
    route.  Nothing is computed: the memory is never touched."""
    mat = torch.empty(rows, cols)
    p = torch.empty(4, rows).T
    q = torch.empty(cols, 4)
    assert ops.matmul_variant(mat, q) == "rows"
    assert ops.matmul_variant(mat.T, p) == route
    assert ops.matmul_variant(p, q.T) == "smallk"


@pytest.mark.parametrize("n,offset,variant", [
    (256, 0, "vec16"), (4194304, 0, "vec16"), (48, 0, "vec16"),
    (100, 0, "vec4"), (256, 4, "vec4"), (256, 8, "vec4"),
    (33, 0, "scalar"), (256, 1, "scalar"), (4096, 3, "scalar")])
def test_dequantize_variant_from_layout(n, offset, variant):
    """K2b's variant from the row length and q's alignment."""
    q = _view((2, n), (n, 1), offset, torch.int8)
    assert ops.dequantize_variant(n, q.data_ptr()) == variant


def test_wrappers_count_no_launch_on_cpu():
    """The CPU path is the plain version: no kernel launch is counted."""
    wrappers = (ops.quantize_kernel, ops.dequantize_kernel,
                ops.sparsify_kernel, ops.matmul_kernel)
    before = [w.launches for w in wrappers]
    q, s = ops.quantize_kernel(torch.randn(2, 8))
    ops.dequantize_kernel(q, s)
    ops.sparsify_kernel(torch.randn(2, 8), torch.ones(2, 1))
    ops.matmul_kernel(torch.randn(2, 8), torch.randn(8, 3))
    assert [w.launches for w in wrappers] == before
