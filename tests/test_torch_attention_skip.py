"""The chunked attention's ``causal_skip`` and ``unroll``
(``repro_torch.models.attention._flash_attention_chunked``) against the
JAX package's ``_flash_attention_jnp`` with the same flags, at the shapes
of ``tests/test_attention_props.py``; the FLOPs that ``causal_skip``
saves; and the two ``ParallelCtx`` flags reaching the chunked path through
the model's layers."""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.models.attention import _flash_attention_jnp
from repro_torch.configs import smoke_config
from repro_torch.models import attention as attn
from repro_torch.models import forward, init_params
from repro_torch.parallel import ParallelCtx

ATOL = 2e-5


def _qkv(seed, b, sq, sk, h, kv, d, vd=None):
    rng = np.random.default_rng(seed)
    vd = vd or d
    q = rng.standard_normal((b, sq, kv, h // kv, d), dtype=np.float32)
    k = rng.standard_normal((b, sk, kv, d), dtype=np.float32)
    v = rng.standard_normal((b, sk, kv, vd), dtype=np.float32)
    return q, k, v


def _both(q, k, v, q_pos, k_pos, **kw):
    want = _flash_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), q_pos=jnp.asarray(q_pos),
                                k_pos=jnp.asarray(k_pos), **kw)
    got = attn._flash_attention_chunked(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_pos=torch.from_numpy(q_pos), k_pos=torch.from_numpy(k_pos), **kw)
    return got.numpy(), np.asarray(want)


# (sq, chunk, window, causal_skip, unroll, v head dim)
CASES = [
    (512, 128, None, True, False, None),
    (512, 128, 100, True, False, None),
    (512, 96, 200, True, False, None),     # ragged tail, padded keys
    (512, 128, 100, True, False, 48),      # MLA: v head dim != q's
    (4096, 1024, None, True, True, None),  # unroll: chunks 2048
    (4096, 1024, 700, True, True, None),
]


@pytest.mark.parametrize("sq,chunk,window,skip,unroll,vd", CASES)
def test_chunked_flags_equal_jax(sq, chunk, window, skip, unroll, vd):
    q, k, v = _qkv(sq + chunk, 1, sq, sq, 4, 2, 32, vd)
    pos = np.arange(sq, dtype=np.int32)
    got, want = _both(q, k, v, pos, pos, causal=True, window=window,
                      q_chunk=chunk, kv_chunk=chunk, causal_skip=skip,
                      unroll=unroll)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


def test_unroll_non_causal_equals_jax():
    """Cross-attention's path (non-causal, ragged key length): ``unroll``
    only; ``causal_skip`` changes nothing without the causal mask."""
    q, k, v = _qkv(3, 1, 2304, 1601, 4, 4, 32)
    qp = np.arange(2304, dtype=np.int32)
    kp = np.arange(1601, dtype=np.int32)
    got, want = _both(q, k, v, qp, kp, causal=False, window=None,
                      unroll=True)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    skip, _ = _both(q, k, v, qp, kp, causal=False, window=None,
                    unroll=True, causal_skip=True)
    np.testing.assert_array_equal(skip, got)


def _flops(**kw) -> int:
    q, k, v = (torch.empty(s, device="meta") for s in
               ((1, 4096, 2, 2, 32), (1, 4096, 2, 32), (1, 4096, 2, 32)))
    pos = torch.arange(4096, device="meta")
    with FlopCounterMode(display=False) as fc:
        attn._flash_attention_chunked(q, k, v, q_pos=pos, k_pos=pos,
                                      causal=True, **kw)
    return fc.get_total_flops()


@pytest.mark.parametrize("chunk,window,pairs", [
    (1024, None, (10, 16)),   # 4 q chunks see 1 + 2 + 3 + 4 of 16 pairs
    (512, None, (36, 64)),
    (1024, 1000, (7, 16)),    # the window starts each chunk's range later
])
def test_causal_skip_flops(chunk, window, pairs):
    """``causal_skip`` computes only the chunk pairs a q chunk can see:
    the FLOPs of the matmuls fall to that share of the uniform loop's."""
    skip = _flops(window=window, q_chunk=chunk, kv_chunk=chunk,
                  causal_skip=True)
    full = _flops(window=window, q_chunk=chunk, kv_chunk=chunk)
    assert skip * pairs[1] == full * pairs[0]


def test_ctx_flags_reach_the_chunked_path(monkeypatch):
    """``ParallelCtx.causal_skip`` and ``unroll_layers`` reach every
    self-attention's chunked path through ``forward`` (the cross-attention
    gets ``unroll`` only), and the logits equal the flags' absence."""
    cfg = smoke_config("llama-3.2-vision-90b")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    for lp in params["layers"]:
        if "gate_attn" in lp["mixer"]:
            lp["mixer"]["gate_attn"].fill_(0.5)
    seen = []
    real = attn._flash_attention_chunked

    def spy(*a, **kw):
        seen.append((kw["causal"], kw["causal_skip"], kw["unroll"]))
        return real(*a, **kw)

    monkeypatch.setattr(attn, "_flash_attention_chunked", spy)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2304),
                           generator=torch.Generator().manual_seed(1))
    context = torch.randn((1, cfg.num_vision_tokens, cfg.d_model),
                          generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want, _ = forward(cfg, params, tokens, context=context)
        del seen[:]
        got, _ = forward(cfg, params, tokens, context=context,
                         ctx=ParallelCtx(causal_skip=True,
                                         unroll_layers=True))
    n_self = sum(s.mixer == "attn" for s in cfg.layer_specs())
    assert seen == [(True, True, True)] * n_self
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_reference_flags_exist():
    """The JAX package's context holds both flags the port mirrors, off
    by default on both sides."""
    from repro.parallel.planner import ParallelCtx as JaxCtx
    ref, port = JaxCtx(), ParallelCtx()
    assert (ref.causal_skip, ref.unroll_layers) == (False, False)
    assert (port.causal_skip, port.unroll_layers) == (False, False)
