"""The port's grouped expert GEMM (K5's plain version and wrapper) and MoE
FFN against the JAX package, at small size on the CPU: the same numpy inputs
and the JAX package's weights through both sides.  Ports of
tests/test_kernels.py::test_moe_gmm_sweep and of tests/test_moe.py's
single-device cases.

Parity of routing is tested in f32 on random inputs: ``jax.lax.top_k``
breaks ties toward the lower index and ``torch.topk`` promises no order, so
the two can differ only on exactly tied probabilities, which random f32
inputs do not produce."""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.moe_gmm.ops import moe_gmm as jax_moe_gmm
from repro.kernels.moe_gmm.ref import moe_gmm_ref as jax_moe_gmm_ref
from repro.models import moe as jmoe
from repro_torch.configs import smoke_config
from repro_torch.kernels import _build
from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_ref
from repro_torch.kernels.moe_gmm.ops import gmm_variant
from repro_torch.models import moe as tmoe

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),  # tests/test_kernels.py:15-17
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,d,f,blocks", [  # tests/test_kernels.py:102-107
    (2, 128, 256, 128, dict()),
    (4, 256, 512, 384, dict(bd=128)),
    (16, 128, 256, 256, dict(bc=64, bf=128, bd=64)),
])
def test_moe_gmm_plain_matches_jax(e, c, d, f, blocks, dtype):
    """The plain version against the JAX oracle and the interpret-mode
    Pallas kernel (with the JAX test's block shapes)."""
    rng = np.random.default_rng(e * 10 + f)
    x = rng.standard_normal((e, c, d), dtype=np.float32)
    w = rng.standard_normal((e, d, f), dtype=np.float32) * 0.05
    jx, jw = (jnp.asarray(v).astype(dtype) for v in (x, w))
    tx, tw = (torch.from_numpy(v).to(getattr(torch, dtype)) for v in (x, w))
    out = moe_gmm(tx, tw)
    assert out.dtype == getattr(torch, dtype) and out.shape == (e, c, f)
    for ref in (jax_moe_gmm_ref(jx, jw),
                jax_moe_gmm(jx, jw, interpret=True, **blocks)):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, np.float32), **TOL[dtype])


def test_moe_gmm_takes_expert_stride_zero_and_ragged_shapes():
    """The tokens expanded over experts (stride 0, no copy) and the ragged
    decode shape (C = 3 slots, d and f off any tile) give the plain
    product."""
    rng = np.random.default_rng(0)
    xt = torch.from_numpy(rng.standard_normal((3, 40), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((5, 40, 24), dtype=np.float32))
    xe = xt.expand(5, 3, 40)
    assert xe.stride(0) == 0
    out = moe_gmm(xe, w)
    np.testing.assert_allclose(
        out.numpy(), moe_gmm_ref(xe.contiguous(), w).numpy(), atol=1e-5)
    np.testing.assert_allclose(out[2].numpy(), (xt @ w[2]).numpy(),
                               atol=1e-5)


def test_moe_gmm_wrapper_guards():
    x = torch.zeros(2, 4, 8)
    w = torch.zeros(2, 8, 6)
    with pytest.raises(ValueError, match="want x"):
        moe_gmm(x, torch.zeros(2, 6, 8))
    with pytest.raises(TypeError, match="both f32 or both bf16"):
        moe_gmm(x, w.bfloat16())
    with pytest.raises(ValueError, match="unit stride"):
        moe_gmm(torch.zeros(2, 8, 4).transpose(1, 2), w)
    with pytest.raises(ValueError, match="contiguous"):
        moe_gmm(x, torch.zeros(2, 6, 8).transpose(1, 2))


@pytest.mark.parametrize("dtype,c,f,strides,x_ptr,w_ptr,want", [
    (torch.bfloat16, 512, 10752, (0, 6144, 1), 0, 256, "wgmma"),  # prefill
    (torch.bfloat16, 512, 6144, (5505024, 10752, 1), 0, 0, "wgmma"),  # down
    (torch.bfloat16, 64, 1000, (12800, 200, 1), 16, 32, "wgmma"),  # ragged
    (torch.bfloat16, 4, 10752, (0, 6144, 1), 0, 0, "wgmma_swap"),  # decode
    (torch.bfloat16, 4, 6144, (43008, 10752, 1), 0, 0, "wgmma_swap"),
    (torch.bfloat16, 63, 256, (0, 64, 1), 0, 0, "wgmma_swap"),  # C < 64
    (torch.bfloat16, 4, 1000, (0, 100, 1), 0, 0, "mma_sync"),
    (torch.bfloat16, 128, 1000, (0, 100, 1), 0, 0, "mma_sync"),  # rows
    (torch.bfloat16, 128, 1000, (12804, 100, 1), 0, 0, "mma_sync"),
    (torch.bfloat16, 128, 60, (0, 64, 1), 0, 0, "mma_sync"),  # f % 8
    (torch.bfloat16, 128, 256, (0, 64, 1), 8, 0, "mma_sync"),  # x base
    (torch.bfloat16, 128, 256, (0, 64, 1), 0, 8, "mma_sync"),  # w base
    (torch.float32, 512, 10752, (0, 6144, 1), 0, 0, "f32"),
])
def test_gmm_variant(dtype, c, f, strides, x_ptr, w_ptr, want):
    """The kernel's variant from dtype, C, f, x's strides and the operands'
    addresses: wgmma where TMA can address both operands, its 128 x 256
    tiles from C = 64 on and swap-AB below."""
    assert gmm_variant(dtype, c, f, strides, x_ptr, w_ptr) == want


def test_library_path_follows_shared_header(tmp_path, monkeypatch):
    """A kernel's library is keyed by its own directory and the kernels'
    shared headers: editing hopper.cuh rebuilds every kernel."""
    src = tmp_path / "csrc" / "k.cu"
    src.parent.mkdir()
    src.write_text("// kernel")
    shared = tmp_path / "shared"
    shared.mkdir()
    (shared / "hopper.cuh").write_text("// v1")
    monkeypatch.setattr(_build, "SHARED_HEADERS", shared)
    first = _build.library_path(src)
    assert _build.library_path(src) == first
    (shared / "hopper.cuh").write_text("// v2")
    assert _build.library_path(src) != first
    (shared / "notes.txt").write_text("not a header")
    second = _build.library_path(src)
    assert second.name.startswith("k-") and second.suffix == ".so"


def _moe_both(seed=0, **overrides):
    cfg = dataclasses.replace(smoke_config("dbrx-132b"), **overrides)
    jcfg = dataclasses.replace(jax_smoke_config("dbrx-132b"), **overrides)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = jax.tree.map(lambda v: torch.from_numpy(np.array(v)), jp)
    return cfg, jcfg, tp, jp


@pytest.mark.parametrize("overrides", [
    dict(),                                        # dbrx: GeGLU, top-2 of 4
    dict(ffn_act="swiglu", num_shared_experts=1),  # jamba/deepseek-like
])
def test_route_and_moe_dense_match_jax(overrides):
    cfg, jcfg, tp, jp = _moe_both(0, **overrides)
    x = np.random.default_rng(1).standard_normal((3, 8, cfg.d_model),
                                                 dtype=np.float32)
    ids, w, aux = tmoe.route(tp, cfg, torch.from_numpy(x))
    jids, jw, jaux = jmoe.route(jp, jcfg, jnp.asarray(x))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert w.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-5)
    assert float(aux) >= 1.0 - 1e-3  # >= 1 by Cauchy-Schwarz, =1 balanced

    y, aux_y = tmoe.moe_dense(tp, cfg, torch.from_numpy(x))
    jy, _ = jmoe.moe_dense(jp, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    ya, auxa = tmoe.moe_apply(tp, cfg, torch.from_numpy(x))
    assert torch.equal(ya, y) and float(auxa) == float(aux_y) == float(aux)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dense_moe_is_convex_combination(seed):
    """Port of test_moe.py::test_dense_moe_is_convex_combination:
    ||y|| <= max_e ||ffn_e(x)|| per token."""
    cfg, _, tp, _ = _moe_both(seed, num_shared_experts=0)
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (2, 4, cfg.d_model), dtype=np.float32))
    y, _ = tmoe.moe_dense(tp, cfg, x)
    xt = x.reshape(-1, cfg.d_model)
    all_e = tmoe._expert_ffn(tp, cfg, xt.expand(cfg.num_experts, *xt.shape))
    max_norm = all_e.norm(dim=-1).max(dim=0).values
    y_norm = y.reshape(-1, cfg.d_model).norm(dim=-1)
    assert bool((y_norm <= max_norm + 1e-4).all())


def test_moe_apply_refuses_expert_parallel_context():
    """``moe_apply`` with an expert-parallel context refuses expert
    weights that are not this rank's part (``parallel.shard_params``) and
    dispatches as the JAX package does (models/moe.py:386-399): training
    and prefill to ``moe_ep_train``, decode to ``moe_ep_decode`` or, with
    ``ep_weight_stationary``, ``moe_ep_decode_ws``, at the context's
    capacity factors; without ``use_ep`` to ``moe_dense``.  Stand-in
    contexts of one rank: a model axis of 2 for the refusal (raised before
    any communication), of 1 for the dispatch, where every path runs
    without collectives and the factors 0.5 and 0.25 drop dispatches."""
    from repro_torch.parallel import ParallelCtx
    cfg, _, tp, _ = _moe_both()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 16, cfg.d_model), dtype=np.float32))
    two = ParallelCtx(use_ep=True, tp=2)
    for decode in (False, True):
        with pytest.raises(ValueError, match="shard_params"):
            tmoe.moe_apply(tp, cfg, x, ctx=two, decode=decode)

    ctx = ParallelCtx(use_ep=True, capacity_factor=0.25,
                      decode_capacity_factor=0.5)
    ws = dataclasses.replace(ctx, ep_weight_stationary=True)
    xd = x[:, :1]
    for got, want in (
            (tmoe.moe_apply(tp, cfg, x, ctx=ctx),
             tmoe.moe_ep_train(tp, cfg, x, ctx, 0.25)),
            (tmoe.moe_apply(tp, cfg, xd, ctx=ctx, decode=True),
             tmoe.moe_ep_decode(tp, cfg, xd, ctx, 0.5)),
            (tmoe.moe_apply(tp, cfg, xd, ctx=ws, decode=True),
             tmoe.moe_ep_decode_ws(tp, cfg, xd, ws, 0.5)),
            (tmoe.moe_apply(tp, cfg, x, ctx=ParallelCtx()),
             tmoe.moe_dense(tp, cfg, x))):
        assert torch.equal(got[0], want[0])
    dense, _ = tmoe.moe_dense(tp, cfg, x)
    assert float((tmoe.moe_apply(tp, cfg, x, ctx=ctx)[0] - dense)
                 .abs().max()) > 1e-3  # dispatches dropped


def test_init_moe_layout_matches_jax():
    cfg, _, tp, _ = _moe_both()
    own = tmoe.init_moe(cfg, torch.bfloat16, "cpu",
                        torch.Generator().manual_seed(0))
    assert {k: (tuple(v.shape)) for k, v in own.items()} == \
        {k: (tuple(v.shape)) for k, v in tp.items()}
    assert own["router"].dtype == torch.float32  # f32 whatever the weights
    assert own["w_up"].dtype == torch.bfloat16
