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
from repro_torch.kernels.moe_gmm.ops import (BWD_LAUNCHES_PER_CALL,
                                             gmm_bwd_parts, gmm_bwd_split,
                                             gmm_bwd_tiles, gmm_bwd_variant,
                                             gmm_bwd_walk)

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


# (dtype, d, f, x strides, x / w / dy addresses, variant): dbrx's gate and
# up (x the expanded tokens) and down products, an EP rank's dispatched
# tokens, a padded-row view that stays aligned; rows TMA cannot address
# (d 100, rows 131 values apart), f or d off a multiple of 8, unaligned
# bases; f32
@pytest.mark.parametrize("dtype,d,f,strides,ptrs,want", [
    (torch.bfloat16, 6144, 10752, (0, 6144, 1), (0, 256, 512), "wgmma"),
    (torch.bfloat16, 10752, 6144, (5505024, 10752, 1), (0, 0, 0), "wgmma"),
    (torch.bfloat16, 6144, 10752, (983040, 6144, 1), (0, 0, 0), "wgmma"),
    (torch.bfloat16, 264, 256, (33792, 272, 1), (16, 32, 48), "wgmma"),
    (torch.bfloat16, 100, 1000, (0, 100, 1), (0, 0, 0), "mma_sync"),
    (torch.bfloat16, 128, 256, (16768, 131, 1), (0, 0, 0), "mma_sync"),
    (torch.bfloat16, 128, 60, (0, 128, 1), (0, 0, 0), "mma_sync"),
    (torch.bfloat16, 100, 64, (6400, 100, 1), (0, 0, 0), "mma_sync"),
    (torch.bfloat16, 128, 256, (0, 128, 1), (8, 0, 0), "mma_sync"),
    (torch.bfloat16, 128, 256, (0, 128, 1), (0, 8, 0), "mma_sync"),
    (torch.bfloat16, 128, 256, (0, 128, 1), (0, 0, 8), "mma_sync"),
    (torch.float32, 6144, 10752, (0, 6144, 1), (0, 0, 0), "f32"),
])
def test_gmm_bwd_variant(dtype, d, f, strides, ptrs, want):
    """The backward kernel's variant from dtype, d, f, x's strides and the
    operands' addresses: wgmma wherever TMA can address x, w and dy (at
    any C), mma_sync for the rest of bf16, f32 on the CUDA cores."""
    assert gmm_bwd_variant(dtype, d, f, strides, *ptrs) == want


def test_gmm_bwd_split_fills_the_card_at_dbrx():
    """At 132 SMs the expanded dx of dbrx's step (96 tiles of 128 x 256 over
    (512, 6144), a walk of 16 experts x 168 slices) is cut into 4 parts:
    384 work units, at least one an SM, three rounds of a quarter tile
    (1 part: 96 tiles, a third of the card idle for the whole walk)."""
    tiles = gmm_bwd_tiles(16, 512, 6144, expanded=True)
    steps = gmm_bwd_walk(16, 10752, expanded=True)
    assert (tiles, steps) == (96, 2688)
    split = gmm_bwd_split(tiles, steps, 132)
    assert split == 4 and tiles * split >= 132
    # the tiles already fill the card: the down product and an EP rank
    assert gmm_bwd_split(gmm_bwd_tiles(16, 512, 10752, False),
                         gmm_bwd_walk(16, 6144, False), 132) == 1
    assert gmm_bwd_split(gmm_bwd_tiles(8, 160, 6144, False),
                         gmm_bwd_walk(8, 10752, False), 132) == 1


@pytest.mark.parametrize("tiles,steps,sms", [
    (96, 2688, 132), (1, 4, 132), (4, 24, 132), (12, 256, 132),
    (1, 3, 132), (96, 2688, 114), (2688, 96, 132), (7, 5, 16)])
def test_gmm_bwd_parts_cover_the_walk_once(tiles, steps, sms):
    """The parts of dx's K walk cover its steps exactly once, each part a
    non-empty run in the order the kernel sums them (part 0 first), and
    never more parts than steps or than ``MAX_SPLIT``."""
    split = gmm_bwd_split(tiles, steps, sms)
    assert 1 <= split <= min(steps, 16)
    parts = gmm_bwd_parts(steps, split)
    assert len(parts) == split
    assert parts[0][0] == 0 and parts[-1][1] == steps
    covered = [k for begin, end in parts for k in range(begin, end)]
    assert covered == list(range(steps))
    assert all(end > begin for begin, end in parts)
    # the smallest count whose rounds come within 5% of the least
    rounds = {s: -(-tiles * s // sms) / s
              for s in range(1, min(steps, 16) + 1)}
    best = min(rounds.values())
    assert rounds[split] <= best * 1.05
    assert all(rounds[s] > best * 1.05 for s in range(1, split))


def test_gmm_bwd_launches_stay_two():
    """A split dx sums its parts inside the same launch (the last part of
    a tile to arrive), so a call is still dx and dw: two launches."""
    assert BWD_LAUNCHES_PER_CALL == 2
