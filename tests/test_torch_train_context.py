"""The port's training step against the JAX package's on the families
that take a context (llama-3.2-vision-90b, seamless-m4t-medium, also in
two microbatches under remat), the kernel launches of a training step
(``train_launches``), and the chunked CPU attention path against the JAX
package's."""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_train_cases import (_batch, check_train_step,
                               _flash_attention_chunked, _flash_attention_jnp,
                               forward, get_config, GMM_BWD_LAUNCHES,
                               init_params, jax_mha, LAUNCHES_PER_CALL,
                               multihead_attention, param_leaves, smoke_config,
                               SSD_BWD_LAUNCHES, SSD_LAUNCHES, step_cases,
                               train_launches, tree_map)


@pytest.mark.parametrize("arch,overrides,remat", step_cases((
    "llama-3.2-vision-90b", "seamless-m4t-medium")))
def test_train_step_matches_jax(arch, overrides, remat):
    """One step from shared params, state and batch against the JAX
    package's (``torch_train_cases.check_train_step``)."""
    check_train_step(arch, overrides, remat)


K1B, K6, K6B, K5B = LAUNCHES_PER_CALL, SSD_LAUNCHES, SSD_BWD_LAUNCHES, \
    GMM_BWD_LAUNCHES


@pytest.mark.parametrize("arch,microbatches,remat,want", [
    # 24 attention layers x 2 microbatches, forward twice under remat
    ("qwen2-0.5b", 2, True, {"flash_attention": 24 * 2 * 2,
                             "flash_attention_bwd": 24 * 2 * K1B}),
    ("qwen2-0.5b", 1, False, {"flash_attention": 24,
                              "flash_attention_bwd": 24 * K1B}),
    # smoke: one attention + dense layer, one Mamba + MoE layer
    ("jamba-1.5-large-398b", 3, False, {
        "flash_attention": 3, "flash_attention_bwd": 3 * K1B,
        "ssd_scan": 3 * K6, "ssd_scan_bwd": 3 * K6B,
        "moe_gmm": 3 * 3, "moe_gmm_bwd": 3 * 3 * K5B}),
    # smoke: two Mamba layers
    ("mamba2-130m", 4, True, {"ssd_scan": 2 * 4 * 2 * K6,
                              "ssd_scan_bwd": 2 * 4 * K6B}),
    # smoke: two attention + MoE layers
    ("dbrx-132b", 2, True, {
        "flash_attention": 2 * 2 * 2, "flash_attention_bwd": 2 * 2 * K1B,
        "moe_gmm": 3 * 2 * 2 * 2, "moe_gmm_bwd": 3 * 2 * 2 * K5B})])
def test_train_launches(arch, microbatches, remat, want):
    """Each forward kernel once a layer and microbatch (twice under remat,
    whose checkpointed layer runs again in the backward), each backward
    kernel once: K1 and its backward per attention layer, K6 and its
    backward per Mamba layer, K5 and its backward per expert product
    (three a MoE layer); kernels that do not launch are left out.
    qwen2-0.5b at full depth, the others at smoke size."""
    cfg = get_config(arch) if arch == "qwen2-0.5b" else smoke_config(arch)
    assert train_launches(cfg, microbatches, remat) == want


@pytest.mark.parametrize("arch,seq,want,moe", [
    ("deepseek-v2-236b", None, 0, 59),  # MLA: q and v head dims differ
    ("llama-3.2-vision-90b", 512, 80, 0),  # self layers; cross T 1601
    ("llama-3.2-vision-90b", 1601, 100, 0),  # cross layers at S == T too
    ("seamless-m4t-medium", 512, 24, 0),  # encoder + decoder self
    ("seamless-m4t-medium", 1024, 36, 0)])  # + the cross blocks at S == T
def test_train_launches_with_context(arch, seq, want, moe):
    """K1 launches a step of the context families at full size, one
    microbatch: MLA none, a cross-attention layer or cross block one
    only where the sequence is as long as the context, the encoder's
    layers one each (the loss encodes); deepseek-v2's 59 MoE layers K5
    three times and its backward's two launches three times each."""
    got = train_launches(get_config(arch), 1, False, seq)
    want = {"flash_attention": want,
            "flash_attention_bwd": want * LAUNCHES_PER_CALL,
            "moe_gmm": 3 * moe, "moe_gmm_bwd": 3 * moe * K5B}
    assert got == {k: n for k, n in want.items() if n}


# --- the chunked CPU attention path -----------------------------------------

def _mha_inputs(seed, b, sq, sk, kv, g, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, kv, g, hd), dtype=np.float32),
            rng.standard_normal((b, sk, kv, hd), dtype=np.float32),
            rng.standard_normal((b, sk, kv, hd), dtype=np.float32))


@pytest.mark.parametrize("shape,causal,window,chunks", [
    ((2, 96, 96, 2, 3, 16), True, None, (32, 32)),
    ((1, 100, 100, 2, 2, 8), True, 24, (32, 16)),      # ragged tails
    ((1, 70, 130, 1, 4, 8), False, 40, (16, 48)),      # Sq != Sk
    ((1, 90, 50, 2, 1, 16), True, 16, (32, 32)),       # rows with no key
    ((2, 64, 64, 1, 2, 32), False, None, (64, 64)),
])
def test_chunked_attention_matches_jax(shape, causal, window, chunks):
    """``_flash_attention_chunked`` against the JAX package's
    ``_flash_attention_jnp`` with the same small chunks, its output and its
    gradients (torch autograd against jax.grad of sum(out * w))."""
    b, sq, sk, kv, g, hd = shape
    q, k, v = _mha_inputs(sum(shape), b, sq, sk, kv, g, hd)
    w = np.random.default_rng(1).standard_normal(
        (b, sq, kv, g, hd)).astype(np.float32)
    qc, kc = chunks
    pos_q, pos_k = np.arange(sq), np.arange(sk)

    def jax_loss(q, k, v):
        out = _flash_attention_jnp(q, k, v, q_pos=jnp.asarray(pos_q),
                                   k_pos=jnp.asarray(pos_k), causal=causal,
                                   window=window, q_chunk=qc, kv_chunk=kc)
        return jnp.sum(out * w), out

    (_, jout), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = _flash_attention_chunked(tq, tk, tv, q_pos=torch.from_numpy(pos_q),
                                   k_pos=torch.from_numpy(pos_k),
                                   causal=causal, window=window, q_chunk=qc,
                                   kv_chunk=kc)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=2e-5, rtol=2e-5)
    for t, jg in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                                   atol=2e-5, rtol=2e-5)


def test_multihead_attention_goes_chunked_above_plain_limit():
    """Above 2048^2 scores the CPU path is the chunked one (default chunks
    of 1024), as the JAX package's dispatch: Sq = Sk = 2100 with a
    window, against JAX's ``multihead_attention``."""
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((1, 2100, n, 8), dtype=np.float32)
               for n in (2, 1, 1))
    pos = np.arange(2100)
    port = multihead_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               q_pos=torch.from_numpy(pos),
                               k_pos=torch.from_numpy(pos), causal=True,
                               window=300)
    ref = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  q_pos=jnp.asarray(pos), k_pos=jnp.asarray(pos),
                  causal=True, window=300)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


def test_forward_remat_matches_plain_forward_gradients():
    """forward(remat=True) under autograd gives the gradients of the plain
    forward (a hybrid config: attention, Mamba and MoE layers)."""
    cfg = smoke_config("jamba-1.5-large-398b")
    params = init_params(cfg, torch.Generator().manual_seed(1),
                         device="cpu")
    tok = torch.from_numpy(_batch(cfg, 2, (2, 16))["tokens"]).long()
    grads = []
    for remat in (False, True):
        leaves = [t.detach().requires_grad_(True)
                  for t in param_leaves(params)]
        it = iter(leaves)
        p = tree_map(lambda _: next(it), params)
        logits, aux = forward(cfg, p, tok, remat=remat)
        (logits.float().square().mean() + aux).backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)
