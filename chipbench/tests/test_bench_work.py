"""The work counters against hand arithmetic, and against the operations
PyTorch's ``FlopCounterMode`` counts in the port's eager step on the CPU
at a small size (which counts what the eager step computes, not the
model's work: the padded vocabulary, the full S x S square of the plain
attention, and in ``moe_dense`` every expert on every token, E / top_k
times the routed expert work, and the combine's einsum)."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from cb import work
from cb.spec import find_cell, model_fields
from cells import small_cell


def test_qwen2_by_hand():
    c = find_cell("qwen2-train-4k").config
    attn = 896 * (14 + 2 * 2) * 64 + 14 * 64 * 896      # 1,835,008
    ffn = 3 * 896 * 4864                                # 13,074,432
    assert work.active_matmul_params(c) == \
        24 * (attn + ffn) + 896 * 151936 == 493_961_216
    assert work.model_flops_per_token(c, 4096) == \
        6 * 493_961_216 + 6 * 24 * 4096 * 14 * 64 == 3_492_249_600
    flops, nbytes = work.attention_work(c, 4, 4096)
    # six causal products of B H S^2 hd each (two forward, four backward)
    assert flops == 6 * 4 * 14 * 4096 ** 2 * 64 * 24
    assert flops / work.PEAK_FLOPS_BF16 > nbytes / work.PEAK_BYTES


def test_dbrx_by_hand():
    c = find_cell("dbrx-1l-train-4k").config
    attn = 6144 * (48 + 16) * 128 + 48 * 128 * 6144
    experts = 4 * 3 * 6144 * 10752                      # top-4 of 16
    router = 6144 * 16
    assert work.active_matmul_params(c) == \
        attn + experts + router + 6144 * 100352 == 1_497_464_832
    assert work.model_flops_per_token(c, 4096) == 9_135_783_936
    flops, nbytes = work.moe_routed_work(c, 1, 4096)
    assert flops == 18 * 4096 * 4 * 6144 * 10752       # 16,384 routed rows
    assert nbytes == pytest.approx(
        3 * 3 * 16 * 6144 * 10752 * 2 + 2 * 16384 * (2 * 6144 + 3 * 10752)
        * 2)
    assert flops / work.PEAK_FLOPS_BF16 > nbytes / work.PEAK_BYTES
    assert work.moe_routed_work(find_cell("qwen2-train-4k").config, 4,
                                4096) == (0.0, 0.0)


@pytest.mark.parametrize("name", ["qwen2-train-4k", "dbrx-1l-train-4k"])
def test_against_flop_counter(name):
    from repro_torch.core.types import ModelConfig
    from repro_torch.models.transformer import forward, init_params
    from repro_torch.train.loss import cross_entropy
    cell = small_cell(name)
    c = cell.config
    cfg = ModelConfig(**model_fields(c))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)
        else:
            leaves.append(t.requires_grad_(True))
    walk(params)
    b, s = 2, 64
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, c["vocab_size"], (b, s), generator=gen)
    labels = torch.randint(0, c["vocab_size"], (b, s), generator=gen)
    with FlopCounterMode(display=False) as counter:
        logits, aux = forward(cfg, params, tokens)
        loss = cross_entropy(logits, labels) + cfg.router_aux_loss * aux
        torch.autograd.grad(loss, leaves, allow_unused=True)
    t, d = b * s, c["d_model"]
    eager = work.active_matmul_params(c) \
        + d * (cfg.padded_vocab - c["vocab_size"])
    if c.get("num_experts"):
        e, k = c["num_experts"], c["top_k"]
        per_expert = 3 * d * c["moe_d_ff"]
        # moe_dense: E / k times the routed products, and the combine
        eager += (e - k) * per_expert * c["num_layers"] + e * d
        assert (e / k) * k * per_expert == e * per_expert
    attn_flops, _ = work.attention_work(c, b, s)
    want = 6 * t * eager + 2 * attn_flops
    assert counter.get_total_flops() == want
    model = work.model_flops_per_token(c, s) * t
    assert model < want
