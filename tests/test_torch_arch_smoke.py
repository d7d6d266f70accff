"""Port of tests/test_arch_smoke.py: every architecture at its smoke size
(2 layers, d_model <= 256, <= 4 experts) on the CPU, one forward and five
training steps on one batch: shapes, finite values, a falling loss; the
full configs' spot checks and parameter counts; the stub frontends bit for
bit against the JAX package's."""
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.data.stubs import audio_frames as jax_audio_frames
from repro.data.stubs import vision_patches as jax_vision_patches
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.core.types import TrainConfig
from repro_torch.data import audio_frames, vision_patches
from repro_torch.models import encode, forward, init_params
from repro_torch.optim import init_opt_state
from repro_torch.train import make_train_step
from torch_context import stub_context

B, S = 2, 32


def _batch(cfg, seed: int):
    tok = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    batch = {"tokens": tok, "labels": np.roll(tok, -1, 1)}
    context = stub_context(cfg, B)
    if context is not None:
        batch["context"] = context
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_shapes_and_finite(arch):
    cfg = smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = _batch(cfg, 0)
    context = batch.get("context")
    if context is not None:
        context = torch.from_numpy(context)
        if cfg.is_encoder_decoder:
            context = encode(cfg, params, context)
            assert context.shape == (B, cfg.num_audio_frames, cfg.d_model)
    logits, aux = forward(cfg, params, torch.from_numpy(batch["tokens"]),
                          context=context)
    assert logits.shape == (B, S, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all()), f"{arch}: non-finite logits"
    assert bool(torch.isfinite(aux)), f"{arch}: non-finite aux loss"
    if cfg.is_moe:
        assert float(aux) > 0.0  # load-balance loss active


# the other half: tests/test_torch_arch_smoke_train.py (a run's workers
# spread the two files)
TRAIN_ARCHS = ARCHS[:5]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_reduces_loss_and_finite(arch):
    check_train_step_reduces_loss(arch)


def check_train_step_reduces_loss(arch):
    """Five steps on one batch: every loss finite, the last below the
    first."""
    cfg = smoke_config(arch)
    tcfg = TrainConfig(learning_rate=5e-3, warmup_steps=1, total_steps=20,
                       remat=False, weight_decay=0.0)
    params = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    opt = init_opt_state(params)
    step = make_train_step(cfg, tcfg)
    batch = _batch(cfg, 1)
    losses = []
    for _ in range(5):
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all(), f"{arch}: NaN loss {losses}"
    assert losses[-1] < losses[0], \
        f"{arch}: loss should drop on repeated batch {losses}"


def test_context_is_required():
    """The cross-attention configs refuse to run without their context."""
    for arch in ("llama-3.2-vision-90b", "seamless-m4t-medium"):
        cfg = smoke_config(arch)
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        with pytest.raises(ValueError, match="context"):
            forward(cfg, params, torch.zeros((1, 4), dtype=torch.long))


def test_full_configs_match_assignment():
    """tests/test_arch_smoke.py's spot checks of the assigned
    hyperparameters, on the port's configs."""
    g = get_config("granite-3-8b")
    assert (g.num_layers, g.d_model, g.num_heads, g.num_kv_heads,
            g.d_ff, g.vocab_size) == (40, 4096, 32, 8, 12800, 49155)
    d = get_config("deepseek-v2-236b")
    assert (d.num_layers, d.d_model, d.num_experts, d.top_k,
            d.kv_lora_rank, d.num_shared_experts) == (60, 5120, 160, 6,
                                                      512, 2)
    j = get_config("jamba-1.5-large-398b")
    assert (j.num_layers, j.attn_period, j.num_experts, j.top_k,
            j.moe_layer_period) == (72, 8, 16, 2, 2)
    specs = j.layer_specs()
    assert sum(1 for s in specs if s.mixer == "attn") == 9
    assert sum(1 for s in specs if s.ffn == "moe") == 36
    lv = get_config("llama-3.2-vision-90b")
    assert sum(1 for s in lv.layer_specs() if s.mixer == "cross_attn") == 20
    sm = get_config("seamless-m4t-medium")
    assert (sm.encoder_layers, sm.num_layers, sm.num_audio_frames) == \
        (12, 12, 1024)
    q = get_config("qwen2-0.5b")
    assert q.qkv_bias and q.tie_embeddings
    m = get_config("mamba2-130m")
    assert m.attention == "none" and m.ssm_state == 128


def test_param_counts_match_names():
    """Total parameter counts match the model names (+-15%, as
    tests/test_arch_smoke.py holds them)."""
    expected = {
        "granite-3-8b": 8e9, "mamba2-130m": 0.13e9,
        "h2o-danube-1.8b": 1.8e9, "deepseek-v2-236b": 236e9,
        "dbrx-132b": 132e9, "llama-3.2-vision-90b": 90e9,
        "jamba-1.5-large-398b": 398e9, "qwen2-0.5b": 0.5e9,
        "starcoder2-3b": 3e9,
    }
    for arch, n in expected.items():
        total = get_config(arch).param_counts()["total"]
        assert 0.8 * n < total < 1.25 * n, (arch, total, n)


@pytest.mark.parametrize("arch,seed,batch", [
    ("seamless-m4t-medium", 0, 2), ("seamless-m4t-medium", 3, 1),
    ("llama-3.2-vision-90b", 0, 2), ("llama-3.2-vision-90b", 5, 3)])
def test_stubs_equal_jax(arch, seed, batch):
    """The stub frontends draw the JAX package's numbers, bit for bit."""
    cfg, jcfg = smoke_config(arch), jax_smoke_config(arch)
    if cfg.is_encoder_decoder:
        got, want = audio_frames(cfg, batch, seed), \
            jax_audio_frames(jcfg, batch, seed)
    else:
        got, want = vision_patches(cfg, batch, seed), \
            jax_vision_patches(jcfg, batch, seed)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
