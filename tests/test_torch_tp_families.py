"""The model axis of the families beyond the dense GQA and Mamba2 configs
(``tests/test_torch_tp.py``), with the same checks: MLA
(deepseek-v2-236b), cross-attention layers (llama-3.2-vision-90b), the
encoder and the decoder's cross blocks (seamless-m4t-medium), and for the
MoE configs (deepseek, dbrx-132b, jamba-1.5-large-398b) expert
parallelism of the experts on the same axis, beside the attention, the
Mamba heads, the shared experts and the vocabulary, at capacity factor E
on both sides (no dispatch dropped, so that the single-rank run is a
reference too).

For each mesh, (1, 4) and (2, 2): one ``spawn_ranks`` of 4 gloo ranks
computes every case (``torch_tp_ranks.tp_cases``), and, at the same time,
one JAX subprocess on 4 forced host devices computes the JAX package's
forward (the encoder's ``encode(..., ctx=)`` first), decode and training
step on a mesh of Auto axes (ROADMAP R5) with the planner's parameter
specs.  A (1, 2) mesh, on which every KV head splits, is held against the
single-rank run.  The inputs are the JAX package's parameters
(``init_params``, key 0, the cross-attention gates opened:
``torch_context.open_gates``), the stub contexts and numpy from a seed.
Tolerances as ``tests/test_torch_tp.py``'s.
"""
import numpy as np
import pytest

from repro_torch.configs import smoke_config
from test_torch_tp import (BASE, BATCHER_TEMPERATURES, DECODE_STEPS,
                           MESHES, MOE_ARCHS, STEP_TOL, TOKENS, _check_step,
                           _close, batcher_cases,
                           check_tp_batcher_ranks_emit_the_same_tokens,
                           check_tp_forward_and_decode_match_jax,
                           check_tp_forward_and_decode_match_single_rank,
                           check_tp_init_gathers_to_the_single_draw,
                           check_tp_step_matches_jax,
                           check_tp_step_matches_single_rank, mesh_runs,
                           model_cases, runs_1x2_of, single)

CONTEXT_ARCHS = ("llama-3.2-vision-90b", "seamless-m4t-medium")
ARCHS = CONTEXT_ARCHS + MOE_ARCHS
BATCHER_ARCHS = ("deepseek-v2-236b", "llama-3.2-vision-90b",
                 "seamless-m4t-medium")
GRAD_FAULTS = [("mla_x_only", "deepseek-v2-236b"),
               ("gate_before_reduce", "llama-3.2-vision-90b")]


def _cases(mesh) -> dict:
    cases = model_cases(mesh, ARCHS)
    cases.update(batcher_cases(BATCHER_ARCHS))
    for fault, arch in GRAD_FAULTS:
        cases[f"grad_fault|{fault}"] = {"kind": "grad_fault", "arch": arch,
                                        "fault": fault, "tcfg": BASE}
    return cases


@pytest.fixture(scope="module", params=MESHES[:1], ids=["1x4"])
def runs(request, tmp_path_factory):
    """Every case on the mesh's 4 ranks and on JAX's 4 devices, at once:
    (mesh, the ranks' results, JAX's arrays, the inputs).  The (2, 2)
    mesh's run is ``tests/test_torch_tp_families_2x2.py``'s."""
    return families_runs(request.param, tmp_path_factory)


def families_runs(mesh, tmp_path_factory):
    return mesh_runs(mesh, tmp_path_factory.mktemp("tpf{}x{}".format(*mesh)),
                     ARCHS, _cases(mesh))


@pytest.fixture(scope="module")
def runs_1x2(tmp_path_factory):
    """The model cases on a (1, 2) mesh, whose 2 KV heads split."""
    return runs_1x2_of(tmp_path_factory.mktemp("tpf1x2"), ARCHS, {
        k: v for k, v in model_cases((1, 2), ARCHS).items()
        if v["kind"] == "model"})


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_forward_and_decode_match_jax(runs, arch):
    check_tp_forward_and_decode_match_jax(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_forward_and_decode_match_single_rank(runs, arch):
    check_tp_forward_and_decode_match_single_rank(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_step_matches_jax(runs, arch):
    check_tp_step_matches_jax(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_step_matches_single_rank(runs, arch):
    check_tp_step_matches_single_rank(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_init_gathers_to_the_single_draw(runs, arch):
    check_tp_init_gathers_to_the_single_draw(runs, arch)


@pytest.mark.parametrize("temperature", BATCHER_TEMPERATURES)
@pytest.mark.parametrize("arch", BATCHER_ARCHS)
def test_tp_batcher_ranks_emit_the_same_tokens(runs, arch, temperature):
    check_tp_batcher_ranks_emit_the_same_tokens(runs, arch, temperature)


@pytest.mark.parametrize("fault,arch", GRAD_FAULTS)
def test_planted_gradient_faults_are_caught(runs, fault, arch):
    """Two faults that leave the forward as it is and break the gradient
    of a replicated leaf: ``copy_to_model`` on MLA's input alone (each
    rank's gradient of ``w_dq``, ``w_dkv`` and their norms is then only
    its own heads' share) and the cross-attention gate applied to the
    partial sums before ``reduce_from_model`` (each rank's gradient of
    ``gate_attn`` its own heads').  Both move those leaves' gradients by
    more than a tenth of their size and five times the tolerance that the
    sound step meets (``test_tp_step_matches_single_rank``)."""
    mesh, ranks, _, data = runs
    want = single(arch, data)["grads"]
    name = f"grad_fault|{fault}"
    # each data index's gradient is of its rows: their sum is the batch's
    got = {k: sum(ranks[d * mesh[1]][name]["grads"][k]
                  for d in range(mesh[0])) for k in want}
    leaves = {"mla_x_only": ("w_dq", "w_dkv", "norm_q/scale",
                             "norm_kv/scale"),
              "gate_before_reduce": ("gate_attn",)}[fault]
    for leaf in leaves:
        keys = [k for k in want if k.endswith("/" + leaf)]
        assert keys, leaf
        err = max(float(np.abs(got[k] - want[k]).max()) for k in keys)
        scale = max(float(np.abs(want[k]).max()) for k in keys)
        bound = STEP_TOL["atol"] + STEP_TOL["rtol"] * scale
        assert err > 5 * bound and err > 0.1 * scale, (leaf, err, scale)


def test_tp_context_caches_hold_this_ranks_heads(runs):
    """The cross-attention layer's K/V (llama-3.2-vision-90b) and the
    encoder-decoder's cross-block K/V hold the rank's KV heads (all of
    them where they do not split); MLA's latent cache is whole on every
    rank (``cache_specs``)."""
    mesh, ranks, _, _ = runs
    tp = mesh[1]
    b = TOKENS[0]
    for arch in CONTEXT_ARCHS:
        cfg = smoke_config(arch)
        t = cfg.num_audio_frames if cfg.is_encoder_decoder else \
            cfg.num_vision_tokens
        kv = cfg.num_kv_heads // tp if cfg.num_kv_heads % tp == 0 else \
            cfg.num_kv_heads
        shapes = ranks[0][f"model|{arch}"]["cache_shapes"]
        cross = (b, t, kv, cfg.resolved_head_dim)
        assert shapes.count(cross) == 2 * (
            cfg.num_layers if cfg.is_encoder_decoder else
            sum(s.mixer == "cross_attn" for s in cfg.layer_specs())), shapes
    cfg = smoke_config("deepseek-v2-236b")
    shapes = ranks[0]["model|deepseek-v2-236b"]["cache_shapes"]
    assert shapes[:2] == [(b, DECODE_STEPS, cfg.kv_lora_rank),
                          (b, DECODE_STEPS, cfg.qk_rope_head_dim)]


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_1x2_splits_the_kv_heads_of_every_family(runs_1x2, arch):
    """On a (1, 2) mesh the KV heads of the cross-attention layers, the
    encoder and the cross blocks split too, and MLA's heads, the shared
    experts and the experts split in two: logits, decode, gradient and
    the step against the single-rank run."""
    ranks, data = runs_1x2
    got = ranks[0][f"model|{arch}"]
    want = single(arch, data)
    np.testing.assert_allclose(got["logits"], want["logits"], **STEP_TOL)
    np.testing.assert_allclose(got["decode"], want["decode"], **STEP_TOL)
    _close(got["grads"], want["grads"], **STEP_TOL)
    _check_step(got, want["metrics"], want, want["p0"])
