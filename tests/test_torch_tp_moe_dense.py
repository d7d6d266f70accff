"""A MoE config on a model axis without expert parallelism
(``make_ctx(..., use_ep=False)``): every MoE layer runs ``moe_dense`` on
the rank's E/tp experts (``param_specs`` puts them on the model axis) over
all of its tokens, and its partial output is summed over the model ranks
with the shared experts' partial; where the axis does not divide the
experts they are replicated and every rank runs all of them.  Held
against the JAX package's ``use_ep=False`` run (XLA shards the same
experts and sums) and against the port's single-rank run, with the checks
of ``tests/test_torch_tp.py``, at its tolerances.

On the (1, 4) mesh: one ``spawn_ranks`` of 4 gloo ranks computes every
case (``torch_tp_ranks.tp_cases`` with ``use_ep`` False) and, at the same
time, one JAX subprocess on 4 forced host devices computes the JAX
package's forward, decode and training step with ``make_ctx(...,
use_ep=False)`` on a mesh of Auto axes (ROADMAP R5) and the planner's
parameter specs.  The configs: the smoke configs of dbrx-132b,
deepseek-v2-236b (MLA, a shared expert split over the model axis) and
jamba-1.5-large-398b (a Mamba layer before its MoE layer), and dbrx's
with 6 experts (``torch_tp_ranks.REPLICATED_EXPERTS``: 4 ranks do not
divide them).  The (2, 2) mesh's run is
``tests/test_torch_tp_moe_dense_2x2.py``'s.
"""
import numpy as np
import pytest

from repro_torch.configs import smoke_config
from test_torch_tp import (BASE, MESHES, MOE_ARCHS, STEP_TOL, TOKENS, _ar,
                           _gather,
                           check_tp_batcher_ranks_emit_the_same_tokens,
                           check_tp_forward_and_decode_match_jax,
                           check_tp_forward_and_decode_match_single_rank,
                           check_tp_init_gathers_to_the_single_draw,
                           check_tp_step_matches_jax,
                           check_tp_step_matches_single_rank, mesh_runs,
                           model_cases, single)
from torch_tp_ranks import REPLICATED_EXPERTS, tp_config

ARCHS = MOE_ARCHS + (REPLICATED_EXPERTS,)
TEMPERATURE = 0.8   # the batcher's: sampled, the ranks' generators alike
GRAD_FAULTS = [("weights_no_copy", "dbrx-132b"),
               ("router_copy", "dbrx-132b")]


def dense_cases(mesh, archs) -> dict:
    """The model, init, batcher and wire-bytes cases of ``archs`` and the
    planted gradient faults, every one without expert parallelism."""
    cases = model_cases(mesh, archs)
    for arch in archs:
        cases[f"batcher|{arch}|{TEMPERATURE}"] = {
            "kind": "batcher", "arch": arch, "temperature": TEMPERATURE,
            "requests": [[5, 17, 300, 2], [9, 9, 41], [250, 3, 77, 12, 8]]}
        cases[f"bytes|{arch}"] = {"kind": "bytes", "arch": arch,
                                  "tcfg": BASE}
    for fault, arch in GRAD_FAULTS:
        cases[f"grad_fault|{fault}"] = {"kind": "grad_fault", "arch": arch,
                                        "fault": fault, "tcfg": BASE}
    for case in cases.values():
        case["use_ep"] = False
    return cases


def dense_runs(mesh, tmp_path_factory, archs):
    return mesh_runs(mesh, tmp_path_factory.mktemp(
        "moe_dense{}x{}".format(*mesh)), archs, dense_cases(mesh, archs),
        use_ep=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on the (1, 4) mesh's 4 ranks and on JAX's 4 devices."""
    return dense_runs(MESHES[0], tmp_path_factory, ARCHS)


def moe_dense_bytes(arch: str, tp: int, dp: int = 1) -> dict:
    """The wire bytes a rank sends in a forward on its data rank's rows
    and, on a (1, tp) mesh, in a training step (f32): the model ring's
    all-reduces of ``test_torch_tp._expected_bytes`` (the embedding, each
    row-parallel product, the loss, the clip's norm) with MLA's backward
    its three latents' all-reduces (query latent, KV latent, rope key),
    and per MoE layer one all-reduce of its tokens forward and one of
    their gradient backward where the axis splits the experts or the
    shared experts, and one of the combine weights' (T, E) gradient where
    it splits the experts; with ``dp`` data ranks, each MoE layer's
    gather of the E pick fractions over them (``route``)."""
    cfg = tp_config(arch)
    b, s = TOKENS
    b //= dp
    t = b * s
    n = t * cfg.d_model
    heads = cfg.num_heads % tp == 0
    kv = cfg.num_kv_heads % tp == 0
    ssm = bool(cfg.ssm_num_heads) and cfg.ssm_num_heads % tp == 0
    experts = cfg.num_experts % tp == 0
    shared = cfg.num_shared_experts and \
        (cfg.moe_d_ff * cfg.num_shared_experts) % tp == 0
    fwd, bwd = _ar(n, tp), _ar(n, tp)  # embedding; LM head input
    for spec in cfg.layer_specs():
        if spec.mixer == "attn" and heads:
            fwd += _ar(n, tp)
            if cfg.attention == "mla":
                bwd += sum(_ar(t * r, tp) for r in (
                    cfg.q_lora_rank, cfg.kv_lora_rank, cfg.qk_rope_head_dim))
            else:
                bwd += _ar(n, tp) + (0 if kv else 2 * _ar(
                    t * cfg.num_kv_heads * cfg.resolved_head_dim, tp))
        if spec.mixer == "mamba" and ssm:
            fwd += _ar(n, tp) + _ar(t, tp)
            bwd += _ar(n, tp) + 2 * _ar(t * cfg.ssm_state, tp) + \
                _ar(t, tp) + _ar(cfg.ssm_d_inner, tp)
        if spec.ffn == "dense" and cfg.d_ff % tp == 0:
            fwd += _ar(n, tp)
            bwd += _ar(n, tp)
        if spec.ffn == "moe":
            if experts or shared:
                fwd += _ar(n, tp)
                bwd += _ar(n, tp)
            if experts:
                bwd += _ar(t * cfg.num_experts, tp)
            if dp > 1:
                fwd += _gather(cfg.num_experts, dp)
    loss = _gather(t, tp) + _ar(2 * t, tp)
    return {"forward": fwd, "step": fwd + loss + bwd + _gather(1, tp, 8)}


def check_wire_bytes(runs, arch):
    """Every rank's bytes equal ``moe_dense_bytes``: in a forward on its
    data rank's rows, and on a (1, 4) mesh, where every exchange of a
    step is the model ring's, in a training step."""
    mesh, ranks, _, _ = runs
    want = moe_dense_bytes(arch, mesh[1], mesh[0])
    for r in ranks:
        got = r[f"bytes|{arch}"]
        assert got["forward"] == want["forward"]
        if mesh[0] == 1:
            assert got["step"] == want["step"]


def check_planted_gradient_fault(runs, fault, arch):
    """Two faults that leave the forward as it is and break a gradient:
    the combine weights cut to the rank's columns without
    ``copy_to_model`` (each rank's gradient of the router is then only
    its own experts' share) and the router reading the tokens through
    ``copy_to_model`` (its part of their gradient, whole on every rank,
    summed over the model ranks: the gradient of every leaf before the
    MoE layers grows).  Both move those leaves' gradients by more than a
    tenth of their size and five times the tolerance that the sound step
    meets (``test_tp_step_matches_single_rank``)."""
    mesh, ranks, _, data = runs
    want = single(arch, data)["grads"]
    name = f"grad_fault|{fault}"
    # each data index's gradient is of its rows: their sum is the batch's
    got = {k: sum(ranks[d * mesh[1]][name]["grads"][k]
                  for d in range(mesh[0])) for k in want}
    leaves = {"weights_no_copy": ("router",),
              "router_copy": ("embed", "norm1/scale")}[fault]
    for leaf in leaves:
        keys = [k for k in want if k.endswith(leaf)]
        assert keys, leaf
        err = max(float(np.abs(got[k] - want[k]).max()) for k in keys)
        scale = max(float(np.abs(want[k]).max()) for k in keys)
        bound = STEP_TOL["atol"] + STEP_TOL["rtol"] * scale
        assert err > 5 * bound and err > 0.1 * scale, (leaf, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_forward_and_decode_match_jax(runs, arch):
    check_tp_forward_and_decode_match_jax(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_forward_and_decode_match_single_rank(runs, arch):
    check_tp_forward_and_decode_match_single_rank(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_step_matches_jax(runs, arch):
    check_tp_step_matches_jax(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_step_matches_single_rank(runs, arch):
    check_tp_step_matches_single_rank(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_init_gathers_to_the_single_draw(runs, arch):
    check_tp_init_gathers_to_the_single_draw(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_batcher_ranks_emit_the_same_tokens(runs, arch):
    check_tp_batcher_ranks_emit_the_same_tokens(runs, arch, TEMPERATURE)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_wire_bytes_equal_the_ring_formula(runs, arch):
    check_wire_bytes(runs, arch)


@pytest.mark.parametrize("fault,arch", GRAD_FAULTS)
def test_moe_dense_planted_gradient_faults_are_caught(runs, fault, arch):
    check_planted_gradient_fault(runs, fault, arch)


def test_moe_dense_ranks_hold_their_experts(runs):
    """A rank's step splits the experts where 4 divides them (E/4 of the
    smoke configs' 4 a rank) and keeps all 6 of ``REPLICATED_EXPERTS``:
    fewer of its leaves are split over the model axis, by the three
    expert weights of each MoE layer."""
    _, ranks, _, _ = runs
    split = {a: ranks[0][f"model|{a}"]["split"] for a in ARCHS}
    n_moe = sum(s.ffn == "moe" for s in smoke_config("dbrx-132b")
                .layer_specs())
    assert split["dbrx-132b"] - split[REPLICATED_EXPERTS] == 3 * n_moe
