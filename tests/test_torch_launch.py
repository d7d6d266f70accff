"""The port's training launcher (``python -m repro_torch.launch.train``) on
the CPU, through ``run(argv)``: one process against 2 gloo ranks (ZeRO-1),
the JAX launcher's line format, its checkpoint, expert parallelism on a
data x model mesh against the JAX package's step, tensor parallelism on
one against the launcher's own single-rank run, and the refusals (no card
for the default ``--device cuda``; a model axis that does not divide the
ranks)."""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import concurrent.futures
import json
import re

import numpy as np
import pytest
import torch

from helpers import run_multidevice
from repro_torch.bridge import params_to_jax_layout
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs import smoke_config
from repro_torch.data import make_batches
from repro_torch.launch.train import checksum, run
from repro_torch.models import init_params, param_leaves
from repro_torch.optim import init_opt_state
from repro_torch.parallel import ParallelCtx, expert_flags
from torch_dp_ranks import flatten

SMOKE = ["--smoke", "--device", "cpu", "--steps", "3", "--batch", "8",
         "--seq", "32", "--log-every", "1"]
LINE = re.compile(r"step +\d+ loss=\d+\.\d{4} ce=\d+\.\d{4} "
                  r"lr=\d\.\d\de[-+]\d\d gnorm=\d+\.\d\d tok/s=[\d,]+$")


@pytest.fixture(scope="module")
def one_rank():
    return run(SMOKE)


@pytest.mark.parametrize("extra", [[], ["--microbatches", "2", "--remat",
                                        "--grad-dtype", "bf16"]],
                         ids=["zero1", "mb2_remat_bf16"])
def test_two_ranks_print_one_ranks_losses(one_rank, extra, tmp_path):
    """``--devices 2`` trains like ``--devices 1``: the same losses within
    1e-5 (bf16 gradients: their 2e-2) and lines in the JAX launcher's
    format, both ranks ending with the same parameters; with
    ``--ckpt-dir`` rank 0 writes them, with the gathered moments."""
    got = run(SMOKE + ["--devices", "2", "--ckpt-dir", str(tmp_path)]
              + extra)
    want = one_rank if not extra else run(SMOKE + extra)
    tol = 2e-2 if "bf16" in extra else 1e-5
    for a, b in zip(got["ranks"][0]["steps"], want["ranks"][0]["steps"]):
        assert a["loss"] == pytest.approx(b["loss"], rel=tol)
    assert got["lines"][0] == "mesh: {'data': 2, 'model': 1}"
    assert got["lines"][1] == want["lines"][0]
    steps = [ln for ln in got["lines"] if ln.startswith("step")]
    assert len(steps) == 3 and all(LINE.match(ln) for ln in steps)
    assert got["lines"][-1].startswith("checkpoint: ")
    a, b = got["ranks"]
    assert a["checksums"] == b["checksums"]
    assert a["backend"] == "gloo" and a["device"] == "cpu"
    assert all(s["exchange_s"] > 0 and s["wire_bytes"] > 0
               for s in a["steps"])
    share = a["opt_state_bytes"] / a["replicated_opt_state_bytes"]
    assert share == pytest.approx(0.5, abs=1e-3)  # ZeRO-1

    cfg = smoke_config("qwen2-0.5b")
    tmpl = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    path = got["lines"][-1].split(": ", 1)[1]
    params, opt, step = restore_checkpoint(cfg, path, tmpl,
                                           init_opt_state(tmpl))
    assert step == 3
    assert checksum(params) == a["checksums"]["params"]
    assert checksum(opt["m"]) == a["checksums"]["m"]
    assert checksum(opt["v"]) == a["checksums"]["v"]


def test_one_rank_lines(one_rank):
    lines = one_rank["lines"]
    assert lines[0] == "arch=qwen2-0.5b-smoke params=1.1M vocab=512 layers=2"
    assert all(LINE.match(ln) for ln in lines[1:]) and len(lines) == 4
    losses = [s["loss"] for s in one_rank["ranks"][0]["steps"]]
    assert losses[-1] < losses[0]


def test_encoder_decoder_trains_on_two_ranks_like_one(tmp_path):
    """``--arch seamless-m4t-medium --smoke``: the context comes from the
    stubs (``audio_frames``, encoded inside the loss); two ZeRO-1 ranks,
    each on its rows of tokens and frames, give one rank's losses within
    1e-5, and rank 0's checkpoint restores with its encoder and cross
    blocks."""
    argv = ["--arch", "seamless-m4t-medium"] + SMOKE
    one = run(argv)
    two = run(argv + ["--devices", "2", "--ckpt-dir", str(tmp_path)])
    assert one["lines"][0].startswith("arch=seamless-m4t-medium-smoke ")
    for a, b in zip(two["ranks"][0]["steps"], one["ranks"][0]["steps"]):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
    assert two["ranks"][0]["checksums"] == two["ranks"][1]["checksums"]
    cfg = smoke_config("seamless-m4t-medium")
    tmpl = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    params, _, step = restore_checkpoint(
        cfg, two["lines"][-1].split(": ", 1)[1], tmpl)
    assert step == 3 and len(params["cross"]) == cfg.num_layers
    assert checksum(params) == two["ranks"][0]["checksums"]["params"]


def test_default_device_needs_a_card():
    """``--device cuda`` (the default) where there is no card raises the
    port's device error; nothing trains on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(["--smoke", "--steps", "1"])


def test_model_axis_raises():
    """A model axis that does not divide ``--devices`` raises before any
    rank starts, for the cross-attention and encoder-decoder configs as
    for the others (their model axis itself is tensor parallelism now:
    tests/test_torch_tp.py)."""
    for arch in ("llama-3.2-vision-90b", "seamless-m4t-medium"):
        with pytest.raises(ValueError, match="not a multiple"):
            run(SMOKE + ["--arch", arch, "--devices", "4",
                         "--model-axis", "3"])


def test_model_axis_runs_tensor_parallel(tmp_path):
    """granite's smoke config on ``--devices 4 --model-axis 2``: a (2, 2)
    mesh whose model axis splits the layers (tensor parallelism), three
    steps whose losses are the launcher's own on one rank (the JAX
    launcher's mesh fails on jax 0.9, R5; the step itself is held against
    JAX's in tests/test_torch_tp.py); every rank ends with the same
    gathered parameters; the checkpoint holds every leaf whole in the JAX
    layout, restores whole and into a model rank's blocks."""
    from repro_torch.parallel.planner import tp_cut, _with_paths
    base = SMOKE[:3] + ["--arch", "granite-3-8b", "--steps", "3",
                        "--batch", "8", "--seq", "32", "--log-every", "1"]
    one = run(base)
    got = run(base + ["--devices", "4", "--model-axis", "2", "--ckpt-dir",
                      str(tmp_path)])
    for a, b in zip(got["ranks"][0]["steps"], one["ranks"][0]["steps"]):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-5)
    assert got["lines"][0] == "mesh: {'data': 2, 'model': 2}"
    assert got["lines"][1] == one["lines"][0]
    assert len({json.dumps(r["checksums"]) for r in got["ranks"]}) == 1
    assert all(s["wire_bytes"] > 0 for s in got["ranks"][0]["steps"])

    cfg = smoke_config("granite-3-8b")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    path = got["lines"][-1].split(": ", 1)[1]
    whole, opt, step = restore_checkpoint(cfg, path, params,
                                          init_opt_state(params))
    assert step == 3
    for name, tree in (("params", whole), ("m", opt["m"]), ("v", opt["v"])):
        assert checksum(tree) == got["ranks"][0]["checksums"][name], name
    ctx = ParallelCtx(use_ep=False, tp=2, model_rank=1)
    shard, _, _ = restore_checkpoint(cfg, path, params, ctx=ctx)
    split = 0
    for (p, a), (_, b) in zip(_with_paths(shard), _with_paths(whole)):
        want = tp_cut(p, b, cfg, ctx)
        split += want.shape != b.shape
        assert torch.equal(a, want), p
    assert split > 0


_JAX_EP_STEPS = """
import json, sys
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import smoke_config
from repro.core.types import MeshConfig, TrainConfig
from repro.optim.adamw import init_opt_state
from repro.parallel.planner import make_ctx, param_specs
from repro.train.step import make_train_step

inputs, tcfg_json, out_path = sys.argv[1:4]
data = np.load(inputs)
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
mcfg = MeshConfig((2, 2))
cfg = smoke_config("dbrx-132b")
tree = {}
for key in data.files:
    if key.startswith("params|"):
        *path, leaf = key.split("|", 1)[1].split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(data[key])
shard = lambda sp: NamedSharding(mesh, sp)
params = jax.device_put(tree, jax.tree.map(
    shard, param_specs(cfg, mcfg), is_leaf=lambda x: isinstance(x, P)))
opt = init_opt_state(params)
step = jax.jit(make_train_step(cfg, TrainConfig(**json.loads(tcfg_json)),
                               make_ctx(mesh, mcfg, remat=False)))
losses = []
for i in range(int(data["steps"])):
    batch = jax.device_put({k: jnp.asarray(data[f"batch{i}|{k}"])
                            for k in ("tokens", "labels")},
                           shard(P("data", None)))
    params, opt, m = step(params, opt, batch)
    losses.append(float(m["loss"]))
np.savez(out_path, losses=np.asarray(losses))
print("OK")
"""


def test_model_axis_runs_expert_parallel_moe(tmp_path):
    """dbrx's smoke config on ``--devices 4 --model-axis 2``: a (2, 2) mesh
    whose model axis runs the MoE layers expert-parallel, two steps whose
    losses are the JAX package's EP step's (``make_ctx`` on an Auto-axis
    mesh, R5: the JAX launcher's own mesh fails on jax 0.9) from the same
    parameters and batches; every rank ends with the same gathered
    parameters; the checkpoint holds every expert in the JAX layout and
    restores whole and into a model rank's shard (its experts, and its
    blocks of the leaves the model axis splits beside them)."""
    from repro_torch.parallel.planner import tp_cut, _with_paths
    argv = SMOKE[:3] + ["--arch", "dbrx-132b", "--steps", "2", "--batch",
                        "8", "--seq", "32", "--devices", "4",
                        "--model-axis", "2", "--ckpt-dir", str(tmp_path)]
    cfg = smoke_config("dbrx-132b")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    data = {f"params|{k}": v for k, v in
            flatten(params_to_jax_layout(cfg, params)).items()}
    batches = make_batches(cfg, 8, 32, seed=0)
    for i in range(2):
        for k, v in next(batches).items():
            data[f"batch{i}|{k}"] = v
    data["steps"] = np.asarray(2)
    np.savez(tmp_path / "inputs.npz", **data)
    tcfg = dict(learning_rate=3e-3, warmup_steps=10, total_steps=2,
                microbatches=1, grad_dtype="f32")
    script = (f"import sys; sys.argv = ['', "
              f"{str(tmp_path / 'inputs.npz')!r}, {json.dumps(tcfg)!r}, "
              f"{str(tmp_path / 'jax.npz')!r}]\n" + _JAX_EP_STEPS)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(run_multidevice, script, num_devices=4,
                              timeout=300)
        got = run(argv)
        jax_run.result()
    want = np.load(tmp_path / "jax.npz")["losses"]
    losses = [s["loss"] for s in got["ranks"][0]["steps"]]
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    assert got["lines"][0] == "mesh: {'data': 2, 'model': 2}"
    n = sum(t.numel() for t in param_leaves(params))
    assert got["lines"][1].startswith(f"arch=dbrx-132b-smoke "
                                      f"params={n / 1e6:.1f}M")
    assert len({json.dumps(r["checksums"]) for r in got["ranks"]}) == 1

    path = got["lines"][-1].split(": ", 1)[1]
    whole, opt, step = restore_checkpoint(cfg, path, params,
                                          init_opt_state(params))
    assert step == 2
    for name, tree in (("params", whole), ("m", opt["m"]), ("v", opt["v"])):
        assert checksum(tree) == got["ranks"][0]["checksums"][name], name
    ctx = ParallelCtx(use_ep=True, tp=2, model_rank=1)
    shard, _, _ = restore_checkpoint(cfg, path, params, ctx=ctx)
    for (p, a), (_, b), e in zip(_with_paths(shard), _with_paths(whole),
                                 expert_flags(whole)):
        want = b[b.shape[0] // 2:] if e else tp_cut(p, b, cfg, ctx)
        assert torch.equal(a, want), p
