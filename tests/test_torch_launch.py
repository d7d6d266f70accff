"""The port's training launcher (``python -m repro_torch.launch.train``) on
the CPU, through ``run(argv)``: one process against 2 gloo ranks (ZeRO-1),
the JAX launcher's line format, its checkpoint, and the
refusals (no card for the default ``--device cuda``; a model axis)."""
import re

import pytest
import torch

from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs import smoke_config
from repro_torch.launch.train import checksum, run
from repro_torch.models import init_params
from repro_torch.optim import init_opt_state

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


def test_default_device_needs_a_card():
    """``--device cuda`` (the default) where there is no card raises the
    port's device error; nothing trains on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(["--smoke", "--steps", "1"])


def test_model_axis_raises():
    with pytest.raises(NotImplementedError, match="item 8"):
        run(SMOKE + ["--devices", "4", "--model-axis", "2"])
