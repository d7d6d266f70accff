"""What decides ``correct``, driven through the harness on the CPU at a
small size (the port's plain kernels, gloo ranks for the ZeRO-1 cell):

- a sound run of each cell comes out correct, the reference following the
  port's step (one rank, and ZeRO-1 on 4 gloo ranks);
- each fault the cell can have, planted in the program underneath a run
  that skips the look for a card, makes it come out not correct: a step
  that returns its state unchanged, half of the batch left out, the
  exchange between the ranks left out, the loss altered where it is
  produced;
- the control (the reference one step of precision down, fp8, in the
  program's place) comes out not correct.

The limits are the committed ones of each cell: the CPU's bf16 step
reads within them as the card's does.
"""
import time

import pytest
import torch

from cb.train_cell import readings, run_cell
from cells import small_cell

SEED = 2 ** 31 + 77


def _run(name, fault=None, trace=False):
    torch.manual_seed(0)
    return run_cell(small_cell(name), SEED, 0.5, trace, time.time(),
                    device="cpu", fault=fault)


def _correct(res):
    return res["line"]["correct"]


@pytest.mark.parametrize("name", ["qwen2-train-4k", "dbrx-1l-train-4k",
                                  "dbrx-1l-zero1-dp4"])
def test_sound_run_is_correct(name):
    res = _run(name)
    line = res["line"]
    assert _correct(res), line["checks"]
    assert res["modules"] == []
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"tokens_per_s", "step_ms_p90",
                                    "setup_s"}
    assert line["attempted"] >= 1 and line["failed"] == 0
    # the readings that the cell's file gives no limit are printed apart
    assert set(line["checks"]) == set(small_cell(name).limits)
    assert set(res["not_compared"]) == {"loss_steps_gap"} | (
        {"grad_leaf_gap"} if name == "dbrx-1l-train-4k" else set())
    if name.endswith("dp4"):
        assert line["device"]["count"] == 4
        assert line["checks"]["rank_mismatch"]["value"] == 0


def test_traced_run_reports_per_layer_metrics():
    line = _run("dbrx-1l-train-4k", trace=True)["line"]
    assert _correct({"line": line})
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "mfu" in line["metrics"]
    assert "tokens_per_s" not in line["metrics"]


@pytest.mark.parametrize("name,fault", [
    ("qwen2-train-4k", "unchanged"), ("qwen2-train-4k", "half_batch"),
    ("qwen2-train-4k", "altered"), ("dbrx-1l-train-4k", "unchanged"),
    ("dbrx-1l-train-4k", "half_batch"), ("dbrx-1l-train-4k", "altered"),
    ("dbrx-1l-zero1-dp4", "unchanged"), ("dbrx-1l-zero1-dp4", "half_batch"),
    ("dbrx-1l-zero1-dp4", "no_exchange"), ("dbrx-1l-zero1-dp4", "altered")])
def test_planted_fault_is_not_correct(name, fault):
    res = _run(name, fault)
    assert not _correct(res), res["line"]["checks"]


@pytest.mark.parametrize("name", ["qwen2-train-4k", "dbrx-1l-train-4k"])
def test_control_is_not_correct(name):
    """The control run as the program: its readings against the f32
    reference fail the committed limits."""
    import control
    cell = small_cell(name)
    dev = torch.device("cpu")
    ref = control.reference_run(cell, SEED, dev)
    got = control.reference_run(cell, SEED, dev, prec="fp8")
    checks = readings(got, ref)
    assert any(checks[k] > v for k, v in cell.limits.items()), checks


@pytest.mark.parametrize("fault", ["half_batch", "local_grad", "altered"])
def test_reference_faults_read_as_the_program_s(fault):
    """The faults read in the program's place on the card (``control.py
    --variants``) fail the limits at this size too."""
    import control
    cell = small_cell("dbrx-1l-zero1-dp4")
    dev = torch.device("cpu")
    ref = control.reference_run(cell, SEED, dev)
    got = control.reference_run(cell, SEED, dev, fault=fault)
    checks = readings(got, ref)
    assert any(checks[k] > v for k, v in cell.limits.items()), checks
