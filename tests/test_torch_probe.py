"""The port's collective probe (``repro_torch.obs.probe``) on 4 gloo CPU
ranks against the JAX package's ``repro.obs.probe`` on 4 forced host
devices.

Both sides run ``probe_suite`` over every executable of
``MODEL_EQUIVALENTS`` at three sizes (one that does not split evenly over
the ranks), each timed by one fake clock that advances 1 ms a reading, so
their probes must be equal field for field: the measured seconds (the
clock's), the model's seconds and terms (``ccl.cost``), the world and the
device kind.  On the port's side, every rank must return the same probes,
each result must lie within its collective's tolerance of the f64 sum of
the ranks' slices, each rank's slice must be the reference's buffer bit
for bit, and the bytes a rank sends must be the executable's.  The JAX
side runs in a subprocess (``helpers.run_multidevice``) beside the ranks.
"""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import json
import math
import threading

import numpy as np
import pytest

from helpers import run_multidevice
from repro.ccl.cost import CostParams as RefParams
from repro.ccl.cost import algo_cost, cost_terms
from repro.obs import probe as ref_probe
from repro_torch.ccl.primitives import MODEL_EQUIVALENTS
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.obs import probe
from repro_torch.obs.trace import validate_chrome
from torch_ccl_ranks import probe_ranks

P = 4
IMPLS = tuple(MODEL_EQUIVALENTS)
SIZES = (1 << 10, 1 << 16, 1000)

_JAX_SCRIPT = """
import json, sys
import jax
import numpy as np
import jax.numpy as jnp
from repro.obs.probe import probe_suite

class FakeClock:
    def __init__(self, step=1e-3):
        self.t, self.step = 0.0, step
    def __call__(self):
        self.t += self.step
        return self.t

impls, sizes, out_path = json.loads(sys.argv[1]), json.loads(sys.argv[2]), \\
    sys.argv[3]
probes = probe_suite(impls, sizes, clock=FakeClock())
elems = max(sizes[0] // 4, len(jax.devices()))
elems += (-elems) % len(jax.devices())
buf = (jnp.arange(elems, dtype=jnp.float32) % 13.0) / 16.0 - 0.4
with open(out_path, "w") as f:
    json.dump({"probes": [p.to_dict() for p in probes],
               "buffer": np.asarray(buf).view(np.uint32).tolist()}, f)
print("OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX side (a subprocess) and the port's 4 ranks, started
    together: (the reference's output, the ranks' results)."""
    out_path = tmp_path_factory.mktemp("probe") / "ref.json"
    script = _JAX_SCRIPT.replace(
        "sys.argv[1]", repr(json.dumps(list(IMPLS)))).replace(
        "sys.argv[2]", repr(json.dumps(list(SIZES)))).replace(
        "sys.argv[3]", repr(str(out_path)))
    err = []

    def jax_side():
        try:
            run_multidevice(script, num_devices=P)
        except BaseException as e:  # noqa: BLE001 - raised below
            err.append(e)

    thread = threading.Thread(target=jax_side)
    thread.start()
    ranks = spawn_ranks(probe_ranks, P, IMPLS, SIZES, True)
    thread.join()
    if err:
        raise err[0]
    with open(out_path) as f:
        ref = json.load(f)
    return ref, ranks


def test_ranks_agree_on_every_field(runs):
    _, ranks = runs
    assert len(ranks[0]["probes"]) == len(IMPLS) * len(SIZES)
    for r in ranks[1:]:
        assert r["probes"] == ranks[0]["probes"]


def test_probes_equal_the_references_under_one_clock(runs):
    """Every field of every probe, JSON-equal in key order: the fake
    clock's seconds, the model's seconds and terms, world and device."""
    ref, ranks = runs
    assert json.dumps(ranks[0]["probes"]) == json.dumps(ref["probes"])
    for d in ranks[0]["probes"]:
        back = probe.CollectiveProbe.from_dict(json.loads(json.dumps(d)))
        assert back.to_dict() == d
        assert ref_probe.CollectiveProbe.from_dict(d).to_dict() == d


@pytest.mark.parametrize("impl", IMPLS)
def test_model_is_bit_equal_to_reference_cost(runs, impl):
    _, ranks = runs
    cp = RefParams()
    for d in ranks[0]["probes"]:
        if d["impl"] != impl:
            continue
        algo = MODEL_EQUIVALENTS[impl]
        assert d["algorithm"] == algo
        assert d["modeled_s"] == algo_cost("all_reduce", algo,
                                           d["size_bytes"], P, cp)
        assert d["model_terms"] == cost_terms("all_reduce", algo,
                                              d["size_bytes"], P, cp)


def test_operand_is_the_references_buffer(runs):
    """Each rank holds its quarter of the reference's buffer, bit for
    bit, and the quarters tile it."""
    ref, ranks = runs
    port = np.concatenate([r["operand"] for r in ranks])
    want = np.asarray(ref["buffer"], dtype=np.uint32).view(np.float32)
    assert port.dtype == np.float32
    assert np.array_equal(port.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("impl", IMPLS)
def test_results_match_the_f64_sum(runs, impl):
    _, ranks = runs
    checks = [c for r in ranks for c in r["checks"] if c["impl"] == impl]
    assert len(checks) == P * len(SIZES)
    for c in checks:
        assert c["err_over_tol"] <= 1.0, c
        assert c["device"] == "cpu"
    if impl in ("ring", "bidir_ring", "recursive_doubling"):
        # the slices' values are multiples of 1/16 shifted by one f32
        # constant: four of them sum within a few ulps of the exact sum
        assert max(c["max_abs_err"] for c in checks) < 1e-6


def _wire_bytes(impl: str, operand: int) -> int:
    """Bytes a rank sends for one all-reduce of ``operand`` bytes that
    split evenly into ``P`` chunks (see ``ccl.primitives``)."""
    steps = 2 * (P - 1)
    chunk = operand // P
    if impl in ("ring", "bidir_ring"):
        return steps * chunk
    if impl == "recursive_doubling":
        return int(math.log2(P)) * operand
    codes = chunk // 4 if impl == "ring_q8" else chunk // 8
    return steps * (codes + 4)  # one f32 scale a hop


@pytest.mark.parametrize("size", SIZES[:2])
@pytest.mark.parametrize("impl", IMPLS)
def test_operand_and_wire_bytes(runs, impl, size):
    """A rank reduces size / P bytes (ROADMAP R6: the model prices the
    whole size) and sends what its executable sends for that operand."""
    _, ranks = runs
    for r in ranks:
        (c,) = [c for c in r["checks"]
                if c["impl"] == impl and c["size_bytes"] == size]
        assert c["operand_bytes"] == size // P
        assert c["sent_bytes"] == _wire_bytes(impl, size // P)


def test_summary_and_trace_equal_the_references(runs):
    ref, ranks = runs
    mine = [probe.CollectiveProbe.from_dict(d) for d in ranks[0]["probes"]]
    theirs = [ref_probe.CollectiveProbe.from_dict(d) for d in ref["probes"]]
    summary = probe.model_vs_measured(mine)
    assert json.dumps(summary) == json.dumps(
        ref_probe.model_vs_measured(theirs))
    assert summary["count"] == len(mine)
    assert summary["min_ratio"] <= summary["geomean_ratio"] <= \
        summary["max_ratio"]
    doc = probe.probes_to_trace(mine).to_chrome()
    assert validate_chrome(doc) == []
    assert json.dumps(doc) == json.dumps(
        ref_probe.probes_to_trace(theirs).to_chrome())


def test_unknown_implementation_raises():
    with pytest.raises(ValueError, match="unknown implementation"):
        probe.probe_all_reduce("nope", 1 << 12, device="cpu")
    with pytest.raises(ValueError, match="unknown implementation"):
        probe.probe_suite(("tree",), (1 << 12,), device="cpu")
