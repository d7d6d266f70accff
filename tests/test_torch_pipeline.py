"""The port's collective matmul (``repro_torch.parallel.collective_matmul``)
and pipelines (``repro_torch.parallel.pipeline``) on 4 gloo ranks of the
CPU (``torch_tp_ranks.pipeline_cases``), against the JAX package's on 4
forced host devices and against the sequential composition: the scripts of
``tests/test_collective_matmul.py`` and ``tests/test_system.py:107-176``
on shared numpy inputs.  The JAX pipelines' gradients need ``jax.set_mesh``
on jax 0.9.0 (ROADMAP R1), so the port's are held against the gradient of
the sequential composition; their forwards against both."""
import concurrent.futures

import numpy as np
import pytest
import torch

from helpers import run_multidevice
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.parallel.pipeline import (bubble_fraction, iteration_time,
                                           schedule)
from torch_tp_ranks import pipeline_cases

P_, V = 4, 2
M, MB, D = 8, 2, 16        # tests/test_system.py's GPipe case
IM, ID = 6, 8              # and its interleaved case
CMM = dict(m=8 * P_, k=16, n=12 * P_, k2=16 * P_)

_JAX_SCRIPT = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, PartitionSpec as P
from repro.parallel.collective_matmul import ag_matmul, matmul_rs
from repro.parallel.pipeline import (interleaved_pipeline_apply,
                                     make_pipeline_fn)

inputs, out_path = sys.argv[1:3]
d = {k: jnp.asarray(v) for k, v in np.load(inputs).items()}
p = 4
mesh = jax.make_mesh((p,), ("x",), axis_types=(AxisType.Auto,))
out = {}
out["ag"] = np.asarray(jax.jit(jax.shard_map(
    lambda xl, wl: ag_matmul(xl, wl, "x", p), mesh=mesh,
    in_specs=(P("x", None), P(None, "x")), out_specs=P(None, "x")))(
        d["cmm|x"], d["cmm|w"]))
out["rs"] = np.asarray(jax.jit(jax.shard_map(
    lambda xl, wl: matmul_rs(xl, wl, "x", p), mesh=mesh,
    in_specs=(P(None, "x"), P("x", None)), out_specs=P("x", None)))(
        d["cmm|x2"], d["cmm|w2"]))
pmesh = jax.make_mesh((p,), ("pipe",), axis_types=(AxisType.Auto,))
stage = lambda w, x: jnp.tanh(x @ w)
out["pipe"] = np.asarray(make_pipeline_fn(stage, pmesh, "pipe")(
    d["pipe|w"], d["pipe|x"]))
out["ipipe"] = np.asarray(jax.jit(jax.shard_map(
    lambda wl, xa: interleaved_pipeline_apply(stage, wl[0], xa, "pipe", p,
                                              2),
    mesh=pmesh, in_specs=(P("pipe"), P()), out_specs=P()))(
        d["ipipe|w"], d["ipipe|x"]))
np.savez(out_path, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    rng = np.random.default_rng(0)
    f32 = np.float32
    data = {
        "cmm|x": rng.standard_normal((CMM["m"], CMM["k"])).astype(f32),
        "cmm|w": (0.3 * rng.standard_normal((CMM["k"], CMM["n"]))).astype(
            f32),
        "cmm|x2": rng.standard_normal((CMM["m"], CMM["k2"])).astype(f32),
        "cmm|w2": (0.3 * rng.standard_normal((CMM["k2"], CMM["n"])))
        .astype(f32),
        "pipe|w": (0.2 * rng.standard_normal((P_, D, D))).astype(f32),
        "pipe|x": rng.standard_normal((M, MB, D)).astype(f32),
        "ipipe|w": (0.3 * rng.standard_normal((P_, V, ID, ID))).astype(f32),
        "ipipe|x": rng.standard_normal((IM, MB, ID)).astype(f32)}
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **data)
    script = (f"import sys; sys.argv = ['', {inputs!r}, "
              f"{str(tmp / 'jax.npz')!r}]\n" + _JAX_SCRIPT)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(run_multidevice, script, num_devices=P_,
                              timeout=300)
        ranks = spawn_ranks(pipeline_cases, P_, inputs, timeout_s=300)
        jax_run.result()
    return ranks, dict(np.load(tmp / "jax.npz")), data


def _sequential(data, name: str):
    """(y, dL/dw, dL/dx) of the sequential composition, L = sum(y^2);
    virtual stage k = rank k % p, chunk k // p."""
    w = torch.from_numpy(data[f"{name}|w"]).requires_grad_(True)
    x = torch.from_numpy(data[f"{name}|x"]).requires_grad_(True)
    y = x
    for k in range(P_ * (V if name == "ipipe" else 1)):
        wk = w[k] if name == "pipe" else w[k % P_, k // P_]
        y = torch.tanh(y @ wk)
    (y ** 2).sum().backward()
    return y.detach().numpy(), w.grad.numpy(), x.grad.numpy()


def test_ag_matmul_and_matmul_rs_match_jax(runs):
    """Each rank's block against JAX's ``shard_map`` of the same function
    (atol 1e-4, tests/test_collective_matmul.py) and against the bulk
    forms: the all-gather then one product, and the block of x @ W."""
    ranks, jax_out, data = runs
    n = CMM["n"] // P_
    m = CMM["m"] // P_
    full = data["cmm|x2"] @ data["cmm|w2"]
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["ag"], jax_out["ag"][:, r * n:
                                                           (r + 1) * n],
                                   atol=1e-4)
        np.testing.assert_allclose(got["ag"], got["ag_bulk"], atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(got["rs"],
                                   jax_out["rs"][r * m:(r + 1) * m],
                                   atol=1e-4)
        np.testing.assert_allclose(got["rs"], full[r * m:(r + 1) * m],
                                   atol=1e-4)


def test_collective_matmul_wire_bytes(runs):
    """p - 1 hops a rank: of x's row block (``ag_matmul``), of an output
    row block (``matmul_rs``)."""
    ranks, _, _ = runs
    for got in ranks:
        assert got["ag_bytes"] == (P_ - 1) * (CMM["m"] // P_) * CMM["k"] * 4
        assert got["rs_bytes"] == (P_ - 1) * (CMM["m"] // P_) * CMM["n"] * 4


@pytest.mark.parametrize("name", ["pipe", "ipipe"])
def test_pipeline_matches_jax_and_the_sequential_model(runs, name):
    """GPipe over 4 stages and the interleaved schedule with v = 2: the
    outputs on every rank against JAX's and the sequential composition's
    (atol 1e-5), each rank's stage gradients and the input's gradient
    against the sequential composition's (atol 1e-4,
    tests/test_system.py)."""
    ranks, jax_out, data = runs
    y, gw, gx = _sequential(data, name)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"{name}|y"], jax_out[name],
                                   atol=1e-5)
        np.testing.assert_allclose(got[f"{name}|y"], y, atol=1e-5)
        np.testing.assert_allclose(got[f"{name}|grad_w"], gw[r], atol=1e-4)
    # the input's gradient: stage 0's, summed to every rank (interleaved;
    # make_pipeline_fn's x needs none and gets it all the same)
    for got in ranks:
        np.testing.assert_allclose(got[f"{name}|grad_x"], gx, atol=1e-4)


def test_pipeline_wire_bytes(runs):
    """GPipe's forward: each stage but the last sends its M outputs to the
    next, then the all-reduce that hands the last stage's outputs to every
    rank; its backward: each stage but the first sends M input gradients
    back, then the all-reduce of the input's gradient."""
    ranks, _, _ = runs
    act = MB * D * 4
    ar = 2 * (P_ - 1) * (M * MB * D // P_) * 4
    for r, got in enumerate(ranks):
        fwd, bwd = got["pipe|bytes"]
        assert fwd == (M * act if r < P_ - 1 else 0) + ar
        assert bwd == (M * act if r > 0 else 0) + ar


def test_bubble_fraction_and_schedule():
    """PTD-P's bubble (tests/test_system.py:126-127) and the schedules'
    length: GPipe takes M + p - 1 ticks, each microbatch through every
    stage once; the interleaved one every microbatch through v p virtual
    stages, v chunks a rank."""
    assert abs(bubble_fraction(4, 8, 1) - 3 / 8) < 1e-9
    assert abs(bubble_fraction(4, 8, 2) - 3 / 16) < 1e-9
    assert iteration_time(4, 8, 2, 1.0) == pytest.approx((16 + 3) / 2)
    ticks = schedule(4, 8, 1)
    assert len(ticks) == 8 + 4 - 1
    jobs = [(d, j) for row in ticks for d, j in enumerate(row) if j]
    assert len(jobs) == 4 * 8
    assert all(j.chunk == 0 for _, j in jobs)
    ijobs = [(d, j) for row in schedule(4, 6, 2) for d, j in enumerate(row)
             if j]
    assert len(ijobs) == 6 * 2 * 4
    for mb in range(6):
        mine = [(d, j.chunk) for d, j in ijobs if j.mb == mb]
        assert mine == [(k % 4, k // 4) for k in range(8)]
