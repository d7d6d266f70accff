"""The port's executable collectives on ``torch.distributed`` (gloo, 8 CPU
ranks, the JAX tests' 8 forced devices) against the JAX package and numpy.

Ports of the SCRIPT of tests/test_ccl_primitives.py (ring, bidir ring,
recursive doubling, all-gather and reduce-scatter on ragged and bf16
payloads, the compressed ring q8/q4) and of _LOWERING in
tests/test_synth.py (synthesized all-reduce on the ring8, mesh8 and
fattree schedules, q8 in the send loop, ATP, broadcast, all-gather), plus
the 2D torus on 2 x 4.  The same numpy inputs go to both sides: the JAX
results come from ``helpers.run_multidevice`` (8 forced host devices), the
port's from one ``spawn_ranks`` of 8 ranks; the schedules are built once by
``repro.ccl.synth`` and handed to the port as copies.  The port's own
synthesizer (``repro_torch.ccl.synth``) builds the same schedules, move for
move, and the port runs those too (labels ``port-<name>``, which the JAX
side skips): bit-equal to its runs of the reference's.

The port's hop algebra and f32 arithmetic are the JAX package's, so every
result, lossless or quantized, is expected bit-equal to JAX's; on top of
that each case is held to the JAX tests' own bound against the exact sum.
"""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import dataclasses
import pickle

import numpy as np
import pytest

from helpers import run_multidevice
from repro.ccl import primitives as jprim
from repro.ccl.synth import atp_schedule as jax_atp_schedule
from repro.ccl.synth import synthesize_schedule
from repro.core.demand import CommTask
from repro.net.topology import fat_tree, full_mesh, ring
from repro_torch.ccl import primitives as prim
from repro_torch.ccl.synth import Move, SynthSchedule, atp_schedule
from repro_torch.launch.ranks import spawn_ranks
from torch_ccl_ranks import (ccl_cases, compressed_ring_emulation,
                             fail_on_rank_one)

P = 8
BIDIR_SHAPES = [(1,), (7,), (33,), (50,), (5, 7), (2, 3, 5)]
DTYPES = ["float32", "bfloat16"]
# the JAX tests' tolerances against the exact sum
TOL = {"float32": 2e-6, "bfloat16": 0.06}


def _label(shape):
    return "x".join(map(str, shape))


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _inputs() -> dict:
    x = np.arange(P * 48, dtype=np.float32).reshape(P, 48) / 7.0
    data = {f"ar|{impl}|float32": x
            for impl in ("ring", "bidir_ring", "recursive_doubling")}
    for i, shape in enumerate(BIDIR_SHAPES):
        for dt in DTYPES:
            data[f"bidir|{_label(shape)}|{dt}"] = _normal((P, *shape), i)
    for n in (3, 17, 48):
        for dt in DTYPES:
            data[f"ag|{n}|{dt}"] = _normal((P, n), n)
    for n in (6, 5):
        for dt in DTYPES:
            data[f"rs|{n}|{dt}"] = _normal((P, P, n), 10 + n)
    for bits in (8, 4):
        for shape in ((48,), (37,)):
            data[f"q{bits}|{_label(shape)}|float32"] = _normal(
                (P, *shape), 20 + bits)
    # integer-valued floats: f32 sums are exact, so lossless synthesized
    # all-reduce must bit-match the sum
    xi = np.arange(P * 48, dtype=np.float32).reshape(P, 48) - 150.0
    for name in ("ring8", "mesh8", "fattree", "atp", "broadcast"):
        data[f"synth|{name}|float32"] = xi
        data[f"synth|port-{name}|float32"] = xi
    data["synth_q8|fattree|float32"] = xi
    data["synth_q8|port-fattree|float32"] = xi
    data["gather|all_gather|float32"] = xi
    data["gather|port-all_gather|float32"] = xi
    data["torus|2x4|float32"] = np.arange(P * 10, dtype=np.float32
                                          ).reshape(P, 10) - 33.0
    return data


def _schedules() -> dict:
    """The JAX package's schedules of tests/test_synth.py:_LOWERING."""
    nbytes = P * 48 * 4
    topos = {"ring8": ring(8), "mesh8": full_mesh(8),
             "fattree": fat_tree(2, 4, oversub=8.0, hosts_per_rack=1)}
    scheds = {name: synthesize_schedule(topo, CommTask(
        "t", "all_reduce", nbytes, tuple(topo.accelerators)))
        for name, topo in topos.items()}
    scheds["atp"] = jax_atp_schedule(CommTask("t", "all_reduce", nbytes,
                                              tuple(range(P))))
    scheds["broadcast"] = synthesize_schedule(
        full_mesh(8), CommTask("b", "broadcast", 48 * 4, tuple(range(P))))
    scheds["all_gather"] = synthesize_schedule(
        full_mesh(8), CommTask("g", "all_gather", nbytes, tuple(range(P))))
    return scheds


def _own_schedules() -> dict:
    """The schedules of ``_schedules`` from the port's own synthesizer."""
    from repro_torch.ccl import synth
    from repro_torch.core.demand import CommTask as PortTask
    from repro_torch.net import topology

    nbytes = P * 48 * 4
    topos = {"ring8": topology.ring(8), "mesh8": topology.full_mesh(8),
             "fattree": topology.fat_tree(2, 4, oversub=8.0,
                                          hosts_per_rack=1)}
    scheds = {name: synth.synthesize_schedule(topo, PortTask(
        "t", "all_reduce", nbytes, tuple(topo.accelerators)))
        for name, topo in topos.items()}
    scheds["atp"] = atp_schedule(PortTask("t", "all_reduce", nbytes,
                                          tuple(range(P))))
    scheds["broadcast"] = synth.synthesize_schedule(
        topology.full_mesh(8), PortTask("b", "broadcast", 48 * 4,
                                        tuple(range(P))))
    scheds["all_gather"] = synth.synthesize_schedule(
        topology.full_mesh(8), PortTask("g", "all_gather", nbytes,
                                        tuple(range(P))))
    return scheds


def _port_schedule(s) -> SynthSchedule:
    d = dataclasses.asdict(s)
    d["moves"] = [Move(**m) for m in d["moves"]]
    return SynthSchedule(**d)


_JAX_SCRIPT = """
import pickle, sys
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from repro.ccl.primitives import (IMPLEMENTATIONS, bidir_ring_all_reduce,
                                  compressed_ring_all_reduce,
                                  make_synthesized, ring_all_gather,
                                  ring_reduce_scatter, synthesized_collective,
                                  torus2d_all_reduce)

inputs, scheds_path, out_path = sys.argv[1:4]
data = np.load(inputs)
with open(scheds_path, "rb") as f:
    scheds = pickle.load(f)
mesh = jax.make_mesh((8,), ("x",))

def run(body, y, out_extra=0):
    spec = P("x", *([None] * (y.ndim - 1)))
    ospec = P("x", *([None] * (y.ndim - 1 + out_extra)))
    return jax.jit(jax.shard_map(lambda yl: body(yl[0])[None], mesh=mesh,
                                 in_specs=spec, out_specs=ospec))(y)

out = {}
for key in data.files:
    kind, label, dt = key.split("|")
    if label.startswith("port-"):  # the port's own schedules: port only
        continue
    y = jnp.asarray(data[key]).astype(dt)
    if kind == "ar":
        got = run(lambda v: IMPLEMENTATIONS[label](v, "x", 8), y)
    elif kind == "bidir":
        got = run(lambda v: bidir_ring_all_reduce(v, "x", 8), y)
    elif kind == "ag":
        got = run(lambda v: ring_all_gather(v, "x", 8).reshape(-1), y)
    elif kind == "rs":
        got = run(lambda v: ring_reduce_scatter(v, "x", 8), y, out_extra=-1)
    elif kind in ("q8", "q4"):
        got = run(lambda v: compressed_ring_all_reduce(
            v, "x", 8, bits=int(kind[1:])), y)
    elif kind == "synth":
        got = make_synthesized(scheds[label], mesh, "x")(y)
    elif kind == "synth_q8":
        got = make_synthesized(scheds[label], mesh, "x", bits=8)(y)
    elif kind == "gather":
        got = run(lambda v: synthesized_collective(v, "x", 8, scheds[label]),
                  y, out_extra=1)
    elif kind == "torus":
        mesh2 = jax.make_mesh((2, 4), ("r", "c"))
        got = jax.jit(jax.shard_map(
            lambda yl: torus2d_all_reduce(yl[0], "r", "c", 2, 4)[None],
            mesh=mesh2, in_specs=P(("r", "c"), None),
            out_specs=P(("r", "c"), None)))(y)
    assert got.dtype == y.dtype, key
    out[key] = np.asarray(got, np.float32)
np.savez(out_path, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case through both sides, once: (inputs, port, jax), each a
    dict key -> array stacked over the 8 ranks."""
    tmp = tmp_path_factory.mktemp("ccl")
    data = _inputs()
    np.savez(tmp / "inputs.npz", **data)
    scheds = _schedules()
    with open(tmp / "schedules.pkl", "wb") as f:
        pickle.dump(scheds, f)
    run_multidevice(
        f"import sys; sys.argv = ['', {str(tmp / 'inputs.npz')!r}, "
        f"{str(tmp / 'schedules.pkl')!r}, {str(tmp / 'jax.npz')!r}]\n"
        + _JAX_SCRIPT, num_devices=P)
    jax_out = dict(np.load(tmp / "jax.npz"))
    port_scheds = {k: _port_schedule(v) for k, v in scheds.items()}
    port_scheds.update({f"port-{k}": v for k, v in _own_schedules().items()})
    ranks = spawn_ranks(ccl_cases, P, str(tmp / "inputs.npz"), port_scheds,
                        timeout_s=300)
    port = {k: np.stack([r[k] for r in ranks]) for k in data}
    return data, port, jax_out


def _as(x, dtype):
    """The input as the sides saw it (bf16 values in f32)."""
    import torch
    return torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()


def _check(runs, key, want, atol=0.0, rtol=0.0, jax_atol=0.0):
    """Bit-equal to JAX's result (or within ``jax_atol`` where a test says
    why), and within (atol, rtol) of ``want``."""
    data, port, jax_out = runs
    got = port[key]
    np.testing.assert_allclose(got, jax_out[key], rtol=0, atol=jax_atol,
                               err_msg=key)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=key)


@pytest.mark.parametrize("impl", ["ring", "bidir_ring", "recursive_doubling"])
def test_all_reduce_matches_jax_and_sum(runs, impl):
    key = f"ar|{impl}|float32"
    x = runs[0][key]
    _check(runs, key, np.broadcast_to(x.sum(0), x.shape), rtol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", BIDIR_SHAPES, ids=_label)
def test_bidir_ring_ragged_and_bf16(runs, shape, dtype):
    key = f"bidir|{_label(shape)}|{dtype}"
    x = _as(runs[0][key], dtype)
    _check(runs, key, np.broadcast_to(x.sum(0), x.shape), atol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [3, 17, 48])
def test_all_gather_ragged_and_bf16(runs, n, dtype):
    key = f"ag|{n}|{dtype}"
    x = _as(runs[0][key], dtype)
    _check(runs, key, np.tile(x.reshape(1, -1), (P, 1)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [6, 5])
def test_reduce_scatter_ragged_and_bf16(runs, n, dtype):
    """Rank r ends with the sum over peers of their r-th chunk."""
    key = f"rs|{n}|{dtype}"
    x = _as(runs[0][key], dtype)
    _check(runs, key, x.sum(0), atol=TOL[dtype])


@pytest.mark.parametrize("bits,steps_factor", [(8, 127.0), (4, 7.0)])
@pytest.mark.parametrize("shape", [(48,), (37,)], ids=_label)
def test_compressed_ring_within_codec_envelope(runs, bits, steps_factor,
                                               shape):
    """Bit-equal to the JAX package's hop algebra in IEEE f32 (a numpy
    emulation of it); within p * absmax / qmax of the exact sum (each of
    the p-1 accumulation hops re-quantizes); every rank holds the
    identical result.  Against JAX's jitted ring: within 1e-6 of the
    largest sum, not bit-equal, because under jit XLA turns the scale's
    division by the constant qmax into a product with 1/qmax, 1 ulp from
    the true quotient that the port and JAX's eager ``quantize_ref``
    compute (ROADMAP Queue 3)."""
    key = f"q{bits}|{_label(shape)}|float32"
    x = runs[0][key]
    want = np.broadcast_to(x.sum(0), x.shape)
    bound = P * float(np.abs(x).max()) / steps_factor
    _check(runs, key, want, atol=bound,
           jax_atol=1e-6 * float(np.abs(want).max()))
    got = runs[1][key]
    np.testing.assert_array_equal(got, compressed_ring_emulation(x, bits))
    for r in range(1, P):
        np.testing.assert_array_equal(got[r], got[0])


@pytest.mark.parametrize("name", ["ring8", "mesh8", "fattree", "atp"])
def test_synthesized_all_reduce_lossless_is_exact(runs, name):
    key = f"synth|{name}|float32"
    x = runs[0][key]
    _check(runs, key, np.broadcast_to(x.sum(0), x.shape))


def test_synthesized_q8_within_tolerance(runs):
    """q8 in the send loop: within 2 * world * max |sum| / 127 of the exact
    sum (tests/test_synth.py:_LOWERING), and within 1e-6 of the largest
    sum of JAX's, rank by rank (not bit-equal: the jitted scale, see the
    compressed ring above).  Ranks may differ by a quantization step: a
    reduce root keeps its exact sum and forwards the quantized one, in
    JAX as here."""
    key = "synth_q8|fattree|float32"
    want = runs[0][key].sum(0)
    tol = 2 * P * float(np.abs(want).max()) / 127
    _check(runs, key, np.broadcast_to(want, runs[0][key].shape), atol=tol,
           jax_atol=1e-6 * float(np.abs(want).max()))


def test_synthesized_broadcast_is_exact(runs):
    key = "synth|broadcast|float32"
    x = runs[0][key]
    _check(runs, key, np.tile(x[:1], (P, 1)))


def test_synthesized_all_gather_is_exact(runs):
    key = "gather|all_gather|float32"
    x = runs[0][key]
    _check(runs, key, np.tile(x[None], (P, 1, 1)))


def test_torus2d_all_reduce_2x4(runs):
    """Rings along the 2-rank axis, then the 4-rank one: the exact sum."""
    key = "torus|2x4|float32"
    x = runs[0][key]
    _check(runs, key, np.broadcast_to(x.sum(0), x.shape))


@pytest.mark.parametrize("name", ["ring8", "mesh8", "fattree", "atp",
                                  "broadcast", "all_gather"])
def test_schedule_program_equals_jax(name):
    """The compiled sub-batches are the JAX package's, sub-batch for
    sub-batch, on the port's copy of each schedule."""
    sched = _schedules()[name]
    assert prim._schedule_program(_port_schedule(sched)) == \
        jprim._schedule_program(sched)


@pytest.mark.parametrize("name", ["ring8", "mesh8", "fattree", "atp",
                                  "broadcast", "all_gather"])
def test_own_schedule_equals_jax(name):
    """The port's synthesizer makes ``_port_schedule`` of the reference's
    schedule, move for move."""
    assert _own_schedules()[name] == _port_schedule(_schedules()[name])


@pytest.mark.parametrize("key", [
    "synth|{}|float32".format(n) for n in ("ring8", "mesh8", "fattree",
                                           "atp", "broadcast")] + [
    "synth_q8|fattree|float32", "gather|all_gather|float32"])
def test_own_schedule_runs_bit_equal(runs, key):
    """The port's run of its own schedule is bit-equal, rank by rank, to
    its run of the reference's (q8 in the send loop included)."""
    kind, name, dt = key.split("|")
    port = runs[1]
    np.testing.assert_array_equal(port[f"{kind}|port-{name}|{dt}"],
                                  port[key])


def test_atp_schedule_equals_jax():
    task = CommTask("t", "all_reduce", 4096, tuple(range(P)))
    for ps in (None, 3):
        assert dataclasses.asdict(atp_schedule(task, ps)) == \
            dataclasses.asdict(jax_atp_schedule(task, ps))


def test_implementation_tables_equal_jax():
    assert list(prim.IMPLEMENTATIONS) == list(jprim.IMPLEMENTATIONS)
    assert prim.MODEL_EQUIVALENTS == jprim.MODEL_EQUIVALENTS


def test_spawn_ranks_raises_with_the_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        spawn_ranks(fail_on_rank_one, 2, timeout_s=120)
