"""Rank functions of the port's multi-rank tests, run by
``repro_torch.launch.ranks.spawn_ranks``.  A spawned rank imports this
module by name, so it imports torch and the port only (no jax), and every
function here is at top level."""
import numpy as np
import torch

from repro_torch.ccl import primitives as prim
from repro_torch.launch.ranks import torus_groups

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy()


def ccl_cases(rank: int, world: int, inputs_path: str, schedules: dict
              ) -> dict:
    """Every collective case of ``tests/test_torch_ccl.py`` on this rank.

    ``inputs_path`` is an .npz of f32 arrays, one per case, stacked over
    ranks on axis 0, keyed ``kind|label|dtype``; ``schedules`` maps a
    label to a ``repro_torch.ccl.synth.SynthSchedule``.  Returns this
    rank's result per key, as f32 numpy."""
    data = np.load(inputs_path)
    out = {}
    for key in data.files:
        kind, label, dtype = key.split("|")
        x = torch.from_numpy(data[key][rank]).to(_DTYPES[dtype])
        if kind == "ar":
            got = prim.IMPLEMENTATIONS[label](x)
        elif kind == "bidir":
            got = prim.bidir_ring_all_reduce(x)
        elif kind == "ag":
            got = prim.ring_all_gather(x).reshape(-1)
        elif kind == "rs":
            got = prim.ring_reduce_scatter(x)
        elif kind in ("q8", "q4"):
            got = prim.compressed_ring_all_reduce(x, bits=int(kind[1:]))
        elif kind == "synth":
            got = prim.make_synthesized(schedules[label])(x)
        elif kind == "synth_q8":
            got = prim.make_synthesized(schedules[label], bits=8)(x)
        elif kind == "gather":
            got = prim.synthesized_collective(x, schedules[label])
        elif kind == "torus":
            rows, cols = map(int, label.split("x"))
            row_group, col_group = torus_groups(rows, cols)
            got = prim.torus2d_all_reduce(x, row_group, col_group)
        else:
            raise KeyError(key)
        if got.dtype != x.dtype:
            raise TypeError(f"{key}: result {got.dtype}, input {x.dtype}")
        out[key] = _f32(got)
    return out


def _qdq(v, bits):
    """quantize_ref (per tensor) then dequantize_ref, in IEEE f32."""
    qmax = np.float32(2 ** (bits - 1) - 1)
    scale = np.maximum(np.abs(v).max(), np.float32(1e-30)) / qmax
    q = np.clip(np.rint(v / scale), -qmax, qmax)
    return q.astype(np.float32) * scale


def _ring_reduced(x, bits):
    """The reduce-scatter of the JAX package's compressed ring in numpy
    f32: each chunk's sum before its all-gather encode (rank r's buffer is
    chunk r + 1; returned in chunk order), and the payload's length."""
    p = x.shape[0]
    flat = x.reshape(p, -1)
    n = flat.shape[1]
    chunks = np.pad(flat, ((0, 0), (0, (-n) % p))).reshape(p, p, -1)
    buf = [chunks[r, r] for r in range(p)]
    for s in range(p - 1):
        buf = [_qdq(buf[(r - 1) % p], bits) + chunks[r, (r - s - 1) % p]
               for r in range(p)]
    return [buf[(c - 1) % p] for c in range(p)], n


def compressed_ring_emulation(x, bits):
    """The JAX package's compressed ring (primitives.py:130-178), hop by
    hop, in numpy f32: rank r's buffer after the reduce-scatter is chunk
    r + 1, and every rank ends with chunk c decoded from rank c - 1."""
    reduced, n = _ring_reduced(x, bits)
    out = np.stack([_qdq(b, bits) for b in reduced])
    return np.broadcast_to(out.reshape(-1)[:n].reshape(x.shape[1:]),
                           x.shape)


def compressed_ring_final_scale(x, bits) -> float:
    """The largest of the scales with which the compressed ring encodes
    its reduced chunks for the all-gather (one quantization step of the
    result)."""
    reduced, _ = _ring_reduced(x, bits)
    qmax = np.float32(2 ** (bits - 1) - 1)
    return float(max(np.maximum(np.abs(b).max(), np.float32(1e-30)) / qmax
                     for b in reduced))


def ring_q8_on_card(rank: int, world: int, n: int, seed: int) -> dict:
    """ring_q8 over a gloo group with CUDA tensors: each rank's payload from
    its own seed; returns the result and the launches of K2a and K2b."""
    from repro_torch.kernels.compress import ops

    gen = torch.Generator().manual_seed(seed + rank)
    x = torch.randn(n, generator=gen).cuda()
    before = (ops.quantize_kernel.launches, ops.dequantize_kernel.launches)
    got = prim.IMPLEMENTATIONS["ring_q8"](x)
    torch.cuda.synchronize()
    return {"result": got.cpu().numpy(), "device": str(got.device),
            "quantize": ops.quantize_kernel.launches - before[0],
            "dequantize": ops.dequantize_kernel.launches - before[1]}


def fail_on_rank_one(rank: int, world: int) -> int:
    if rank == 1:
        raise ValueError("rank one fails")
    return rank


def synth_sent_bytes(rank: int, world: int, inputs_path: str,
                     schedules: dict) -> dict:
    """``ccl_cases`` for the synthesized kinds, with the bytes this rank
    put on the wire for each case (``_permute.sent_bytes``): returns
    ``{key: (result, sent_bytes)}``."""
    data = np.load(inputs_path)
    out = {}
    for key in data.files:
        kind, label, _ = key.split("|")
        x = torch.from_numpy(data[key][rank])
        before = prim._permute.sent_bytes
        if kind == "gather":
            got = prim.synthesized_collective(x, schedules[label])
        else:
            got = prim.make_synthesized(
                schedules[label], bits=8 if kind == "synth_q8" else None)(x)
        out[key] = (_f32(got), prim._permute.sent_bytes - before)
    return out


class FakeClock:
    """A clock that advances ``step`` seconds a reading: probes timed by it
    measure ``step`` a run, in either package."""

    def __init__(self, step: float = 1e-3):
        self.t, self.step = 0.0, step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


def probe_ranks(rank: int, world: int, impls, sizes, fake: bool) -> dict:
    """``obs.probe.probe_suite`` on this CPU rank (a fake clock where
    ``fake``): the probes as dicts, each probe's check, and this rank's
    slice of the probe buffer of the first size."""
    from repro_torch.obs import probe

    clock = FakeClock() if fake else probe.time.perf_counter
    probes = probe.probe_suite(impls, sizes, device="cpu", clock=clock)
    return {"probes": [p.to_dict() for p in probes],
            "checks": list(probe.probe_suite.checks),
            "operand": probe.probe_operand(sizes[0], world, rank).numpy()}
