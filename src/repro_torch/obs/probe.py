"""Wall-clock probes for the executable collectives — measured vs modeled.

The port's counterpart of ``repro.obs.probe``: the same
:class:`CollectiveProbe`, :func:`probes_to_trace` and
:func:`model_vs_measured`, with :func:`probe_all_reduce` and
:func:`probe_suite` run on every rank of a ``torch.distributed`` group
instead of on a JAX mesh.

:func:`probe_all_reduce` runs one executable implementation of
``repro_torch.ccl.primitives`` on this rank's slice of the reference's
deterministic buffer (``(arange(elems) % 13) / 16 - 0.4`` in f32, ``elems``
rounded up to a multiple of the world): the JAX package shards that buffer
over its mesh axis, so each device reduces ``size_bytes / p`` of it, and
the port keeps that operand.  Each timed run is bracketed by a barrier and,
on the card, ``torch.cuda.synchronize()`` before ``clock()`` and after the
call, the analogue of ``block_until_ready``; one all-reduce (MAX) of the
elapsed seconds, outside the span, gives every rank the slowest rank's
time, the collective's wall time.  Each :class:`CollectiveProbe` carries
the measurement next to the closed-form prediction that ``ccl.cost`` makes
for the same (algorithm, size, world) — priced, as in the reference, at
the whole ``size_bytes``, not the operand (ROADMAP R6).  The result of the
last run is held to the f64 sum of the ranks' slices
(:data:`PROBE_TOL_NOTE`); :attr:`probe_all_reduce.last_check` keeps that
check, the operand's bytes and the bytes this rank sent.

Over gloo the card's payloads are staged through the host
(``ccl.primitives._permute``): the span is the collective as the port runs
it.  ``torch`` is imported inside the probe functions, so the module (and
the trace helpers) load without it, as the reference's load without jax.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.obs.trace import Trace

PROBE_TOL_NOTE = ("lossless: 1e-6 x the sum of the slices' magnitudes "
                  "(rounding of a sum in any order); ring_q8 / ring_q4: "
                  "p x absmax / qmax (tests/test_ccl_primitives.py)")


@dataclass
class CollectiveProbe:
    """One (implementation, size) measurement next to its prediction."""

    impl: str                 # executable name (ccl.primitives)
    algorithm: str            # the priced equivalent (MODEL_EQUIVALENTS)
    size_bytes: int
    world: int                # ranks in the group
    measured_s: float         # min over timed runs (the standard estimator)
    modeled_s: float          # algo_cost prediction under the CostParams
    runs_s: List[float] = field(default_factory=list)
    model_terms: Dict[str, float] = field(default_factory=dict)
    primitive: str = "all_reduce"
    device_kind: str = "cpu"

    @property
    def ratio(self) -> Optional[float]:
        """measured / modeled (None when the model predicts 0)."""
        return self.measured_s / self.modeled_s if self.modeled_s > 0 \
            else None

    def to_dict(self) -> Dict:
        return {"impl": self.impl, "algorithm": self.algorithm,
                "size_bytes": self.size_bytes, "world": self.world,
                "measured_s": self.measured_s, "modeled_s": self.modeled_s,
                "runs_s": list(self.runs_s),
                "model_terms": dict(self.model_terms),
                "primitive": self.primitive,
                "device_kind": self.device_kind}

    @classmethod
    def from_dict(cls, d: Dict) -> "CollectiveProbe":
        return cls(impl=d["impl"], algorithm=d["algorithm"],
                   size_bytes=d["size_bytes"], world=d["world"],
                   measured_s=d["measured_s"], modeled_s=d["modeled_s"],
                   runs_s=list(d.get("runs_s", [])),
                   model_terms=dict(d.get("model_terms", {})),
                   primitive=d.get("primitive", "all_reduce"),
                   device_kind=d.get("device_kind", "cpu"))


def probe_operand(size_bytes: int, world: int, rank: int, device="cpu"):
    """Rank ``rank``'s slice of the probe buffer: ``(arange(elems) % 13) /
    16 - 0.4`` in f32, ``elems`` = ``size_bytes / 4``, at least one a rank,
    rounded up to a multiple of ``world`` (the reference's rounding, so the
    buffer shards evenly); no PRNG, so probe results are reproducible
    modulo the clock."""
    import torch
    elems = max(size_bytes // 4, world)
    per = (elems + (-elems) % world) // world
    idx = torch.arange(rank * per, (rank + 1) * per, dtype=torch.float32,
                       device=device)
    return torch.remainder(idx, 13.0) / 16.0 - 0.4


def _expected(size_bytes: int, world: int, device):
    """The f64 sum of the ranks' slices, their summed magnitudes and the
    largest magnitude of any slice."""
    parts = [probe_operand(size_bytes, world, r, device).double()
             for r in range(world)]
    truth = sum(parts)
    sabs = sum(p.abs() for p in parts)
    amax = max(float(p.abs().max()) for p in parts)
    return truth, sabs, amax


def _err_over_tol(impl: str, got, truth, sabs, amax: float,
                  world: int) -> Dict:
    err = (got.double() - truth).abs()
    if impl in ("ring_q8", "ring_q4"):
        qmax = 127 if impl == "ring_q8" else 7
        tol = world * amax / qmax
        ratio = float(err.max()) / tol
    else:
        tol = None
        ratio = float((err / (1e-6 * sabs)).max())
    return {"max_abs_err": float(err.max()), "tol": tol,
            "err_over_tol": ratio}


def probe_all_reduce(impl: str, size_bytes: int, group=None,
                     params=None, repeats: int = 3, warmup: int = 1,
                     clock: Callable[[], float] = time.perf_counter,
                     device=None) -> CollectiveProbe:
    """Measure one executable all-reduce and pair it with its prediction.

    Called on every rank of ``group`` (``None``: the default group), which
    must be initialised.  ``impl`` names a ``ccl.primitives.
    IMPLEMENTATIONS`` entry; the operand lies on ``device`` (the card
    unless the caller says ``"cpu"``).  ``warmup`` runs come first, then
    ``repeats`` timed ones (see the module doc); the last result must lie
    within its tolerance of the f64 sum, or this raises.  The prediction
    prices the ``MODEL_EQUIVALENTS`` algorithm with ``algo_cost`` under
    ``params`` (default :class:`CostParams`) — drift between the two is
    the calibration signal, not an error.  Every rank returns the same
    probe."""
    import torch
    import torch.distributed as dist

    from repro_torch.ccl.cost import CostParams, algo_cost, cost_terms
    from repro_torch.ccl.primitives import (MODEL_EQUIVALENTS, _permute,
                                            make_all_reduce)
    from repro_torch.core.device import resolve_device

    if impl not in MODEL_EQUIVALENTS:
        raise ValueError(f"unknown implementation {impl!r} "
                         f"(one of {sorted(MODEL_EQUIVALENTS)})")
    dev = resolve_device("cuda" if device is None else device)
    on_card = dev.type == "cuda"
    rank, p = dist.get_rank(group), dist.get_world_size(group)
    cp = params if params is not None else CostParams()
    # the slowest rank's seconds travel in the group's own transport
    t_dev = "cpu" if dist.get_backend(group) == "gloo" else dev

    x = probe_operand(size_bytes, p, rank, dev)
    fn = make_all_reduce(impl, group)

    def run(timed: bool):
        dist.barrier(group)
        if on_card:
            torch.cuda.synchronize(dev)
        sent0 = _permute.sent_bytes
        t0 = clock() if timed else 0.0
        out = fn(x)
        if on_card:
            torch.cuda.synchronize(dev)
        elapsed = clock() - t0 if timed else 0.0
        return out, elapsed, _permute.sent_bytes - sent0

    for _ in range(max(warmup, 0)):  # the clock is read on timed runs only
        run(False)
    runs: List[float] = []
    for _ in range(max(repeats, 1)):
        out, elapsed, sent = run(True)
        slowest = torch.tensor([elapsed], dtype=torch.float64, device=t_dev)
        dist.all_reduce(slowest, op=dist.ReduceOp.MAX, group=group)
        runs.append(float(slowest.item()))

    truth, sabs, amax = _expected(size_bytes, p, dev)
    check = _err_over_tol(impl, out, truth, sabs, amax, p)
    del truth, sabs
    probe_all_reduce.last_check = {
        "impl": impl, "size_bytes": size_bytes, "world": p, "rank": rank,
        "operand_bytes": x.numel() * x.element_size(), "sent_bytes": sent,
        "device": str(out.device), **check}
    if not check["err_over_tol"] <= 1.0:
        raise RuntimeError(
            f"probe {impl} {size_bytes} B: max |err| {check['max_abs_err']}"
            f" is {check['err_over_tol']}x its tolerance ({PROBE_TOL_NOTE})")

    algorithm = MODEL_EQUIVALENTS[impl]
    return CollectiveProbe(
        impl=impl, algorithm=algorithm, size_bytes=size_bytes, world=p,
        measured_s=min(runs),
        modeled_s=algo_cost("all_reduce", algorithm, size_bytes, p, cp),
        runs_s=runs,
        model_terms=cost_terms("all_reduce", algorithm, size_bytes, p, cp),
        device_kind=torch.cuda.get_device_name(dev) if on_card else "cpu")


# the last probe's check on this rank: its error against the f64 sum, the
# operand's bytes and the bytes this rank sent in the last run
probe_all_reduce.last_check = None


def probe_suite(impls: Sequence[str] = ("ring", "bidir_ring"),
                sizes: Sequence[int] = (1 << 16, 1 << 20), group=None,
                params=None, repeats: int = 3, warmup: int = 1,
                clock: Callable[[], float] = time.perf_counter,
                device=None) -> List[CollectiveProbe]:
    """Probe an implementation x size grid (deterministic order);
    ``probe_suite.checks`` keeps each probe's ``last_check``, in order."""
    probes, checks = [], []
    for impl in impls:
        for size in sizes:
            probes.append(probe_all_reduce(
                impl, size, group=group, params=params, repeats=repeats,
                warmup=warmup, clock=clock, device=device))
            checks.append(probe_all_reduce.last_check)
    probe_suite.checks = checks
    return probes


probe_suite.checks = []


def probes_to_trace(probes: Sequence[CollectiveProbe],
                    trace: Optional[Trace] = None, pid: int = 50,
                    t0: float = 0.0) -> Trace:
    """Measured and modeled spans side-by-side: one process, a
    *measured* thread and a *modeled* thread, each probe laid out on a
    shared cursor so the pair lines up vertically in Perfetto."""
    trace = trace if trace is not None else Trace()
    trace.process(pid, "collectives: measured vs modeled")
    trace.thread(pid, 0, "measured")
    trace.thread(pid, 1, "modeled")
    cursor = t0
    for pr in probes:
        name = f"{pr.impl} {pr.size_bytes}B"
        args = pr.to_dict()
        args.pop("model_terms", None)
        trace.span(name, cursor, pr.measured_s, pid=pid, tid=0,
                   cat="measured", args=args)
        trace.span(f"model:{pr.algorithm} {pr.size_bytes}B", cursor,
                   pr.modeled_s, pid=pid, tid=1, cat="modeled",
                   args=pr.model_terms or None)
        cursor += max(pr.measured_s, pr.modeled_s) * 1.05 + 1e-6
    return trace


def model_vs_measured(probes: Sequence[CollectiveProbe]) -> Dict:
    """Drift summary: per-probe rows plus aggregate measured/modeled
    ratio statistics (geometric mean and mean |log2 error| — the scale-
    free quantities a calibration regression would drive to 1 and 0)."""
    rows = []
    log2_errs = []
    for pr in probes:
        row = pr.to_dict()
        row.pop("runs_s", None)
        row["ratio"] = pr.ratio
        if pr.ratio is not None and pr.ratio > 0:
            err = math.log2(pr.ratio)
            row["log2_err"] = err
            log2_errs.append(err)
        rows.append(row)
    summary: Dict = {"count": len(rows), "rows": rows}
    if log2_errs:
        summary["geomean_ratio"] = 2.0 ** (sum(log2_errs) / len(log2_errs))
        summary["mean_abs_log2_err"] = (sum(abs(e) for e in log2_errs)
                                        / len(log2_errs))
        summary["max_ratio"] = 2.0 ** max(log2_errs)
        summary["min_ratio"] = 2.0 ** min(log2_errs)
    return summary
