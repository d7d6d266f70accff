"""Open-loop request arrival processes for serving co-design.

Training demand is iteration-periodic; serving demand is *arrival-driven*:
an open-loop process emits requests at times the system does not control,
and the scheduler's job is to keep latency SLOs under that offered load
(the workload-dependence the survey's Sec. V frames as the reason one
communication schedule cannot fit all tenants).

Everything here is deterministic by construction — the Poisson process
runs on a hand-rolled splitmix64 counter PRNG keyed by ``seed``, never
the stdlib's global ``random`` — so `plan_serving` reports, benchmark
rows, and hypothesis properties replay bit-identically.

Two processes:

  * :class:`PoissonArrivals` — exponential inter-arrival times at
    ``rate_rps``, fixed (prompt, decode) token budget per request.
  * :class:`TraceArrivals`  — an explicit tuple of :class:`Arrival`s
    (production trace replay); round-trips through
    :func:`arrivals_to_dict` / :func:`arrivals_from_dict`.

Both expose ``sample(horizon_s)``; :func:`demand_series` folds a sample
into per-phase (prefill / decode) token demand over time windows, the
open-loop analogue of the periodic per-link demand maps in
``sched.flows``.

The port's copy of ``repro.sched.arrivals``, kept line for line: importing
any ``repro`` module runs the JAX package's ``__init__``, which imports jax,
so the port keeps its own.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Sequence, Tuple

_MASK = (1 << 64) - 1


def _splitmix64(state: int) -> Tuple[int, int]:
    """One splitmix64 step: returns (new_state, 64-bit output)."""
    state = (state + 0x9E3779B97F4A7C15) & _MASK
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return state, z ^ (z >> 31)


def _uniform(z: int) -> float:
    """A 64-bit word as a uniform in [0, 1) with 53-bit mantissa."""
    return (z >> 11) * (1.0 / (1 << 53))


@dataclass(frozen=True)
class Arrival:
    """One request entering the system at absolute time ``t`` (seconds),
    carrying a prefill budget of ``prompt_tokens`` and a decode budget of
    ``decode_tokens`` new tokens."""

    rid: str
    t: float
    prompt_tokens: int
    decode_tokens: int

    def to_dict(self) -> Dict[str, object]:
        return {"rid": self.rid, "t": self.t,
                "prompt_tokens": self.prompt_tokens,
                "decode_tokens": self.decode_tokens}

    @classmethod
    def from_dict(cls, d: Mapping[str, object]) -> "Arrival":
        return cls(rid=str(d["rid"]), t=float(d["t"]),
                   prompt_tokens=int(d["prompt_tokens"]),
                   decode_tokens=int(d["decode_tokens"]))


@dataclass(frozen=True)
class PoissonArrivals:
    """Seeded open-loop Poisson process: inter-arrival gaps are
    ``Exp(rate_rps)`` drawn from a splitmix64 stream, every request has
    the same (prompt, decode) token mix.  ``sample`` is a pure function
    of ``(seed, rate_rps, horizon_s)``."""

    rate_rps: float
    prompt_tokens: int = 512
    decode_tokens: int = 128
    seed: int = 0

    def __post_init__(self) -> None:
        if self.rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {self.rate_rps}")
        if self.prompt_tokens <= 0 or self.decode_tokens <= 0:
            raise ValueError("prompt_tokens and decode_tokens must be > 0")

    def sample(self, horizon_s: float) -> Tuple[Arrival, ...]:
        state = (self.seed * 0x9E3779B97F4A7C15 + 1) & _MASK
        out: List[Arrival] = []
        t = 0.0
        i = 0
        while True:
            state, z = _splitmix64(state)
            u = _uniform(z)
            t += -math.log(1.0 - u) / self.rate_rps
            if t >= horizon_s:
                break
            out.append(Arrival(rid=f"r{i}", t=t,
                               prompt_tokens=self.prompt_tokens,
                               decode_tokens=self.decode_tokens))
            i += 1
        return tuple(out)

    def to_dict(self) -> Dict[str, object]:
        return {"process": "poisson", "rate_rps": self.rate_rps,
                "prompt_tokens": self.prompt_tokens,
                "decode_tokens": self.decode_tokens, "seed": self.seed}


@dataclass(frozen=True)
class TraceArrivals:
    """Trace-driven replay: an explicit, time-sorted tuple of arrivals
    (e.g. a production request log).  ``sample`` clips to the horizon."""

    arrivals: Tuple[Arrival, ...] = field(default_factory=tuple)

    def __post_init__(self) -> None:
        ts = [a.t for a in self.arrivals]
        if ts != sorted(ts):
            object.__setattr__(
                self, "arrivals",
                tuple(sorted(self.arrivals, key=lambda a: (a.t, a.rid))))

    def sample(self, horizon_s: float) -> Tuple[Arrival, ...]:
        return tuple(a for a in self.arrivals if a.t < horizon_s)

    def to_dict(self) -> Dict[str, object]:
        return {"process": "trace",
                "arrivals": [a.to_dict() for a in self.arrivals]}


def arrivals_to_dict(process) -> Dict[str, object]:
    """JSON-serializable form of either arrival process."""
    return process.to_dict()


def arrivals_from_dict(d: Mapping[str, object]):
    """Inverse of :func:`arrivals_to_dict`."""
    kind = d.get("process")
    if kind == "poisson":
        return PoissonArrivals(rate_rps=float(d["rate_rps"]),
                               prompt_tokens=int(d["prompt_tokens"]),
                               decode_tokens=int(d["decode_tokens"]),
                               seed=int(d["seed"]))
    if kind == "trace":
        return TraceArrivals(tuple(Arrival.from_dict(a)
                                   for a in d["arrivals"]))
    raise ValueError(f"unknown arrival process {kind!r}; "
                     f"expected 'poisson' or 'trace'")


def offered_load(arrivals: Sequence[Arrival], horizon_s: float) -> float:
    """Offered load in requests/second over the horizon — the ceiling no
    goodput number can exceed."""
    if horizon_s <= 0:
        return 0.0
    return len(arrivals) / horizon_s


def demand_series(arrivals: Sequence[Arrival], horizon_s: float,
                  window_s: float) -> Dict[str, Tuple[float, ...]]:
    """Per-phase token demand over time: windowed sums of prefill tokens
    and decode tokens.  Returns ``{"t": window starts, "prefill": ...,
    "decode": ...}`` — the open-loop demand profile a co-tenant planner
    lays against a training job's periodic comm phases."""
    if window_s <= 0:
        raise ValueError(f"window_s must be > 0, got {window_s}")
    n = max(1, int(math.ceil(horizon_s / window_s)))
    prefill = [0.0] * n
    decode = [0.0] * n
    for a in arrivals:
        if not (0.0 <= a.t < horizon_s):
            continue
        i = min(int(a.t / window_s), n - 1)
        prefill[i] += a.prompt_tokens
        decode[i] += a.decode_tokens
    return {"t": tuple(i * window_s for i in range(n)),
            "prefill": tuple(prefill), "decode": tuple(decode)}
