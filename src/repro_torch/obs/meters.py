"""Deterministic counters and timing observations for the engine's hot
paths.

A :class:`Meters` is a flat bag of named counters (``incr``) and value
observations (``observe`` — running sum/count/min/max), plus a ``time``
context manager that observes wall-clock against an injectable clock.
Everything the engine counts is *deterministic by construction*: the same
plan/search/replan run produces the same counter values, so tests can
assert them exactly — only clock-derived observations vary, and the clock
is injectable precisely so tests can pin those too.

Consumers:

  * ``ccl.select.FlowSim`` — memoization hit/miss counters, labelled per
    switch-capacity bucket (one FlowSim per aggregation budget);
  * ``codesign.api.search`` — per-candidate records plus the aggregated
    cost-model counters, surfaced as ``SearchResult.telemetry``;
  * ``codesign.dynamics.ClusterDynamics`` — per-event dirty-set sizes and
    replan-mode tallies, surfaced as ``DynamicsReport.telemetry``;
  * ``sched.flows`` — phase-search evaluation counts.

This module imports nothing from ``repro_torch`` (it sits below every layer).

The port's copy of ``repro.obs.meters``, kept line for line: importing any
``repro`` module runs the JAX package's ``__init__``, which imports jax, so
the port keeps its own.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, Dict, Optional


class Meters:
    """Named counters + value observations behind one injectable clock."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self._counters: Dict[str, float] = {}
        self._observations: Dict[str, Dict[str, float]] = {}

    # ------------------------------------------------------------------
    # Counters
    # ------------------------------------------------------------------

    def incr(self, name: str, by: float = 1.0) -> float:
        """Add ``by`` to counter ``name`` (created at 0); returns the new
        value."""
        v = self._counters.get(name, 0.0) + by
        self._counters[name] = v
        return v

    def get(self, name: str, default: float = 0.0) -> float:
        return self._counters.get(name, default)

    def ratio(self, num: str, *parts: str) -> Optional[float]:
        """``num / (num + parts...)`` over counter values — the hit-rate
        helper (None when nothing was counted)."""
        n = self.get(num)
        total = n + sum(self.get(p) for p in parts)
        return n / total if total > 0 else None

    # ------------------------------------------------------------------
    # Observations
    # ------------------------------------------------------------------

    def observe(self, name: str, value: float) -> None:
        """Record one sample of ``name`` (running sum/count/min/max)."""
        o = self._observations.get(name)
        if o is None:
            self._observations[name] = {"sum": float(value), "count": 1.0,
                                        "min": float(value),
                                        "max": float(value)}
        else:
            o["sum"] += value
            o["count"] += 1.0
            o["min"] = min(o["min"], value)
            o["max"] = max(o["max"], value)

    @contextmanager
    def time(self, name: str):
        """Observe the wall-clock of a block under ``name`` (uses the
        injected clock, so tests can make timings exact)."""
        t0 = self.clock()
        try:
            yield
        finally:
            self.observe(name, self.clock() - t0)

    # ------------------------------------------------------------------
    # Aggregation
    # ------------------------------------------------------------------

    def merge(self, other: "Meters") -> "Meters":
        """Fold ``other``'s counters and observations into this one."""
        for name, v in other._counters.items():
            self._counters[name] = self._counters.get(name, 0.0) + v
        for name, o in other._observations.items():
            mine = self._observations.get(name)
            if mine is None:
                self._observations[name] = dict(o)
            else:
                mine["sum"] += o["sum"]
                mine["count"] += o["count"]
                mine["min"] = min(mine["min"], o["min"])
                mine["max"] = max(mine["max"], o["max"])
        return self

    def snapshot(self) -> Dict[str, float]:
        """Flat, key-sorted view: counters verbatim, observations expanded
        to ``name.sum`` / ``name.count`` / ``name.min`` / ``name.max`` —
        JSON-ready and deterministic in iteration order."""
        out = dict(self._counters)
        for name, o in self._observations.items():
            for stat, v in o.items():
                out[f"{name}.{stat}"] = v
        return {k: out[k] for k in sorted(out)}
