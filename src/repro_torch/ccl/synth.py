"""Synthesized collective schedules: what the executable lowering reads.

Port of the schedule types of ``repro.ccl.synth`` (``Move``,
``SynthSchedule`` and ``atp_schedule``), all plain Python.  The
synthesizer itself (topology routing) is planner work and is not ported
yet; a schedule built by ``repro.ccl.synth`` carries over field by field.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class Move:
    """One chunk transfer of a synthesized schedule: endpoint-level
    (``src`` holds the chunk, the fabric routes it), step-indexed for
    concurrency.  ``reduce`` marks a contribution being accumulated into
    the destination's chunk slot; gather moves overwrite."""

    chunk: int
    src: int
    dst: int
    step: int
    size_bytes: int
    reduce: bool = False


@dataclass
class SynthSchedule:
    """A synthesized collective as an explicit move list.

    ``num_chunks`` is the number of buffer slots the executable lowering
    needs per rank (= chunks the payload is split into).  ``moves`` are in
    list-scheduler emission order; within a step, earlier moves may feed
    later sub-batches of the same step only through *reduce* accumulation
    (never forwarding: a chunk received at step ``s`` is forwarded at step
    ``> s``)."""

    task_id: str
    primitive: str
    group: Tuple[int, ...]
    size_bytes: int
    chunk_bytes: int
    num_chunks: int
    moves: List[Move] = field(default_factory=list)
    num_steps: int = 0
    makespan: float = 0.0
    algorithm: str = "synthesized"

    def wire_bytes(self) -> int:
        return sum(m.size_bytes for m in self.moves)


def atp_schedule(task, ps: Optional[int] = None) -> SynthSchedule:
    """The ``atp`` all-reduce as a schedule: every worker's full payload
    converges on the aggregation point (reduce moves), then the sum
    multicasts back.  One chunk slot, two steps.  ``task`` is anything with
    ``task_id``, ``group`` and ``size_bytes`` (a ``CommTask`` of the
    planner)."""
    g = list(task.group)
    if ps is None:
        ps = g[0]
    n = max(task.size_bytes, 1)
    moves = [Move(0, w, ps, 0, n, reduce=True) for w in g if w != ps]
    moves += [Move(0, ps, w, 1, n) for w in g if w != ps]
    return SynthSchedule(
        task_id=task.task_id, primitive="all_reduce", group=tuple(g),
        size_bytes=task.size_bytes, chunk_bytes=n, num_chunks=1,
        moves=moves, num_steps=2, makespan=0.0, algorithm="synthesized_atp")
