"""Cross-layer interface types for the five-layer paradigm.

The survey's central observation (Sec. II-E / IV-A) is that the three layers
are "relatively independent" and would benefit from explicit information
exchange.  This module is that exchange: the parallelization-strategy layer
emits a :class:`CommDemand` (what must be communicated, between whom, and
with which dependencies on compute); the CCL layer turns each
:class:`CommTask` into a :class:`FlowSet` of point-to-point flows for a
concrete algorithm; the network layer + flow scheduler place those flows on
links.  Objective throughout is JCT (job completion time), not per-flow FCT.

The port's copy of ``repro.core.demand``, kept line for line: importing any
``repro`` module runs the JAX package's ``__init__``, which imports jax, so
the port keeps its own.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Literal, Optional, Sequence, Tuple

Primitive = Literal[
    "all_reduce", "all_gather", "reduce_scatter", "all_to_all",
    "broadcast", "p2p", "permute",
]


@dataclass(frozen=True)
class CommTask:
    """One collective communication task in the iteration task graph."""

    task_id: str
    primitive: Primitive
    size_bytes: int  # per-participant payload (pre-algorithm)
    group: Tuple[int, ...]  # participating device ids (the "communicator")
    # dependency edges: ids of compute tasks that must finish first, and the
    # compute task (if any) that cannot start until this task completes.
    after_compute: Tuple[str, ...] = ()
    before_compute: Optional[str] = None
    # deadline slack (seconds) before this task blocks the critical path;
    # the "deadline" notion from the paper's Fig. 5(b) case study.
    slack: float = 0.0
    job_id: str = "job0"
    # which logical mesh axis the communicator spans ("model" / "data" /
    # "all" / None).  The codesign placement layer uses it to resolve the
    # logical group onto physical devices without guessing from group size.
    axis: Optional[str] = None
    # serving phase tag ("prefill" / "kv" / "decode"; None for training
    # tasks): lets SLO accounting and traces attribute comm to the
    # request-lifecycle stage it serves.
    phase: Optional[str] = None


@dataclass(frozen=True)
class ComputeTask:
    task_id: str
    flops: float
    duration: float  # seconds on the target chip
    job_id: str = "job0"


@dataclass
class CommDemand:
    """Everything the Para. layer tells the layers below (red arrows, Fig.5a)."""

    comm_tasks: List[CommTask] = field(default_factory=list)
    compute_tasks: List[ComputeTask] = field(default_factory=list)
    job_id: str = "job0"

    def total_bytes(self) -> int:
        return sum(t.size_bytes for t in self.comm_tasks)

    def by_primitive(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for t in self.comm_tasks:
            out[t.primitive] = out.get(t.primitive, 0) + t.size_bytes
        return out


@dataclass(frozen=True)
class Flow:
    """A point-to-point transfer emitted by a CCL algorithm step."""

    src: int
    dst: int
    size_bytes: int
    task_id: str  # CommTask it belongs to
    step: int  # algorithm step index (steps are sequential within a task)
    job_id: str = "job0"


@dataclass
class FlowSet:
    """The traffic a CCL algorithm generates for one CommTask."""

    task_id: str
    algorithm: str
    flows: List[Flow] = field(default_factory=list)
    num_steps: int = 0
    makespan: Optional[float] = None  # schedule's own completion estimate

    def bytes_on_wire(self) -> int:
        return sum(f.size_bytes for f in self.flows)
