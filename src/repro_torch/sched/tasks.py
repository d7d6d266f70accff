"""Task scheduler — "Vertical" co-design (paper Sec. IV-A, Fig. 5a).

Discrete-event simulation of one training iteration: a compute resource
(the accelerator) and a communication resource (the network) execute a
dependency DAG of ComputeTask/CommTask.  The scheduler policy decides which
ready comm task transmits next; the objective is JCT, not per-flow FCT.

Policies:
  * serial    — no overlap: every comm task runs with compute idle (the
                no-overlap strawman; exposes ALL communication)
  * fifo      — comm overlaps compute, network served in arrival order
  * priority  — Lina-style: blocking collectives (e.g. MoE All-to-All on
                the critical path) preempt gradient All-Reduce
  * slack     — Echelon-style: least-slack-first (slack = how long until
                the dependent compute stalls)

Reports JCT and *exposed communication* (comm time the compute resource
spends stalled) — the survey's central metric.  Exposure is accounted
per dependency edge: every stall is attributed to the comm task the
compute resource actually waited on (``SimResult.task_exposed_s``), so
hot-task attribution no longer has to be inferred from the timeline.

The demand side can hand this scheduler a *pipelined bucket DAG*
(``build_demand(bucket_bytes=...)``): gradient buckets chain off the
backward layer that filled them, so bucket i's sync starts when layer
i's backward retires rather than when the whole backward ends.  That
makes the classic bucket-size tradeoff (MG-WFBP / ByteScheduler; Shi et
al., arXiv 2005.13247) visible to the simulator — larger buckets
amortize the per-step alpha, smaller buckets become ready earlier and
hide deeper under the remaining backward compute.  Decomposed TP
collectives (``decompose_demand``) show up here as chains of "permute"
tasks riding under split partial matmuls, the collective-matmul
overlap pattern.

The port's copy of ``repro.sched.tasks``, kept line for line: importing any
``repro`` module runs the JAX package's ``__init__``, which imports jax, so
the port keeps its own.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Literal, Optional, Tuple

from repro_torch.core.demand import CommDemand, CommTask, ComputeTask

Policy = Literal["serial", "fifo", "priority", "slack", "preempt"]

# Lina-style: blocking collectives (MoE All-to-All, pipeline p2p, TP
# All-Reduce, decomposed-collective permute steps) before the hideable
# gradient Reduce-Scatter/All-Gather.
_PRIORITY = {"all_to_all": 0, "p2p": 1, "permute": 1, "all_reduce": 2,
             "broadcast": 2, "all_gather": 3, "reduce_scatter": 3}


@dataclass
class SimResult:
    jct: float
    compute_time: float
    comm_time: float
    exposed_comm: float
    # the iteration's executed schedule: ``("comp:<id>" | "comm:<id>",
    # start_s, end_s)`` per run segment.  Compute entries tile the
    # accelerator resource, comm entries the (single) network resource;
    # within each resource the spans never overlap (preempted transfers
    # are split into one span per segment).
    timeline: List[Tuple[str, float, float]] = field(default_factory=list)
    # per-task answers from the CCL layer, recorded when ``comm_cost``
    # returns (seconds, algorithm) pairs (the codesign driver does)
    algo_choices: Dict[str, str] = field(default_factory=dict)
    task_comm_s: Dict[str, float] = field(default_factory=dict)
    # per-task exposure attribution: seconds the compute resource spent
    # stalled waiting on each comm task (sums to ``exposed_comm``)
    task_exposed_s: Dict[str, float] = field(default_factory=dict)

    @property
    def comm_fraction(self) -> float:
        return self.exposed_comm / self.jct if self.jct else 0.0

    def to_trace(self, label: str = "iteration"):
        """This schedule as a Perfetto-loadable ``repro_torch.obs.trace.Trace``
        (compute / comm / exposed-comm tracks)."""
        from repro_torch.obs.trace import Trace, timeline_tracks
        tr = Trace()
        timeline_tracks(tr, pid=1, label=label, timeline=self.timeline,
                        task_exposed_s=self.task_exposed_s)
        return tr


def _pick(policy: Policy, ready: List[CommTask], arrival: Dict[str, int]
          ) -> CommTask:
    if policy in ("serial", "fifo"):
        return min(ready, key=lambda t: arrival[t.task_id])
    if policy in ("priority", "preempt"):
        return min(ready, key=lambda t: (_PRIORITY.get(t.primitive, 9),
                                         arrival[t.task_id]))
    return min(ready, key=lambda t: (t.slack, arrival[t.task_id]))  # slack


def simulate_iteration(demand: CommDemand,
                       comm_cost: Callable[[CommTask], object],
                       policy: Policy = "priority") -> SimResult:
    """Simulate one iteration.  ``comm_cost`` maps a CommTask to seconds —
    the CCL+network layers' answer, i.e. the cross-layer information
    exchange arrow of the five-layer paradigm.  It may instead return a
    ``(seconds, algorithm_name)`` pair; the chosen algorithm is then
    recorded in ``SimResult.algo_choices`` for the codesign report."""
    comm_tasks = list(demand.comm_tasks)
    arrival = {t.task_id: i for i, t in enumerate(comm_tasks)}
    blockers: Dict[str, List[str]] = {}
    for t in comm_tasks:
        if t.before_compute:
            blockers.setdefault(t.before_compute, []).append(t.task_id)

    done_compute: Dict[str, float] = {}  # task_id -> finish time
    done_comm: set = set()
    running: Optional[Tuple[float, CommTask]] = None  # (finish, task)
    run_start = 0.0
    dur_left: Dict[str, float] = {}  # remaining seconds (preemption)
    t_compute = 0.0  # compute resource frontier
    t_net = 0.0      # network resource frontier
    exposed = 0.0
    comm_total = 0.0
    timeline: List[Tuple[str, float, float]] = []
    algo_choices: Dict[str, str] = {}
    task_comm_s: Dict[str, float] = {}
    task_exposed_s: Dict[str, float] = {t.task_id: 0.0 for t in comm_tasks}

    def ready_comms() -> List[CommTask]:
        return [t for t in comm_tasks
                if t.task_id not in done_comm
                and (running is None or running[1].task_id != t.task_id)
                and all(c in done_compute for c in t.after_compute)]

    def start_next_comm():
        nonlocal running, run_start, t_net, comm_total
        if running is not None:
            return
        ready = ready_comms()
        if not ready:
            return
        task = _pick(policy, ready, arrival)
        if task.task_id not in dur_left:
            priced = comm_cost(task)
            if isinstance(priced, tuple):
                dur, algo = priced
                algo_choices[task.task_id] = algo
            else:
                dur = priced
            dur_left[task.task_id] = dur
            task_comm_s[task.task_id] = dur
            comm_total += dur
        dur = dur_left[task.task_id]
        ready_at = max((done_compute[c] for c in task.after_compute),
                       default=0.0)
        start = max(t_net, ready_at)
        running = (start + dur, task)
        run_start = start
        t_net = start + dur
        timeline.append((f"comm:{task.task_id}", start, start + dur))

    def preempt_running(at: float):
        """Pause the running comm at time ``at`` (Lina-style preemption);
        its remainder is requeued."""
        nonlocal running, t_net
        fin, task = running
        elapsed = max(0.0, at - run_start)
        dur_left[task.task_id] = max(0.0, (fin - run_start) - elapsed)
        # the span appended at start covered the full duration; cut it to
        # what actually ran (the remainder gets its own span on resume) so
        # the timeline never holds two concurrent spans on the one network
        # resource
        name = f"comm:{task.task_id}"
        for j in range(len(timeline) - 1, -1, -1):
            if timeline[j][0] == name:
                if elapsed > 0.0:
                    timeline[j] = (name, run_start, run_start + elapsed)
                else:
                    del timeline[j]
                break
        t_net = at
        running = None

    def finish_running():
        nonlocal running
        if running is not None:
            done_comm.add(running[1].task_id)
            running = None

    def wait_for_running():
        """Stall compute until the in-flight comm finishes; the stall is
        exposure, attributed to the task that was on the wire."""
        nonlocal t_compute, exposed
        fin, task = running
        if fin > t_compute:
            exposed += fin - t_compute
            task_exposed_s[task.task_id] += fin - t_compute
            t_compute = fin
        finish_running()

    i = 0
    compute_list = list(demand.compute_tasks)
    guard = 0
    while i < len(compute_list) or len(done_comm) < len(comm_tasks):
        guard += 1
        if guard > 100 * (len(compute_list) + len(comm_tasks) + 1):
            raise RuntimeError("scheduler livelock")
        start_next_comm()
        if i < len(compute_list):
            ct = compute_list[i]
            waiting = [b for b in blockers.get(ct.task_id, [])
                       if b not in done_comm]
            if waiting:
                # must wait for comm -> advance time to the running finish
                if running is not None and running[1].task_id in waiting:
                    wait_for_running()
                elif running is not None:
                    if policy == "preempt" and t_compute < running[0]:
                        # pause the non-blocking transfer, let the blocker in
                        preempt_running(max(t_compute, run_start))
                        continue
                    # some other comm on the wire; let it finish first
                    wait_for_running()
                else:
                    continue  # blocker will be started next loop
                continue
            if policy == "serial" and running is not None:
                wait_for_running()
                continue
            # run compute
            timeline.append((f"comp:{ct.task_id}", t_compute,
                             t_compute + ct.duration))
            t_compute += ct.duration
            done_compute[ct.task_id] = t_compute
            i += 1
            # retire comm finished in the background
            if running is not None and running[0] <= t_compute:
                finish_running()
            continue
        # only comm left
        if running is not None:
            wait_for_running()
        elif not ready_comms():
            break

    jct = max(t_compute, t_net)
    compute_time = sum(c.duration for c in demand.compute_tasks)
    return SimResult(jct=jct, compute_time=compute_time,
                     comm_time=comm_total, exposed_comm=exposed,
                     timeline=timeline, algo_choices=algo_choices,
                     task_comm_s=task_comm_s,
                     task_exposed_s=task_exposed_s)
