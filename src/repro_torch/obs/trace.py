"""Structured tracing with a Chrome Trace Event (Perfetto) exporter.

The engine's answers are timelines — ``SimResult.timeline`` schedules,
cluster phase offsets, dynamics event streams — but until now they were
bare tuples.  :class:`Trace` is the recorder: spans (``ph:"X"``),
counter samples (``ph:"C"``) and instant events (``ph:"i"``) keyed by a
process/thread grid, exported as Chrome Trace Event JSON that loads
directly in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.

The builders turn each report layer into tracks:

  * :func:`timeline_tracks` / :func:`trace_from_report` — one process
    per job with a *compute* thread, a *comm* thread (args carry the
    chosen algorithm/codec/size), an *exposed comm* thread whose spans
    flag the stall intervals compute spent waiting on the wire (colored
    red via ``cname``), and — given the live ``Topology`` — per-link
    utilization counter tracks regenerated through
    ``net.simulate.link_rate_series``;
  * :func:`trace_from_search` — the winner's full tracks plus a search
    process: frontier candidates as instants and JCT counter series;
  * :func:`trace_from_cluster` — one process group per tenant, each
    tenant's iteration shifted by its staggered phase, contended links
    as instants on a cluster process;
  * :func:`trace_from_serving` — a ``ServingReport``'s request
    lifetimes (queue/prefill/decode spans packed into lanes) with SLO
    violations as red instants, plus the priced prefill/decode plans;
  * :func:`trace_from_dynamics` — the event trace (link_fail, replan
    mode, evictions) as instants + replan-cost spans and
    stretch/dirty-set counters, followed by the final cluster plan.

Everything here is dict-driven: builders accept either live report
objects or their ``to_dict()`` JSON, so a persisted report re-exports to
the identical trace (``python -m repro_torch.obs.export``).  Export is
deterministic — stable event ordering, sorted JSON keys — so traces can
be diffed and tested byte-for-byte.

The port's copy of ``repro.obs.trace``, kept line for line: importing any
``repro`` module runs the JAX package's ``__init__``, which imports jax, so
the port keeps its own.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

_US = 1e6  # seconds -> Chrome Trace microseconds

# Chrome reserved color names: exposed communication is flagged red.
EXPOSED_CNAME = "terrible"


@dataclass
class _Event:
    """One recorded event in source units (seconds)."""

    ph: str
    name: str
    ts: float
    pid: int
    tid: int
    dur: float = 0.0
    cat: str = ""
    args: Optional[Dict] = None
    scope: str = "t"
    cname: Optional[str] = None


class Trace:
    """Span / counter / instant-event recorder with Perfetto JSON export."""

    def __init__(self):
        self._events: List[_Event] = []
        self._process_names: Dict[int, str] = {}
        self._process_sort: Dict[int, int] = {}
        self._thread_names: Dict[Tuple[int, int], str] = {}

    # -- structure -----------------------------------------------------

    def process(self, pid: int, name: str,
                sort_index: Optional[int] = None) -> int:
        """Name a process row (a job / tenant / the cluster)."""
        self._process_names[pid] = name
        if sort_index is not None:
            self._process_sort[pid] = sort_index
        return pid

    def thread(self, pid: int, tid: int, name: str) -> int:
        """Name a thread row (a resource track inside a process)."""
        self._thread_names[(pid, tid)] = name
        return tid

    # -- events --------------------------------------------------------

    def span(self, name: str, start_s: float, dur_s: float, pid: int = 0,
             tid: int = 0, cat: str = "", args: Optional[Dict] = None,
             cname: Optional[str] = None) -> None:
        """A complete span (``ph:"X"``); negative durations are clamped."""
        self._events.append(_Event("X", name, start_s, pid, tid,
                                   dur=max(dur_s, 0.0), cat=cat, args=args,
                                   cname=cname))

    def counter(self, name: str, ts_s: float, values: Mapping[str, float],
                pid: int = 0, tid: int = 0) -> None:
        """One sample of a counter track (``ph:"C"``, one series per key)."""
        self._events.append(_Event("C", name, ts_s, pid, tid,
                                   args={k: values[k]
                                         for k in sorted(values)}))

    def instant(self, name: str, ts_s: float, pid: int = 0, tid: int = 0,
                args: Optional[Dict] = None, scope: str = "t",
                cat: str = "", cname: Optional[str] = None) -> None:
        """An instant event (``ph:"i"``; scope t=thread, p=process,
        g=global)."""
        self._events.append(_Event("i", name, ts_s, pid, tid, args=args,
                                   scope=scope, cat=cat, cname=cname))

    # -- export --------------------------------------------------------

    def events(self) -> List[Dict]:
        """Chrome Trace Event dicts: metadata first, then events in
        stable (pid, tid, ts, ph, name) order — same trace, same bytes."""
        out: List[Dict] = []
        for pid in sorted(self._process_names):
            out.append({"ph": "M", "name": "process_name", "pid": pid,
                        "tid": 0, "args": {"name": self._process_names[pid]}})
            if pid in self._process_sort:
                out.append({"ph": "M", "name": "process_sort_index",
                            "pid": pid, "tid": 0,
                            "args": {"sort_index": self._process_sort[pid]}})
        for (pid, tid) in sorted(self._thread_names):
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid,
                        "args": {"name": self._thread_names[(pid, tid)]}})
        for ev in sorted(self._events,
                         key=lambda e: (e.pid, e.tid, e.ts, e.ph, e.name)):
            d: Dict = {"ph": ev.ph, "name": ev.name,
                       "ts": round(ev.ts * _US, 3), "pid": ev.pid,
                       "tid": ev.tid}
            if ev.ph == "X":
                d["dur"] = round(ev.dur * _US, 3)
            if ev.ph == "i":
                d["s"] = ev.scope
            if ev.cat:
                d["cat"] = ev.cat
            if ev.cname:
                d["cname"] = ev.cname
            if ev.args is not None:
                d["args"] = ev.args
            out.append(d)
        return out

    def to_chrome(self) -> Dict:
        return {"displayTimeUnit": "ms", "traceEvents": self.events()}

    def to_json(self) -> str:
        return json.dumps(self.to_chrome(), sort_keys=True,
                          separators=(",", ":"))

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
        return path


def validate_chrome(doc: Dict) -> List[str]:
    """Problems with a Chrome Trace Event document (empty list = valid):
    required keys and types per phase, and — per (pid, tid) track —
    non-overlapping complete spans (the single-resource invariant the
    scheduler timeline guarantees)."""
    problems: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    spans: Dict[Tuple[int, int], List[Tuple[float, float, str]]] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "C", "i", "M"):
            problems.append(f"event {i}: unknown ph {ph!r}")
            continue
        missing = [key for key in ("name", "pid", "tid") if key not in ev]
        if missing:
            problems.append(f"event {i} ({ph}): missing {missing}")
            continue
        if not isinstance(ev.get("name"), str):
            problems.append(f"event {i} ({ph}): name not a string")
        if ph == "M":
            continue
        if not isinstance(ev.get("ts"), (int, float)):
            problems.append(f"event {i} ({ph}): ts not a number")
            continue
        if ph == "X":
            if not isinstance(ev.get("dur"), (int, float)):
                problems.append(f"event {i} (X): dur not a number")
            elif ev["dur"] < 0:
                problems.append(f"event {i} (X): negative dur {ev['dur']}")
            else:
                spans.setdefault((ev["pid"], ev["tid"]), []).append(
                    (ev["ts"], ev["ts"] + ev["dur"], ev["name"]))
        if ph == "i" and ev.get("s", "t") not in ("t", "p", "g"):
            problems.append(f"event {i} (i): bad scope {ev.get('s')!r}")
    eps = 2e-3  # 2ns: ts/dur are rounded to 3 decimals of a us, so two
    #             touching spans can land 0.001us "overlapped"
    for (pid, tid), sp in sorted(spans.items()):
        sp.sort()
        for (s0, e0, n0), (s1, e1, n1) in zip(sp, sp[1:]):
            if s1 < e0 - eps:
                problems.append(
                    f"track pid={pid} tid={tid}: span {n1!r}@{s1} overlaps "
                    f"{n0!r} ending {e0}")
    return problems


# ---------------------------------------------------------------------------
# Builders: report layers -> tracks
# ---------------------------------------------------------------------------

# thread ids inside one job's process
TID_COMPUTE, TID_COMM, TID_EXPOSED = 0, 1, 2
_LINK_TID_BASE = 8  # counter tracks sit above the resource threads


def _as_dict(obj) -> Dict:
    """A report in dict form: live objects go through their ``to_dict``."""
    return obj if isinstance(obj, Mapping) else obj.to_dict()


def timeline_tracks(trace: Trace, pid: int, label: str,
                    timeline: Sequence[Tuple[str, float, float]],
                    task_exposed_s: Optional[Mapping[str, float]] = None,
                    task_args: Optional[Mapping[str, Dict]] = None,
                    t0: float = 0.0) -> Trace:
    """One job's executed schedule as compute/comm/exposed threads.

    ``timeline`` entries are the scheduler's ``("comp:<id>"|"comm:<id>",
    start, end)`` segments; ``task_exposed_s`` flags each comm task's
    stall interval — the last ``exposed_s`` seconds before its final
    segment retires (exact: ``wait_for_running`` stalls compute until
    the in-flight comm finishes) — as a red span on its own thread;
    ``task_args`` attaches per-comm-task span args (algorithm, size,
    codec).  ``t0`` shifts the whole job (cluster phase offsets)."""
    trace.process(pid, label)
    trace.thread(pid, TID_COMPUTE, "compute")
    trace.thread(pid, TID_COMM, "comm")
    if task_exposed_s:
        trace.thread(pid, TID_EXPOSED, "exposed comm")
    last_comm_end: Dict[str, float] = {}
    for name, start, end in timeline:
        kind, _, task_id = name.partition(":")
        if kind == "comm":
            args = dict((task_args or {}).get(task_id, {}))
            exposed = (task_exposed_s or {}).get(task_id, 0.0)
            if exposed > 0:
                args["exposed_s"] = exposed
            trace.span(task_id, t0 + start, end - start, pid=pid,
                       tid=TID_COMM, cat="comm", args=args or None)
            last_comm_end[task_id] = max(last_comm_end.get(task_id, end),
                                         end)
        else:
            trace.span(task_id, t0 + start, end - start, pid=pid,
                       tid=TID_COMPUTE, cat="compute")
    for task_id, exposed in sorted((task_exposed_s or {}).items()):
        if exposed <= 0 or task_id not in last_comm_end:
            continue
        end = last_comm_end[task_id]
        trace.span(f"exposed:{task_id}", t0 + end - exposed, exposed,
                   pid=pid, tid=TID_EXPOSED, cat="exposed",
                   cname=EXPOSED_CNAME, args={"exposed_s": exposed})
    return trace


def _link_counter_tracks(trace: Trace, pid: int, report: Dict, topo,
                         t0: float, max_links: int) -> None:
    """Per-link byte-rate counter tracks for one job's comm schedule,
    regenerated from the persisted choices through the network layer
    (``net.simulate.link_rate_series``; no in-network-aggregation
    discount — the profile is the pre-aggregation offered load)."""
    from repro_torch.ccl.select import flows_on_topology
    from repro_torch.core.demand import CommTask
    from repro_torch.net.simulate import link_rate_series

    choices = {c["task_id"]: c for c in report.get("choices", [])}
    placed = []
    for name, start, end in report.get("timeline", []):
        kind, _, task_id = name.partition(":")
        c = choices.get(task_id)
        if kind != "comm" or c is None:
            continue
        task = CommTask(task_id, c["primitive"], c["size_bytes"],
                        tuple(c["group"]))
        try:
            fs = flows_on_topology(topo, task, c["algorithm"])
        except (ValueError, KeyError):
            continue  # degraded view without this group's route
        placed.append((fs, start, end))
    if not placed:
        return
    series = link_rate_series(topo, placed)
    # keep the hottest tracks (by byte-seconds area), deterministic order
    def area(points):
        return sum(r * (points[i + 1][0] - t)
                   for i, (t, r) in enumerate(points[:-1]))

    links = sorted(series, key=lambda l: (-area(series[l]), str(l)))
    for i, link in enumerate(links[:max_links]):
        name = f"link {'->'.join(str(n) for n in link)} B/s"
        for t, rate in series[link]:
            trace.counter(name, t0 + t, {"bytes_per_s": rate}, pid=pid,
                          tid=_LINK_TID_BASE + i)


def trace_from_report(report, topo=None, trace: Optional[Trace] = None,
                      pid: int = 1, label: Optional[str] = None,
                      t0: float = 0.0, max_links: int = 16) -> Trace:
    """A ``CodesignReport`` (live or ``to_dict()`` JSON) as one process:
    compute / comm / exposed threads plus — when the live ``Topology``
    is given — per-link utilization counters."""
    d = _as_dict(report)
    trace = trace if trace is not None else Trace()
    if label is None:
        label = (f"plan jct={d.get('jct', 0.0):.4g}s "
                 f"({d.get('policy', '?')}, {d.get('cost_model', '?')})")
    task_args = {}
    for c in d.get("choices", []):
        args = {"algorithm": c["algorithm"], "primitive": c["primitive"],
                "size_bytes": c["size_bytes"], "cost_s": c["cost_s"]}
        if c.get("codec"):
            args["codec"] = c["codec"]
        task_args[c["task_id"]] = args
    timeline_tracks(trace, pid, label, d.get("timeline", []),
                    task_exposed_s=d.get("task_exposed_s", {}),
                    task_args=task_args, t0=t0)
    if topo is not None:
        _link_counter_tracks(trace, pid, d, topo, t0, max_links)
    return trace


def trace_from_search(result, topo=None, max_links: int = 16) -> Trace:
    """A ``SearchResult``: the winning plan's full tracks plus a search
    process — every frontier candidate as an instant (args carry its
    assignment, JCT and feasibility; the evaluation index is the
    pseudo-time axis) and JCT counter series."""
    d = _as_dict(result)
    trace = Trace()
    trace_from_report(d["best"], topo=topo, trace=trace, pid=1,
                      max_links=max_links)
    pid = trace.process(0, f"search ({d.get('evaluated', 0)} evals)",
                        sort_index=-1)
    trace.thread(pid, 0, "frontier")
    telemetry = d.get("telemetry", {})
    if telemetry:
        trace.instant("telemetry", 0.0, pid=pid, tid=0, scope="p",
                      args=telemetry)
    best_jct = d.get("best", {}).get("jct")
    for i, cand in enumerate(d.get("frontier", [])):
        assignment = {
            k: (v.get("strategy", "custom") if isinstance(v, Mapping)
                else v)
            for k, v in cand.get("assignment", {}).items()}
        trace.instant(
            "candidate", float(i), pid=pid, tid=0,
            args={"assignment": assignment, "jct": cand.get("jct"),
                  "feasible": cand.get("feasible"),
                  "reason": cand.get("reason"),
                  "requests": cand.get("requests", 1)})
        values = {"jct_s": cand.get("jct", 0.0)}
        if best_jct is not None:
            values["best_jct_s"] = best_jct
        trace.counter("frontier jct", float(i), values, pid=pid, tid=1)
    return trace


def trace_from_cluster(report, topo=None, trace: Optional[Trace] = None,
                       pid_base: int = 1, t0: float = 0.0,
                       max_links: int = 4) -> Trace:
    """A ``ClusterReport``: one process group per tenant — each tenant's
    iteration tracks shifted by its staggered phase offset — plus a
    cluster process carrying the contended-link map as instants."""
    d = _as_dict(report)
    trace = trace if trace is not None else Trace()
    cpid = trace.process(pid_base - 1, "cluster", sort_index=-1)
    trace.thread(cpid, 0, "contention")
    for i, (link, users) in enumerate(sorted(d.get("contended",
                                                   {}).items())):
        trace.instant(f"contended {link}", t0 + float(i) * 1e-6, pid=cpid,
                      tid=0, scope="p", args={"bytes_by_job": dict(users)})
    phases = d.get("phases", {})
    staggered = d.get("staggered_jct", {})
    for i, job in enumerate(d.get("jobs", [])):
        name = job["name"]
        phase = phases.get(name, 0.0)
        label = (f"{name} phase={phase:.4g}s "
                 f"jct={staggered.get(name, 0.0):.4g}s")
        trace_from_report(job["report"], topo=topo, trace=trace,
                          pid=pid_base + i, label=label, t0=t0 + phase,
                          max_links=max_links)
    return trace


def trace_from_serving(report, topo=None, trace: Optional[Trace] = None,
                       pid_base: int = 1, max_links: int = 8) -> Trace:
    """A ``ServingReport``: one serving process whose lanes carry each
    request's lifetime — a *queue* span (arrival to prefill admission),
    a *prefill* span (admission to first token) and a *decode* span
    (first token to finish) — with SLO violations flagged as red
    instants, plus the priced prefill/decode batch plans as their own
    processes.  Requests are packed greedily into lanes so concurrent
    lifetimes never overlap on one track (the ``validate_chrome``
    invariant)."""
    d = _as_dict(report)
    trace = trace if trace is not None else Trace()
    spid = trace.process(
        pid_base - 1,
        f"serving {d.get('name', '?')} "
        f"ttft_p99={d.get('ttft', {}).get('p99', 0.0):.4g}s "
        f"attain={d.get('slo_attainment', 0.0):.3g}",
        sort_index=-1)
    summary = {k: d.get(k) for k in
               ("offered_rps", "goodput_rps", "slo_attainment",
                "stagger_s", "horizon_s", "kv_bytes_per_request")}
    summary["ttft"] = d.get("ttft", {})
    summary["tpot"] = d.get("tpot", {})
    trace.instant("summary", 0.0, pid=spid, tid=0, scope="p", args=summary)
    slo = d.get("slo", {})
    lanes: List[float] = []  # per-lane last span end
    reqs = sorted(d.get("requests", []),
                  key=lambda r: (r.get("t_arrive", 0.0), str(r.get("rid"))))
    for r in reqs:
        t_arr = r.get("t_arrive", 0.0)
        t_pf = r.get("t_prefill", t_arr)
        t_first = r.get("t_first")
        t_fin = r.get("t_finish")
        if t_first is None or t_fin is None:
            continue
        lane = next((i for i, end in enumerate(lanes)
                     if end <= t_arr + 1e-12), None)
        if lane is None:
            lane = len(lanes)
            lanes.append(0.0)
            trace.thread(spid, lane, f"lane {lane}")
        lanes[lane] = t_fin
        rid = r.get("rid", "?")
        args = {"ttft_s": r.get("ttft"), "tpot_s": r.get("tpot"),
                "slo_ok": r.get("slo_ok")}
        if t_pf > t_arr:
            trace.span(f"queue:{rid}", t_arr, t_pf - t_arr, pid=spid,
                       tid=lane, cat="queue")
        trace.span(f"prefill:{rid}", t_pf, t_first - t_pf, pid=spid,
                   tid=lane, cat="prefill", args=args)
        trace.span(f"decode:{rid}", t_first, t_fin - t_first, pid=spid,
                   tid=lane, cat="decode")
        if not r.get("slo_ok", True):
            trace.instant(
                f"slo_violation:{rid}", t_first, pid=spid, tid=lane,
                cname=EXPOSED_CNAME,
                args={"ttft_s": r.get("ttft"), "tpot_s": r.get("tpot"),
                      "slo_ttft_s": slo.get("ttft_s"),
                      "slo_tpot_s": slo.get("tpot_s")})
    for i, phase in enumerate(("prefill", "decode")):
        ph = d.get(phase)
        if ph:
            trace_from_report(ph, topo=topo, trace=trace, pid=pid_base + i,
                              label=f"{phase} batch plan",
                              max_links=max_links)
    return trace


def trace_from_dynamics(report, topo=None) -> Trace:
    """A ``DynamicsReport``: the event stream as instants on a cluster
    dynamics track (kind/target, replan mode, evictions), replan cost as
    spans, worst-stretch / dirty-set counters — then the final plan's
    tenant processes."""
    d = _as_dict(report)
    trace = Trace()
    pid = trace.process(0, "cluster dynamics", sort_index=-2)
    trace.thread(pid, 0, "events")
    trace.thread(pid, 1, "replan")
    cursor = 0.0  # replan spans mix event time with wall-clock duration;
    #               the cursor keeps the track's spans disjoint
    for rec in d.get("records", []):
        t = rec.get("time", 0.0)
        args = {"mode": rec["mode"], "dirty_jobs": rec["dirty_jobs"],
                "dirty_links": rec["dirty_links"],
                "replan_s": rec["replan_s"],
                "worst_stretch": rec["worst_stretch"]}
        if rec.get("regret") is not None:
            args["regret"] = rec["regret"]
        trace.instant(f"{rec['kind']}:{rec['target']}", t, pid=pid, tid=0,
                      scope="p", args=args,
                      cname=None if rec["mode"] == "incremental"
                      else EXPOSED_CNAME)
        for name in rec.get("evicted", []):
            trace.instant(f"evict:{name}", t, pid=pid, tid=0, scope="p",
                          cname=EXPOSED_CNAME)
        start = max(t, cursor)
        trace.span(f"replan[{rec['mode']}]", start, rec["replan_s"],
                   pid=pid, tid=1, cat="replan",
                   args={"full_replan_s": rec.get("full_replan_s")})
        cursor = start + rec["replan_s"]
        trace.counter("worst stretch", t,
                      {"stretch": rec["worst_stretch"]}, pid=pid, tid=2)
        trace.counter("dirty", t,
                      {"jobs": len(rec["dirty_jobs"]),
                       "links": len(rec["dirty_links"])}, pid=pid, tid=3)
    telemetry = d.get("telemetry", {})
    if telemetry:
        trace.instant("telemetry", 0.0, pid=pid, tid=0, scope="p",
                      args=telemetry)
    trace_from_cluster(d["final"], topo=topo, trace=trace, pid_base=2)
    return trace
