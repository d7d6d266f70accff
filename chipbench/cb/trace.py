"""The device trace of a few steps: ``torch.profiler`` (CUPTI) reduced, on
the rank that took it, to a summary that the metric readers read.

- ``window_us``: the traced span on the host clock, from the profiler's
  start to the synchronize after the last traced step (the profiler's own
  start and stop left out); ``busy_us``: the union of every device
  activity's interval (all streams: kernels, copies, fills; not the
  annotations' ranges), so overlapping streams count once;
- ``kernels``: {name: [count, device us]} of every device activity;
- ``gaps``: {what the host was doing: idle device us}, each gap between
  device intervals named by the innermost host event running at its
  middle (an op, an autograd node; not a CUDA runtime call).
"""
from __future__ import annotations

import bisect
import re
from typing import Dict, List, Sequence


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def union_us(intervals: Sequence[tuple]) -> tuple:
    """(busy us, merged intervals) of (start, end) pairs."""
    merged: List[list] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


# ranges that the profiler draws on the device's timeline for host
# annotations (``record_function``, c10d's ``nccl:*``): they span kernels,
# and are not device work
ANNOTATIONS = ("aten::", "nccl:", "c10d::", "ProfilerStep",
               "record_param_comms")


def _annotation(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False)) or \
        e.name.startswith(ANNOTATIONS)


def summarize(prof, steps: int, window_us: float) -> dict:
    from torch.autograd import DeviceType
    dev, cpu = [], []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if not _annotation(e):
                dev.append(e)
        elif e.device_type == DeviceType.CPU:
            cpu.append(e)
    kernels: Dict[str, list] = {}
    for e in dev:
        k = kernels.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += e.time_range.end - e.time_range.start
    busy, merged = union_us([(e.time_range.start, e.time_range.end)
                             for e in dev])
    ops = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in cpu if not e.name.startswith("cuda"))
    starts = [o[0] for o in ops]
    gaps: Dict[str, float] = {}
    for (_, b), (c, _) in zip(merged, merged[1:]):
        mid = 0.5 * (b + c)
        label = "no host event"
        i = bisect.bisect_right(starts, mid)
        for j in range(i - 1, max(-1, i - 400), -1):
            if ops[j][1] >= mid:
                label = ops[j][2]
                break
        gaps[label] = gaps.get(label, 0.0) + (c - b)
    return {"steps": steps, "window_us": window_us, "busy_us": busy,
            "kernels": kernels, "gaps": gaps}


def per_step_us(traces: Sequence[dict], pattern: str) -> float:
    """Device us a step of the kernels whose name matches ``pattern``, the
    mean over the ranks' traces (0 where none matches)."""
    rx = re.compile(pattern)
    vals = [sum(us for name, (_, us) in t["kernels"].items()
                if rx.search(name)) / t["steps"] for t in traces]
    return sum(vals) / len(vals)


def top(d: Dict[str, float], n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
