"""In-network aggregation — "Host-Net" co-design (paper Sec. IV-B, ATP [15]).

On a fat-tree with programmable ToR/Agg switches, gradient flows from
workers under the same switch can be summed in-network: upstream of the
switch only one aggregated flow continues, reducing core-layer traffic.
No TPU/ICI analogue exists (DESIGN.md hardware-adaptation note) — this is
a network-layer model used by the benchmark reproducing ATP's traffic
reduction, including the multi-tenant fallback (switch memory exhausted ->
degrade to host aggregation).

The port's copy of ``repro.sched.atp``, kept line for line: importing any
``repro`` module runs the JAX package's ``__init__``, which imports jax, so
the port keeps its own.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Set, Tuple

from repro_torch.core.demand import CommTask, Flow, FlowSet
from repro_torch.net.topology import Topology
from repro_torch.net.simulate import link_utilization, simulate_flowset


def aggregation_switches(topo: Topology, group: Sequence[int],
                         capacity: Optional[int] = None) -> Set:
    """The switches able to aggregate a group's gradient flows in-network.

    ``capacity``: max concurrent aggregations a switch supports (None =
    unlimited).  A group larger than the capacity exhausts switch memory
    and gets the empty set — the multi-tenant degradation to host
    aggregation that ATP prices in.  This is the "Host-Net" hook the CCL
    selection layer (``ccl.select.FlowSim``) consults when pricing the
    ``atp`` all-reduce candidate."""
    if capacity is not None and len(group) > capacity:
        return set()
    return set(topo.switch_nodes())


def host_aggregation_flows(task: CommTask, ps_node) -> FlowSet:
    """Baseline: every worker sends its gradient to a parameter-server node
    (host aggregation), PS broadcasts back."""
    fs = FlowSet(task_id=task.task_id, algorithm="ps_host")
    for w in task.group:
        fs.flows.append(Flow(w, ps_node, task.size_bytes, task.task_id, 0,
                             task.job_id))
    for w in task.group:
        fs.flows.append(Flow(ps_node, w, task.size_bytes, task.task_id, 1,
                             task.job_id))
    fs.num_steps = 2
    return fs


def atp_traffic(topo: Topology, task: CommTask, ps_node,
                switch_capacity: Optional[int] = None
                ) -> Dict[str, float]:
    """Compare PS traffic with vs. without in-network aggregation.

    ``switch_capacity``: max concurrent aggregations a switch supports
    (None = unlimited); beyond it, flows fall back to host aggregation —
    ATP's multi-tenant degradation."""
    fs = host_aggregation_flows(task, ps_node)
    base_bytes = sum(link_utilization(topo, fs).values())
    base_time = simulate_flowset(topo, fs)

    agg_at = aggregation_switches(topo, task.group, switch_capacity)
    agg_time = simulate_flowset(topo, fs, aggregate_at=agg_at)

    # aggregated byte count: recount with merge semantics
    from repro_torch.net.simulate import _route_bytes  # noqa: PLC0415
    agg_bytes = sum(_route_bytes(topo, fs.flows, agg_at).values())
    return {
        "base_bytes": base_bytes, "agg_bytes": agg_bytes,
        "base_time": base_time, "agg_time": agg_time,
        "traffic_reduction": base_bytes / max(agg_bytes, 1.0),
        "speedup": base_time / max(agg_time, 1e-12),
    }
