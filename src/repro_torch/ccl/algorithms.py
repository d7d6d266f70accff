"""Collective algorithms as explicit flow schedules.

Each generator takes a CommTask and emits the point-to-point flows of a
concrete algorithm, step by step — the "CCL generates communication
traffic" layer of the paper's paradigm.  The network layer
(repro_torch.net) simulates these flows on a topology;
repro_torch.ccl.primitives executes the same schedules as collectives on
``torch.distributed``.

Conventions: ``size_bytes`` on the input task is the per-participant payload
(e.g. the gradient shard size for All-Reduce).  Flows carry actual wire
bytes per step.

The port's copy of ``repro.ccl.algorithms``, kept line for line: importing
any ``repro`` module runs the JAX package's ``__init__``, which imports jax,
so the port keeps its own.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, List, Sequence

from repro_torch.core.demand import CommTask, Flow, FlowSet


def _ring_neighbors(group: Sequence[int]):
    p = len(group)
    return [(group[i], group[(i + 1) % p]) for i in range(p)]


# ---------------------------------------------------------------------------
# All-Reduce algorithms
# ---------------------------------------------------------------------------


def ring_all_reduce(task: CommTask) -> FlowSet:
    """Classic ring: (p-1) reduce-scatter steps + (p-1) all-gather steps,
    chunk = n/p per step.  Wire bytes per node: 2 n (p-1)/p."""
    group = task.group
    p = len(group)
    fs = FlowSet(task_id=task.task_id, algorithm="ring")
    if p == 1:
        return fs
    chunk = task.size_bytes // p
    step = 0
    for phase in range(2):  # 0 = reduce-scatter, 1 = all-gather
        for s in range(p - 1):
            for src, dst in _ring_neighbors(group):
                fs.flows.append(Flow(src, dst, chunk, task.task_id, step,
                                     task.job_id))
            step += 1
    fs.num_steps = step
    return fs


def bidir_ring_all_reduce(task: CommTask) -> FlowSet:
    """Two half-size rings in opposite directions (NCCL-style channels)."""
    group = task.group
    p = len(group)
    fs = FlowSet(task_id=task.task_id, algorithm="bidir_ring")
    if p == 1:
        return fs
    chunk = task.size_bytes // (2 * p)
    step = 0
    for phase in range(2):
        for s in range(p - 1):
            for src, dst in _ring_neighbors(group):
                fs.flows.append(Flow(src, dst, chunk, task.task_id, step,
                                     task.job_id))
                fs.flows.append(Flow(dst, src, chunk, task.task_id, step,
                                     task.job_id))
            step += 1
    fs.num_steps = step
    return fs


def halving_doubling_all_reduce(task: CommTask) -> FlowSet:
    """Recursive halving (reduce-scatter) + doubling (all-gather):
    2*log2(p) steps, latency-optimal for small payloads."""
    group = task.group
    p = len(group)
    fs = FlowSet(task_id=task.task_id, algorithm="halving_doubling")
    if p == 1:
        return fs
    assert p & (p - 1) == 0, "halving-doubling requires power-of-two group"
    step = 0
    # reduce-scatter: exchange halves at distance p/2, p/4, ...
    dist = p // 2
    size = task.size_bytes // 2
    while dist >= 1:
        for i, node in enumerate(group):
            peer = group[i ^ dist]
            fs.flows.append(Flow(node, peer, size, task.task_id, step,
                                 task.job_id))
        dist //= 2
        size //= 2
        step += 1
    # all-gather: reverse
    dist = 1
    size = task.size_bytes // p
    while dist < p:
        for i, node in enumerate(group):
            peer = group[i ^ dist]
            fs.flows.append(Flow(node, peer, size, task.task_id, step,
                                 task.job_id))
        dist *= 2
        size *= 2
        step += 1
    fs.num_steps = step
    return fs


def tree_all_reduce(task: CommTask) -> FlowSet:
    """Binary-tree reduce + broadcast: 2*ceil(log2 p) steps of full payload.
    Latency-friendly; bandwidth cost n*log(p) at the root links."""
    group = task.group
    p = len(group)
    fs = FlowSet(task_id=task.task_id, algorithm="tree")
    if p == 1:
        return fs
    depth = math.ceil(math.log2(p))
    step = 0
    # reduce towards group[0]
    stride = 1
    for _ in range(depth):
        for i in range(0, p, stride * 2):
            j = i + stride
            if j < p:
                fs.flows.append(Flow(group[j], group[i], task.size_bytes,
                                     task.task_id, step, task.job_id))
        stride *= 2
        step += 1
    # broadcast back down
    stride = 2 ** (depth - 1)
    for _ in range(depth):
        for i in range(0, p, stride * 2):
            j = i + stride
            if j < p:
                fs.flows.append(Flow(group[i], group[j], task.size_bytes,
                                     task.task_id, step, task.job_id))
        stride //= 2
        step += 1
    fs.num_steps = step
    return fs


# ---------------------------------------------------------------------------
# All-Gather / Reduce-Scatter / Broadcast / All-to-All
# ---------------------------------------------------------------------------


def ring_all_gather(task: CommTask) -> FlowSet:
    group = task.group
    p = len(group)
    fs = FlowSet(task_id=task.task_id, algorithm="ring_ag")
    chunk = task.size_bytes // max(p, 1)  # size_bytes = TOTAL payload
    for s in range(p - 1):
        for src, dst in _ring_neighbors(group):
            fs.flows.append(Flow(src, dst, chunk, task.task_id, s,
                                 task.job_id))
    fs.num_steps = max(p - 1, 0)
    return fs


def ring_reduce_scatter(task: CommTask) -> FlowSet:
    fs = ring_all_gather(task)
    fs.algorithm = "ring_rs"
    return fs


def binomial_broadcast(task: CommTask) -> FlowSet:
    """Binomial-tree broadcast from group[0]: log2(p) steps."""
    group = task.group
    p = len(group)
    fs = FlowSet(task_id=task.task_id, algorithm="binomial_bcast")
    have = [group[0]]
    step = 0
    rest = list(group[1:])
    while rest:
        senders = list(have)
        for s in senders:
            if not rest:
                break
            dst = rest.pop(0)
            fs.flows.append(Flow(s, dst, task.size_bytes, task.task_id, step,
                                 task.job_id))
            have.append(dst)
        step += 1
    fs.num_steps = step
    return fs


def direct_all_to_all(task: CommTask) -> FlowSet:
    """Every pair exchanges n/p directly in one logical step (switch fabric)
    — the MoE dispatch pattern."""
    group = task.group
    p = len(group)
    fs = FlowSet(task_id=task.task_id, algorithm="direct_a2a")
    chunk = task.size_bytes // max(p, 1)
    for src in group:
        for dst in group:
            if src != dst:
                fs.flows.append(Flow(src, dst, chunk, task.task_id, 0,
                                     task.job_id))
    fs.num_steps = 1
    return fs


def ring_all_to_all(task: CommTask) -> FlowSet:
    """p-1 rounds of neighbor exchange (torus-friendly A2A)."""
    group = task.group
    p = len(group)
    fs = FlowSet(task_id=task.task_id, algorithm="ring_a2a")
    chunk = task.size_bytes // max(p, 1)
    for s in range(p - 1):
        for src, dst in _ring_neighbors(group):
            # at round s the payload is everything still in flight: send the
            # chunk destined s+1 hops away; wire bytes stay n/p per step
            fs.flows.append(Flow(src, dst, chunk, task.task_id, s,
                                 task.job_id))
    fs.num_steps = max(p - 1, 0)
    return fs


def ring_permute(task: CommTask) -> FlowSet:
    """One collective-permute step: every participant sends its chunk to
    the next ring neighbor.  This is the unit step of a *decomposed*
    collective (``parallel/collective_matmul.py``): an All-Gather is p-1
    such permutes interleaved with p partial matmuls, a Reduce-Scatter
    p-1 permutes of the running accumulator — which is what lets the
    scheduler hide each step under the adjacent compute chunk."""
    group = task.group
    fs = FlowSet(task_id=task.task_id, algorithm="ring")
    if len(group) <= 1:
        return fs
    for src, dst in _ring_neighbors(group):
        fs.flows.append(Flow(src, dst, task.size_bytes, task.task_id, 0,
                             task.job_id))
    fs.num_steps = 1
    return fs


def torus2d_all_reduce(task: CommTask, rows: int = 0) -> FlowSet:
    """Dimension-ordered 2D-torus All-Reduce (what XLA emits on a TPU pod):
    ring reduce-scatter along rows, then along columns on the 1/rows
    shard, then all-gather back in reverse.  Wire bytes/node match the 1D
    ring (2n(p-1)/p) but the step count drops from 2(p-1) to
    2(rows-1) + 2(cols-1), and row/column phases use disjoint torus link
    dimensions.  Assumes ``group`` is laid out row-major rows x cols."""
    group = task.group
    p = len(group)
    if rows <= 0:
        rows = int(math.isqrt(p))
    cols = p // rows
    assert rows * cols == p, (rows, p)
    fs = FlowSet(task_id=task.task_id, algorithm="torus2d")
    if p == 1:
        return fs
    step = 0

    def ring_pass(groups, chunk, phases, step0):
        s = step0
        for _ in range(phases):
            for g in groups:
                for i in range(len(g)):
                    fs.flows.append(Flow(g[i], g[(i + 1) % len(g)], chunk,
                                         task.task_id, s, task.job_id))
            s += 1
        return s

    row_groups = [[group[r * cols + c] for c in range(cols)]
                  for r in range(rows)]
    col_groups = [[group[r * cols + c] for r in range(rows)]
                  for c in range(cols)]
    # RS along rows: chunks n/cols
    step = ring_pass(row_groups, task.size_bytes // cols, cols - 1, step)
    # RS along cols on the row-shard: chunks n/(cols*rows)
    step = ring_pass(col_groups, task.size_bytes // p, rows - 1, step)
    # AG along cols, then AG along rows
    step = ring_pass(col_groups, task.size_bytes // p, rows - 1, step)
    step = ring_pass(row_groups, task.size_bytes // cols, cols - 1, step)
    fs.num_steps = step
    return fs


def hierarchical_all_reduce(task: CommTask,
                            hosts: Sequence[Sequence[int]] = None) -> FlowSet:
    """The paper's "Intra-Inter" co-designed All-Reduce (Sec. IV-B; Horovod /
    BlueConnect-style): keep bulk traffic on the fast intra-host fabric and
    cross the slow NIC tier only once per host, via a leader.

      1. intra-host ring reduce-scatter   (m-1 steps, chunks n/m)
      2. shard relay to the host leader    (1 step; leader holds the host sum)
      3. ring all-reduce over the H leaders (2(H-1) steps on the NIC tier)
      4. shard relay back from the leader  (1 step)
      5. intra-host ring all-gather        (m-1 steps)

    NIC bytes per host drop from ~2n (flat ring crossing) to 2n(H-1)/H.
    ``hosts`` partitions ``task.group`` into equal-size hosts (first member
    = leader); default: contiguous blocks of 8 (the DGX convention)."""
    group = task.group
    p = len(group)
    fs = FlowSet(task_id=task.task_id, algorithm="hierarchical")
    if p == 1:
        return fs
    if hosts is None:
        if p > 8 and p % 8 == 0:
            hosts = [group[i:i + 8] for i in range(0, p, 8)]
        else:
            raise ValueError(
                f"cannot infer host partition for group of {p}; pass hosts=")
    hosts = [tuple(h) for h in hosts]
    sizes = {len(h) for h in hosts}
    hcount = len(hosts)
    if hcount < 2 or len(sizes) != 1 or sum(map(len, hosts)) != p:
        raise ValueError(
            f"hierarchical all-reduce needs >=2 equal-size hosts covering "
            f"the group; got sizes {sorted(map(len, hosts))} for p={p}")
    m = sizes.pop()
    if m == 1:
        return ring_all_reduce(task)  # every device its own host: flat ring
    n = task.size_bytes
    chunk = n // m
    step = 0

    def intra_ring_pass(phases: int, step0: int) -> int:
        s = step0
        for _ in range(phases):
            for h in hosts:
                for i in range(m):
                    fs.flows.append(Flow(h[i], h[(i + 1) % m], chunk,
                                         task.task_id, s, task.job_id))
            s += 1
        return s

    def relay(to_leader: bool, step0: int) -> int:
        for h in hosts:
            for dev in h[1:]:
                src, dst = (dev, h[0]) if to_leader else (h[0], dev)
                fs.flows.append(Flow(src, dst, chunk, task.task_id, step0,
                                     task.job_id))
        return step0 + 1

    step = intra_ring_pass(m - 1, step)          # reduce-scatter
    step = relay(True, step)                     # shards -> leader
    leaders = [h[0] for h in hosts]
    inter_chunk = n // hcount
    for _ in range(2):                           # leader ring AR (RS + AG)
        for _ in range(hcount - 1):
            for i in range(hcount):
                fs.flows.append(Flow(leaders[i], leaders[(i + 1) % hcount],
                                     inter_chunk, task.task_id, step,
                                     task.job_id))
            step += 1
    step = relay(False, step)                    # leader -> shards
    step = intra_ring_pass(m - 1, step)          # all-gather
    fs.num_steps = step
    return fs


def atp_all_reduce(task: CommTask, ps: int = None) -> FlowSet:
    """In-network aggregation All-Reduce (paper Sec. IV-B "Host-Net", ATP
    [15] / SwitchML-style): every worker pushes its full gradient toward an
    aggregation point and receives the sum back — two steps total.

    The flow schedule is a parameter-server pattern (workers -> ``ps``,
    ``ps`` -> workers; ``ps`` defaults to the group leader); the in-network
    part happens at simulation time: pricing it with
    ``aggregate_at=<programmable switches>`` merges the upstream flows at
    the first shared switch and multicasts the downstream ones, so each
    fabric link carries the payload once.  Without aggregation-capable
    switches this degrades to plain host PS aggregation — the multi-tenant
    switch-memory fallback."""
    group = task.group
    p = len(group)
    fs = FlowSet(task_id=task.task_id, algorithm="atp")
    if p == 1:
        return fs
    if ps is None:
        ps = group[0]
    for w in group:
        if w != ps:
            fs.flows.append(Flow(w, ps, task.size_bytes, task.task_id, 0,
                                 task.job_id))
    for w in group:
        if w != ps:
            fs.flows.append(Flow(ps, w, task.size_bytes, task.task_id, 1,
                                 task.job_id))
    fs.num_steps = 2
    return fs


def direct_p2p(task: CommTask) -> FlowSet:
    """Point-to-point transfer: one flow from ``group[0]`` to ``group[1]``
    (pipeline-parallel activation hand-off, serving KV-cache shard
    migration from a prefill rank to a decode rank).  Degenerate as a
    "collective", but routing it through the same FlowSet machinery means
    p2p traffic shows up in link utilization maps and contends in FlowSim
    like everything else."""
    group = task.group
    fs = FlowSet(task_id=task.task_id, algorithm="direct")
    if len(group) < 2 or group[0] == group[1]:
        return fs
    fs.flows.append(Flow(group[0], group[1], task.size_bytes, task.task_id,
                         0, task.job_id))
    fs.num_steps = 1
    return fs


# ---------------------------------------------------------------------------
# Compressed candidates (repro_torch.compress): same schedule, fewer wire bytes
# ---------------------------------------------------------------------------


def compressed_flows(task: CommTask, base: str, codec_name: str,
                     **kwargs) -> FlowSet:
    """Wrap a base algorithm's schedule with a codec: every flow carries
    ``wire_ratio`` of its uncompressed bytes (encode before the wire,
    decode-accumulate after — the executable analogue is
    ``ccl.primitives.compressed_ring_all_reduce``).  ``base`` may be
    ``ps``, the parameter-server alias for the ``atp`` flow pattern.

    Approximation: the ratio is applied uniformly per step.  For top-k
    that understates later reduce-scatter steps (partial sums densify);
    the nominal ``CodecSpec.wire_ratio`` already includes index overhead
    to compensate."""
    from repro_torch.compress.codec import base_algorithm, codec_spec

    spec = codec_spec(codec_name)
    gen = ALGORITHMS[task.primitive][base_algorithm(base)]
    fs = gen(task, **kwargs)
    fs.algorithm = f"{base}+{codec_name}"
    fs.flows = [
        dataclasses.replace(f, size_bytes=max(int(f.size_bytes
                                                  * spec.wire_ratio), 1))
        for f in fs.flows]
    return fs


# The canonical compressed all-reduce candidates selection prices (any
# "<base>+<codec>" pair also works ad hoc through generate_flows):
COMPRESSED_CANDIDATES = ("ring+q8", "bidir_ring+q8", "hierarchical+q8",
                         "ring+topk", "ps+topk")


def _compressed_registry() -> Dict[str, Callable[[CommTask], FlowSet]]:
    out: Dict[str, Callable[[CommTask], FlowSet]] = {}
    for name in COMPRESSED_CANDIDATES:
        base, codec = name.split("+", 1)
        out[name] = functools.partial(compressed_flows, base=base,
                                      codec_name=codec)
    return out


ALGORITHMS: Dict[str, Dict[str, Callable[[CommTask], FlowSet]]] = {
    "all_reduce": {
        "ring": ring_all_reduce,
        "bidir_ring": bidir_ring_all_reduce,
        "halving_doubling": halving_doubling_all_reduce,
        "tree": tree_all_reduce,
        "torus2d": torus2d_all_reduce,
        "hierarchical": hierarchical_all_reduce,
        "atp": atp_all_reduce,
        **_compressed_registry(),
    },
    "all_gather": {"ring": ring_all_gather},
    "reduce_scatter": {"ring": ring_reduce_scatter},
    "broadcast": {"binomial": binomial_broadcast},
    "all_to_all": {"direct": direct_all_to_all, "ring": ring_all_to_all},
    "permute": {"ring": ring_permute},
    "p2p": {"direct": direct_p2p},
}


def generate_flows(task: CommTask, algorithm: str, **kwargs) -> FlowSet:
    """Generate ``algorithm``'s flow schedule for ``task``.  Extra kwargs go
    to the generator (e.g. ``hosts=`` for hierarchical, ``rows=`` for
    torus2d).  ``"<base>+<codec>"`` names not in the canonical registry are
    composed on the fly (any base algorithm x registered codec)."""
    prims = ALGORITHMS[task.primitive]
    if algorithm not in prims:
        if "+" in algorithm:
            from repro_torch.compress.codec import base_algorithm

            base, codec = algorithm.split("+", 1)
            if base_algorithm(algorithm) in prims:
                return compressed_flows(task, base, codec, **kwargs)
        raise KeyError(f"{algorithm!r} not available for {task.primitive}; "
                       f"have {list(prims)}")
    return prims[algorithm](task, **kwargs)
