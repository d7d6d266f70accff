"""CommDemand builder: parallelization strategy -> iteration task graph.

This is the quantitative bridge between the model/strategy layer and the
scheduler/CCL/network layers (the downward red arrow in Fig. 5a): given a
ModelConfig, a workload shape and a mesh, emit the compute tasks and the
collective tasks of ONE training iteration with their dependency edges and
sizes.  The schedulers and several benchmarks consume this.

Traffic sizes follow the classical accounting (all bf16 activations / f32
gradient sync unless stated):
  * Megatron TP: one All-Reduce of (B,S,d) per block per direction [7]
  * DP: one gradient sync (AR or RS+AG) per layer bucket
  * MoE EP: All-to-All dispatch+combine of the capacity buffers (fwd and
    bwd each) — the Lina/Janus bottleneck traffic
  * PP: p2p activation transfer per microbatch boundary

Two overlap rewrites make the iteration DAG searchable (the codesign
``bucket_bytes`` / ``decompose`` knobs):
  * ``bucket_bytes`` coalesces/splits per-layer gradient syncs into a
    chained bucket DAG — bucket *i* becomes ready the moment the last
    contributing layer's backward retires (MG-WFBP/ByteScheduler-style
    tensor fusion), exposing the bucket-size tradeoff to the scheduler.
  * :func:`decompose_demand` rewrites TP collectives into the p-step
    ring of ``parallel/collective_matmul.py``: the adjacent matmuls
    split into p partials and each ring permute rides under a partial.

The port's copy of ``repro.core.demand_builder``, kept line for line:
importing any ``repro`` module runs the JAX package's ``__init__``, which
imports jax, so the port keeps its own.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import hw
from repro_torch.core.demand import CommDemand, CommTask, ComputeTask
from repro_torch.core.types import MeshConfig, ModelConfig, ShapeConfig


@dataclass(frozen=True)
class DemandParams:
    mfu: float = 0.5              # assumed compute efficiency
    act_bytes: int = 2            # bf16 activations
    grad_bytes: int = 4           # f32 gradient sync
    zero1: bool = True            # reduce-scatter instead of all-reduce
    capacity_factor: float = 1.25
    grad_chunks: int = 1          # Lina-style splitting of gradient sync


def build_demand(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshConfig,
                 dp_params: Optional[DemandParams] = None,
                 bucket_bytes: Optional[int] = None) -> CommDemand:
    """Emit one iteration's task graph.  ``bucket_bytes`` switches the
    gradient sync from the legacy per-layer (x ``grad_chunks``) tasks to
    fused buckets of that size: layer grads accumulate in backward order
    and a bucket task is emitted the moment it fills, depending on the
    layer whose backward completed it — so big buckets amortize alpha
    while small buckets start (and hide) earlier."""
    if dp_params is None:
        dp_params = DemandParams()
    tp = mesh.tp
    dp = mesh.dp
    chips = mesh.num_devices
    tokens = shape.global_batch * shape.seq_len
    tokens_dev = tokens / chips  # per-device tokens (seq+batch sharded)
    d = cfg.d_model
    peak = hw.PEAK_FLOPS_BF16 * dp_params.mfu

    demand = CommDemand(job_id=f"{cfg.name}:{shape.name}")
    specs = cfg.layer_specs()
    pc = cfg.param_counts()
    per_layer_params = []
    moe_dff = cfg.moe_d_ff or cfg.d_ff

    def layer_active_params(spec) -> float:
        total = 0.0
        hd = cfg.resolved_head_dim
        if spec.mixer in ("attn", "cross_attn"):
            if cfg.attention == "mla":
                total += (d * cfg.q_lora_rank
                          + cfg.q_lora_rank * cfg.num_heads
                          * (hd + cfg.qk_rope_head_dim)
                          + d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
                          + cfg.kv_lora_rank * cfg.num_heads * 2 * hd
                          + cfg.num_heads * hd * d)
            else:
                total += d * hd * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)
        else:
            din = cfg.ssm_d_inner
            total += d * (2 * din + 2 * cfg.ssm_state + cfg.ssm_num_heads) \
                + din * d
        mult = 3 if cfg.ffn_act in ("swiglu", "geglu") else 2
        if spec.ffn == "dense":
            total += mult * d * cfg.d_ff
        elif spec.ffn == "moe":
            total += mult * d * moe_dff * (cfg.top_k
                                           + cfg.num_shared_experts)
        return total

    def layer_total_params(spec) -> float:
        """Gradient-sync size: ALL resident params (every expert), not the
        top-k active subset."""
        total = layer_active_params(spec)
        if spec.ffn == "moe":
            mult = 3 if cfg.ffn_act in ("swiglu", "geglu") else 2
            total += mult * d * moe_dff * (cfg.num_experts - cfg.top_k)
        return total

    # ---------------- forward ----------------
    mult = {"train": (2, 4), "prefill": (2, 0), "decode": (2, 0)}[shape.kind]
    fwd_mult, bwd_mult = mult
    tp_ar_bytes = int(tokens_dev * tp * d * dp_params.act_bytes)

    for i, spec in enumerate(specs):
        ap = layer_active_params(spec)
        per_layer_params.append(ap)
        flops_dev = fwd_mult * ap * tokens / chips
        demand.compute_tasks.append(ComputeTask(
            f"fwd{i}", flops_dev, flops_dev / peak, demand.job_id))
        if tp > 1:
            demand.comm_tasks.append(CommTask(
                f"tp_fwd{i}", "all_reduce", tp_ar_bytes,
                tuple(range(tp)), after_compute=(f"fwd{i}",),
                before_compute=f"fwd{i+1}" if i + 1 < len(specs) else "head",
                job_id=demand.job_id, axis="model"))
        if spec.ffn == "moe" and tp > 1:
            a2a = int(tokens_dev * cfg.top_k * d * dp_params.act_bytes
                      * dp_params.capacity_factor)
            demand.comm_tasks.append(CommTask(
                f"a2a_fwd{i}", "all_to_all", 2 * a2a,  # dispatch+combine
                tuple(range(tp)), after_compute=(f"fwd{i}",),
                before_compute=f"fwd{i+1}" if i + 1 < len(specs) else "head",
                job_id=demand.job_id, axis="model"))

    head_flops = fwd_mult * cfg.padded_vocab * d * tokens / chips
    demand.compute_tasks.append(ComputeTask(
        "head", head_flops, head_flops / peak, demand.job_id))

    if shape.kind != "train":
        return demand

    # ---------------- backward ----------------
    grad_prim = "reduce_scatter" if dp_params.zero1 else "all_reduce"
    bucket_acc = 0        # gradient bytes accumulated towards the bucket
    bucket_id = 0
    if bucket_bytes is not None:
        bucket_bytes = max(1, int(bucket_bytes))

    def emit_bucket(size: int, layer: int, slack: float) -> None:
        nonlocal bucket_id
        demand.comm_tasks.append(CommTask(
            f"gbucket{bucket_id}", grad_prim, size, tuple(range(dp)),
            after_compute=(f"bwd{layer}",), before_compute="opt",
            slack=slack, job_id=demand.job_id, axis="data"))
        bucket_id += 1

    for i in reversed(range(len(specs))):
        spec = specs[i]
        flops_dev = bwd_mult * per_layer_params[i] * tokens / chips
        demand.compute_tasks.append(ComputeTask(
            f"bwd{i}", flops_dev, flops_dev / peak, demand.job_id))
        if tp > 1:
            demand.comm_tasks.append(CommTask(
                f"tp_bwd{i}", "all_reduce", tp_ar_bytes,
                tuple(range(tp)), after_compute=(f"bwd{i}",),
                before_compute=f"bwd{i-1}" if i else "opt",
                job_id=demand.job_id, axis="model"))
        if spec.ffn == "moe" and tp > 1:
            a2a = int(tokens_dev * cfg.top_k * d * dp_params.act_bytes
                      * dp_params.capacity_factor)
            demand.comm_tasks.append(CommTask(
                f"a2a_bwd{i}", "all_to_all", 2 * a2a,
                tuple(range(tp)), after_compute=(f"bwd{i}",),
                before_compute=f"bwd{i-1}" if i else "opt",
                job_id=demand.job_id, axis="model"))
        if dp > 1:
            # gradient sync: overlappable (blocks only the optimizer);
            # slack = how much bwd compute remains to hide behind
            grad_bytes = int(layer_total_params(spec) / tp
                             * dp_params.grad_bytes)
            remaining = sum(per_layer_params[:i]) * bwd_mult \
                * tokens / chips / peak
            if bucket_bytes is None:
                # legacy per-layer sync, optionally Lina-split
                nchunks = max(1, dp_params.grad_chunks)
                for ci in range(nchunks):
                    demand.comm_tasks.append(CommTask(
                        f"grad{i}.{ci}", grad_prim,
                        grad_bytes // nchunks,
                        tuple(range(dp)), after_compute=(f"bwd{i}",),
                        before_compute="opt", slack=remaining,
                        job_id=demand.job_id, axis="data"))
            else:
                # fused buckets: emit every bucket this layer fills
                # (oversize layers emit several), carry the remainder
                bucket_acc += grad_bytes
                while bucket_acc >= bucket_bytes:
                    emit_bucket(bucket_bytes, i, remaining)
                    bucket_acc -= bucket_bytes
    if bucket_bytes is not None and bucket_acc > 0:
        emit_bucket(bucket_acc, 0, 0.0)  # trailing partial bucket

    opt_flops = 10 * pc["total"] / chips  # elementwise AdamW
    demand.compute_tasks.append(ComputeTask(
        "opt", opt_flops, opt_flops / peak, demand.job_id))
    return demand


# primitives decompose_demand knows how to rewrite (the codesign
# ``decompose=True`` knob expands to exactly this tuple)
DECOMPOSABLE_PRIMITIVES = ("all_reduce", "all_gather", "reduce_scatter")


def decompose_demand(demand: CommDemand,
                     primitives: Sequence[str] = DECOMPOSABLE_PRIMITIVES,
                     axis: Optional[str] = "model") -> CommDemand:
    """Rewrite bulk TP collectives into the p-step ring of
    ``parallel/collective_matmul.py`` (Wang et al., ASPLOS'23).

    A matched task with producer compute ``a`` and consumer ``b`` splits
    both into p partials (``a#0..a#{p-1}``) and replaces the bulk
    collective with 2(p-1) ``permute`` tasks carrying n/p each:

      * reduce-scatter half (``matmul_rs``): permute k of the running
        accumulator becomes ready when partial ``a#{k-1}`` retires and
        rides the wire under ``a#k``; only the last one gates ``b#0``.
      * all-gather half (``ag_matmul``): permute k carries the chunk
        partial ``b#k`` consumes and overlaps ``b#{k-1}`` (double
        buffering), so steady-state exposure per step is
        ``max(0, permute - partial)`` — the kernel's actual behaviour.

    Wire bytes are conserved (2(p-1)·n/p per participant = the bulk
    ring), so any JCT win is pure overlap, not free bandwidth.  A plain
    ``all_gather`` rewrites to the AG half only (consumer split), a
    ``reduce_scatter`` to the RS half (producer split).  Tasks whose
    adjacent compute is missing, or whose producer/consumer is already
    split with a different factor, are left intact.  Edges of untouched
    tasks are remapped onto the partials (``after`` -> last partial,
    ``before`` -> first)."""
    primitives = tuple(primitives)
    split: Dict[str, int] = {}          # compute task -> partial count
    decomposed: Dict[str, Tuple[str, Optional[str]]] = {}  # tid -> (a, b)
    compute_ids = {c.task_id for c in demand.compute_tasks}

    for t in demand.comm_tasks:
        p = len(t.group)
        if (t.primitive not in primitives or p <= 1
                or (axis is not None and t.axis != axis)):
            continue
        a = t.after_compute[0] if len(t.after_compute) == 1 else None
        b = t.before_compute
        need = {"all_reduce": (a, b), "all_gather": (None, b),
                "reduce_scatter": (a, None)}[t.primitive]
        anchors = [c for c in need if c is not None]
        if not anchors or any(c not in compute_ids for c in anchors):
            continue
        if any(split.get(c, p) != p for c in anchors):
            continue  # conflicting split factor: leave this task bulk
        for c in anchors:
            split[c] = p
        decomposed[t.task_id] = need

    if not decomposed:
        return demand

    def last(c: str) -> str:
        return f"{c}#{split[c] - 1}" if c in split else c

    def first(c: str) -> str:
        return f"{c}#0" if c in split else c

    out = CommDemand(job_id=demand.job_id)
    for c in demand.compute_tasks:
        p = split.get(c.task_id)
        if p is None:
            out.compute_tasks.append(c)
        else:
            out.compute_tasks.extend(
                dataclasses.replace(c, task_id=f"{c.task_id}#{k}",
                                    flops=c.flops / p,
                                    duration=c.duration / p)
                for k in range(p))

    for t in demand.comm_tasks:
        if t.task_id not in decomposed:
            out.comm_tasks.append(dataclasses.replace(
                t, after_compute=tuple(last(c) for c in t.after_compute),
                before_compute=first(t.before_compute)
                if t.before_compute else None))
            continue
        a, b = decomposed[t.task_id]
        p = len(t.group)
        chunk = max(1, t.size_bytes // p)
        # size_bytes convention: all_reduce carries the per-participant
        # payload, AG/RS the total — either way the ring step moves n/p
        if a is not None:   # reduce-scatter half, under the producer
            for k in range(1, p):
                out.comm_tasks.append(dataclasses.replace(
                    t, task_id=f"{t.task_id}.rs{k}", primitive="permute",
                    size_bytes=chunk, after_compute=(f"{a}#{k - 1}",),
                    before_compute=(first(b) if b is not None else
                                    first(t.before_compute)
                                    if t.before_compute else None)
                    if k == p - 1 else None))
        if b is not None:   # all-gather half, under the consumer
            for k in range(1, p):
                if k == 1:
                    after = (f"{a}#{p - 1}",) if a is not None else \
                        tuple(last(c) for c in t.after_compute)
                else:
                    after = (f"{b}#{k - 2}",)
                out.comm_tasks.append(dataclasses.replace(
                    t, task_id=f"{t.task_id}.ag{k}", primitive="permute",
                    size_bytes=chunk, after_compute=after,
                    before_compute=f"{b}#{k}"))
    return out


def janus_traffic_ratio(cfg: ModelConfig, shape: ShapeConfig,
                        mesh: MeshConfig) -> dict:
    """Janus [10] data-centric vs expert-centric MoE traffic.

    Expert-centric (classic EP): every MoE layer moves 2x the routed token
    activations through All-to-All, fwd + bwd.
    Data-centric (Janus): moves the EXPERT WEIGHTS to the data instead —
    each device fetches the experts it lacks once per layer (prefetchable,
    and sharable across the DP group via broadcast).
    """
    tokens = shape.global_batch * shape.seq_len
    chips = mesh.num_devices
    d = cfg.d_model
    moe_layers = sum(1 for s in cfg.layer_specs() if s.ffn == "moe")
    mult = 3 if cfg.ffn_act in ("swiglu", "geglu") else 2
    expert_params = mult * d * (cfg.moe_d_ff or cfg.d_ff)

    # per-device, per-layer bytes
    token_bytes = 4 * (tokens / chips) * cfg.top_k * d * 2  # a2a x2, fwd+bwd
    expert_bytes = (cfg.num_experts / chips) * expert_params * 2 \
        * (chips - 1) / chips * 2  # fetch all non-local experts (bf16)

    return {
        "expert_centric_bytes": token_bytes * moe_layers,
        "data_centric_bytes": expert_bytes * moe_layers,
        "ratio": (token_bytes / expert_bytes) if expert_bytes else float("inf"),
    }
