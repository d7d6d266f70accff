"""Alpha-beta cost models for collective algorithms.

cost = num_steps * alpha + wire_bytes_on_critical_path / beta_effective.

These closed forms are the classical ones (Thakur et al.; NCCL docs) and
are validated in tests against the flow-schedule generators in
``repro_torch.ccl.algorithms`` (the per-step max-link bytes of the generated
schedule must equal the closed form's bandwidth term).

The port's copy of ``repro.ccl.cost``, kept line for line: importing any
``repro`` module runs the JAX package's ``__init__``, which imports jax, so
the port keeps its own.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class CostParams:
    alpha: float = 5e-6          # per-step latency (s)
    link_bw: float = 50e9        # bytes/s per link (intra-host when hierarchical)
    reduce_flops_bw: float = 0.0  # 0 = ignore reduction compute
    # hierarchy (the "Intra-Inter" setting): 0 = flat single-tier fabric.
    # When gpus_per_host > 1, link_bw is the intra-host (NVLink) bandwidth
    # and inter_bw the per-host NIC bandwidth, enabling the `hierarchical`
    # all-reduce closed form.
    inter_bw: float = 0.0        # bytes/s across hosts (0 = link_bw)
    gpus_per_host: int = 0       # accelerators per host (0 = no hierarchy)
    # in-network aggregation (ATP): max group size a programmable switch can
    # aggregate concurrently; None = unlimited, 0 = switch memory exhausted
    # (same convention as sched.atp.aggregation_switches).  Groups beyond it
    # degrade to host PS aggregation (the multi-tenant fallback).
    atp_capacity: Optional[int] = None
    # gradient compression (repro_torch.compress): encode/decode modeled as
    # ``spec.passes`` full-payload memory passes at ``codec_bw`` bytes/s
    # plus a fixed ``codec_alpha`` launch latency per algorithm step — the
    # term that makes compression lose in the latency regime even though
    # it always shrinks the bandwidth term.
    codec_bw: float = 200e9
    codec_alpha: float = 2e-6


def algo_cost(primitive: str, algorithm: str, size_bytes: int, p: int,
              cp: CostParams) -> float:
    """Predicted completion time (seconds) of one collective.

    Compressed candidates (``"<base>+<codec>"``, e.g. ``ring+q8``) are
    priced as: base latency term + base bandwidth term scaled by the
    codec's wire ratio + encode/decode overhead (``codec_bw`` /
    ``codec_alpha``)."""
    n = float(size_bytes)
    a, b = cp.alpha, cp.link_bw
    if p <= 1:
        return 0.0
    if "+" in algorithm:
        import dataclasses

        from repro_torch.compress.codec import base_algorithm, split_algorithm
        from repro_torch.compress.codec import codec_spec

        _, codec_name = split_algorithm(algorithm)
        base = base_algorithm(algorithm)
        spec = codec_spec(codec_name)
        lat = algo_cost(primitive, base, 0, p, cp)
        full = algo_cost(primitive, base, size_bytes, p, cp)
        # step count: every closed form's latency term is linear in alpha
        # (alpha * steps), so lat(alpha=ref)/ref recovers it exactly — also
        # when the caller's alpha is 0, where the per-step codec launch
        # latency must still be charged
        a_ref = a if a > 0 else 1e-6
        lat_ref = lat if a > 0 else algo_cost(
            primitive, base, 0, p, dataclasses.replace(cp, alpha=a_ref))
        steps = lat_ref / a_ref
        return lat + (full - lat) * spec.wire_ratio \
            + steps * cp.codec_alpha + spec.passes * n / cp.codec_bw
    if primitive == "all_reduce":
        if algorithm == "ring":
            return 2 * (p - 1) * a + 2 * (p - 1) / p * n / b
        if algorithm == "bidir_ring":
            return 2 * (p - 1) * a + (p - 1) / p * n / b
        if algorithm == "halving_doubling":
            return 2 * math.log2(p) * a + 2 * (p - 1) / p * n / b
        if algorithm == "tree":
            return 2 * math.ceil(math.log2(p)) * (a + n / b)
        if algorithm == "torus2d":
            # dimension-ordered on a sqrt(p) x sqrt(p) torus: same wire
            # bytes as ring, far fewer latency steps
            r = max(int(math.isqrt(p)), 1)
            c = p // r
            steps = 2 * (r - 1) + 2 * (c - 1)
            return steps * a + 2 * (p - 1) / p * n / b
        if algorithm == "hierarchical":
            # intra-host ring reduce-scatter -> shard relay to the host
            # leader -> ring all-reduce over one leader per host on the NIC
            # tier -> relay back -> intra-host ring all-gather.
            m = cp.gpus_per_host
            if m <= 1 or p <= m or p % m:
                raise KeyError(
                    f"hierarchical all-reduce needs gpus_per_host dividing "
                    f"p with >=2 hosts; got p={p}, gpus_per_host={m}")
            hcount = p // m
            b_inter = cp.inter_bw or b
            intra = 2 * ((m - 1) * a + (m - 1) / m * n / b)     # RS + AG
            relay = 2 * (a + (m - 1) / m * n / b)               # to/from leader
            inter = 2 * (hcount - 1) * a \
                + 2 * (hcount - 1) / hcount * n / b_inter       # leader ring AR
            return intra + relay + inter
        if algorithm == "atp":
            # In-network aggregation (ATP): workers push the full gradient
            # up, programmable switches merge same-task flows, the sum
            # multicasts back — 2 latency steps, each fabric link carrying
            # ~n once.  Needs a switched inter-host tier to aggregate on.
            b_inter = cp.inter_bw
            if not b_inter:
                raise KeyError(
                    "atp all-reduce needs a switched inter-host tier "
                    "(CostParams.inter_bw); flat fabrics have no "
                    "aggregation point")
            if cp.atp_capacity is not None and p > cp.atp_capacity:
                # switch memory exhausted -> host PS aggregation: all p
                # unmerged flows converge on the PS's NIC, both directions
                return 2 * a + 2 * p * n / b_inter
            return 2 * a + 2 * n / b_inter
    if primitive in ("all_gather", "reduce_scatter"):
        # n = TOTAL payload (the gathered size / the pre-reduce size)
        if algorithm == "ring":
            return (p - 1) * a + (p - 1) / p * n / b
    if primitive == "permute":
        # one neighbor-exchange step of a decomposed collective: every
        # participant sends size_bytes to its ring successor concurrently
        if algorithm == "ring":
            return a + n / b
    if primitive == "broadcast":
        if algorithm == "binomial":
            return math.ceil(math.log2(p)) * (a + n / b)
    if primitive == "all_to_all":
        if algorithm == "direct":
            # p-1 simultaneous flows share the NIC: serialized on egress
            return a + (p - 1) / p * n / b
        if algorithm == "ring":
            return (p - 1) * a + (p - 1) / p * n / b
    if primitive == "p2p":
        # single point-to-point transfer (pipeline hand-off, KV-cache shard
        # migration): one latency step, the whole payload on one link
        if algorithm == "direct":
            return a + n / b
    raise KeyError(f"no cost model for {primitive}/{algorithm}")


def cost_terms(primitive: str, algorithm: str, size_bytes: int, p: int,
               cp: CostParams) -> dict:
    """:func:`algo_cost` split into its alpha-beta terms:
    ``{"latency_s", "bandwidth_s", "codec_s", "total_s"}``.

    The latency term is the size-0 cost of the (base) algorithm, the
    bandwidth term what payload adds on the wire, and ``codec_s`` the
    compressed candidates' encode/decode overhead (0 for lossless).
    This is the model-side breakdown the JAX package's ``obs.probe`` puts
    next to measured wall-clock spans, so calibration can see *which* term
    drifts."""
    total = algo_cost(primitive, algorithm, size_bytes, p, cp)
    if p <= 1:
        return {"latency_s": 0.0, "bandwidth_s": 0.0, "codec_s": 0.0,
                "total_s": 0.0}
    if "+" in algorithm:
        from repro_torch.compress.codec import (base_algorithm, codec_spec,
                                                split_algorithm)
        base = base_algorithm(algorithm)
        _, codec_name = split_algorithm(algorithm)
        lat = algo_cost(primitive, base, 0, p, cp)
        full = algo_cost(primitive, base, size_bytes, p, cp)
        bw = (full - lat) * codec_spec(codec_name).wire_ratio
        return {"latency_s": lat, "bandwidth_s": bw,
                "codec_s": total - lat - bw, "total_s": total}
    lat = algo_cost(primitive, algorithm, 0, p, cp)
    return {"latency_s": lat, "bandwidth_s": total - lat, "codec_s": 0.0,
            "total_s": total}
