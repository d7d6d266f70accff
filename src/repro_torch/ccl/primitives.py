"""Executable collective primitives on ``torch.distributed`` point-to-point.

Port of ``repro.ccl.primitives``: the same ring algorithms and the same
move-list interpreter for synthesized schedules, run by every rank of a
process group instead of inside a ``shard_map``.  Where the JAX package
takes ``(axis_name, axis_size)``, these take a process group (``None`` for
the default one): rank and world size come from it.  Each ``lax.ppermute``
of the JAX package becomes one ``dist.batch_isend_irecv`` in which a rank
posts only the sends and receives of the pairs it belongs to; a rank that
receives nothing keeps its buffer (JAX's zeros there are masked out).  The
chunk-index algebra is the JAX package's, hop for hop, and each hop adds
in its order (``received + local`` in the rings, ``current + received`` in
the interpreter), so the lossless results agree with JAX's bit for bit.
The quantizing ones compute the reference's arithmetic (``quantize_ref``:
scale = absmax / qmax, a true division); under ``jit`` XLA multiplies by
1/qmax instead, so they agree with JAX's jitted results to the last bits.

The quantizing variants (``ring_q8``, ``ring_q4``, ``synthesized_collective
(bits=...)``) encode and decode every hop through
``repro_torch.kernels.compress.ops.wire_codec``: the K2a/K2b kernels on a
CUDA tensor, their plain versions on a CPU one.

Transport.  Gloo's point-to-point path moves host memory.  Where the
group's backend is gloo and the payload lies on the card, ``_permute``
copies the wire payload (the int8 or nibble-packed q and its f32 scale, or
the raw chunk when lossless) to the host before the send and back to the
card after the receive.  ``_permute`` counts the bytes this process put
on the wire (``sent_bytes``), the bytes it copied (``staged_bytes``) and
the seconds its exchanges took, copies included (``seconds``).
This copy is the transport of a gloo group, not a fallback: with NCCL the
tensors go as they are.

``all_to_all`` (with ``AllToAll``, its autograd form) is the MoE dispatch
of expert parallelism (``repro_torch.models.moe``), built from the same
permutes.
"""
from __future__ import annotations

import functools
import time
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.kernels.compress.ops import wire_codec


def _peer(group, r: int) -> int:
    """Global rank of group rank ``r`` (P2POp addresses global ranks)."""
    return r if group is None else dist.get_global_rank(group, r)


def _permute(tensors: Sequence[torch.Tensor], perm, group
             ) -> Optional[List[torch.Tensor]]:
    """One ``lax.ppermute`` over ``perm`` (pairs of group ranks, each rank
    at most once as source and once as destination): send ``tensors`` to
    this rank's destination, receive tensors of the same shapes from its
    source.  Returns the received tensors, or ``None`` where this rank
    receives nothing."""
    me = dist.get_rank(group)
    dst = next((d for s, d in perm if s == me), None)
    src = next((s for s, d in perm if d == me), None)
    if dst is None and src is None:
        return None
    device = tensors[0].device
    stage = device.type == "cuda" and dist.get_backend(group) == "gloo"
    if stage:  # the payload is ready: what follows is transport
        torch.cuda.current_stream(device).synchronize()
    t0 = time.perf_counter()
    wire = [t.contiguous() for t in tensors]
    if stage:
        wire = [t.cpu() for t in wire]
    ops = []
    if dst is not None:
        ops += [dist.P2POp(dist.isend, t, _peer(group, dst), group, tag=i)
                for i, t in enumerate(wire)]
    recv = [torch.empty_like(t) for t in wire] if src is not None else None
    if recv is not None:
        ops += [dist.P2POp(dist.irecv, t, _peer(group, src), group, tag=i)
                for i, t in enumerate(recv)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if dst is not None:
        _permute.sent_bytes += sum(t.numel() * t.element_size() for t in wire)
    if stage:
        moved = (wire if dst is not None else []) + (recv or [])
        _permute.staged_bytes += sum(t.numel() * t.element_size()
                                     for t in moved)
        if recv is not None:
            recv = [t.to(device) for t in recv]
    _permute.seconds += time.perf_counter() - t0
    return recv


# bytes this process sent, bytes copied between card and host for gloo, and
# seconds spent in the exchanges (the copies included)
_permute.sent_bytes = 0
_permute.staged_bytes = 0
_permute.seconds = 0.0


def _rank_size(group):
    return dist.get_rank(group), dist.get_world_size(group)


def _pad_to(x: torch.Tensor, p: int):
    flat = x.reshape(-1)
    n = flat.numel()
    pad = (-n) % p
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, n, pad


def _ring(p: int, step: int):
    return [(i, (i + step) % p) for i in range(p)]


def ring_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Ring All-Reduce: (p-1) reduce-scatter + (p-1) all-gather hops.
    Per-rank wire bytes: 2 n (p-1)/p, bandwidth-optimal."""
    idx, p = _rank_size(group)
    if p == 1 or x.numel() == 0:
        return x
    flat, n, _ = _pad_to(x, p)
    chunks = flat.reshape(p, -1)
    right = _ring(p, 1)

    # ---- reduce-scatter ----
    buf = chunks[idx]
    for s in range(p - 1):
        buf = _permute([buf], right, group)[0] + chunks[(idx - s - 1) % p]
    # buf = fully-reduced chunk (idx + 1) % p

    # ---- all-gather ----
    out = torch.zeros_like(chunks)
    out[(idx + 1) % p] = buf
    g = buf
    for s in range(p - 1):
        g = _permute([g], right, group)[0]
        out[(idx - s) % p] = g
    return out.reshape(-1)[:n].reshape(x.shape)


def bidir_ring_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Two opposite half-rings (NCCL dual-channel): halves the per-link
    bytes, using both directions of a link."""
    _, p = _rank_size(group)
    if p == 1:
        return x
    flat = x.reshape(-1)
    half = flat.numel() // 2
    a = ring_all_reduce(flat[:half], group)
    b = _ring_all_reduce_left(flat[half:], group)
    return torch.cat([a, b]).reshape(x.shape)


def _ring_all_reduce_left(x: torch.Tensor, group) -> torch.Tensor:
    idx, p = _rank_size(group)
    if x.numel() == 0:
        return x
    flat, n, _ = _pad_to(x, p)
    chunks = flat.reshape(p, -1)
    left = _ring(p, -1)
    buf = chunks[idx]
    for s in range(p - 1):
        buf = _permute([buf], left, group)[0] + chunks[(idx + s + 1) % p]
    out = torch.zeros_like(chunks)
    out[(idx - 1) % p] = buf
    g = buf
    for s in range(p - 1):
        g = _permute([g], left, group)[0]
        out[(idx + s) % p] = g
    return out.reshape(-1)[:n].reshape(x.shape)


def ring_all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-Gather via p-1 neighbour passes; result stacked on a new axis 0."""
    idx, p = _rank_size(group)
    out = torch.zeros((p, *x.shape), dtype=x.dtype, device=x.device)
    out[idx] = x
    right = _ring(p, 1)
    g = x
    for s in range(p - 1):
        g = _permute([g], right, group)[0]
        out[(idx - s - 1) % p] = g
    return out


def ring_reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """x: (p, ...) per-peer chunks; returns this rank's OWN reduced chunk
    (rank i ends holding sum_j x_j[i])."""
    idx, p = _rank_size(group)
    if p == 1:
        return x[0]
    right = _ring(p, 1)
    # chunk index decrements by one per hop; to finish at chunk ``idx``
    # after p-1 hops, start at chunk idx-1 and add chunk idx-2-s per step.
    buf = x[(idx - 1) % p]
    for s in range(p - 1):
        buf = _permute([buf], right, group)[0] + x[(idx - 2 - s) % p]
    return buf


def compressed_ring_all_reduce(x: torch.Tensor, group=None,
                               bits: int = 8) -> torch.Tensor:
    """Quantized ring All-Reduce (the executable face of the ``ring+q8`` /
    ``ring+q4`` selection candidates): every reduce-scatter hop quantizes
    its chunk to ``bits`` (uniform symmetric, per-chunk f32 scale), sends
    the int8 payload + scale, and dequant-accumulates; the all-gather
    phase encodes the reduced chunk once and forwards the compressed
    payload hop to hop.

    Wire bytes drop to ~``bits/32`` of the f32 ring (plus one scale per
    chunk per hop); ``bits=4`` payloads are nibble-packed.  Each of the
    ``p-1`` accumulation hops re-quantizes the partial sum, so the result
    matches the exact sum within ~``p * absmax / (2^(bits-1) - 1)`` per
    element."""
    idx, p = _rank_size(group)
    if p == 1 or x.numel() == 0:
        return x
    flat, n, _ = _pad_to(x, p)
    chunks = flat.reshape(p, -1).to(torch.float32)
    clen = chunks.shape[1]
    right = _ring(p, 1)
    encode, decode = wire_codec(bits, clen)

    def send(v):
        q, scale = _permute(encode(v), right, group)
        return decode(q, scale)

    # ---- reduce-scatter: dequant-accumulate each hop ----
    buf = chunks[idx]
    for s in range(p - 1):
        buf = send(buf) + chunks[(idx - s - 1) % p]

    # ---- all-gather: encode once, forward the compressed payload ----
    q, scale = encode(buf)
    out = torch.zeros_like(chunks)
    out[(idx + 1) % p] = decode(q, scale)
    for s in range(p - 1):
        q, scale = _permute([q, scale], right, group)
        out[(idx - s) % p] = decode(q, scale)
    return out.reshape(-1)[:n].reshape(x.shape).to(x.dtype)


def latency_bound_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Recursive doubling: log2(p) exchanges of the FULL payload.
    Latency-optimal for tiny payloads."""
    _, p = _rank_size(group)
    if p & (p - 1):
        raise ValueError(f"recursive doubling needs a power-of-two group, "
                         f"got {p}")
    acc = x
    dist_ = 1
    while dist_ < p:
        perm = [(i, i ^ dist_) for i in range(p)]
        acc = acc + _permute([acc], perm, group)[0]
        dist_ *= 2
    return acc


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis=0, concat_axis=0,
    tiled=False)``: x is (p, ...), chunk i goes to rank i, and chunk j of
    the result is the one rank j sent here.  p - 1 shifted permutes (hop s
    sends chunk me + s to rank me + s), so its bytes and seconds land in
    ``_permute``'s counters: (p - 1)/p of x on the wire a rank."""
    idx, p = _rank_size(group)
    if x.shape[0] != p:
        raise ValueError(f"all_to_all over {p} ranks needs a leading dim of "
                         f"{p}, got {tuple(x.shape)}")
    out = torch.empty_like(x)
    out[idx] = x[idx]
    for s in range(1, p):
        out[(idx - s) % p] = _permute([x[(idx + s) % p]], _ring(p, s),
                                      group)[0]
    return out


class AllToAll(torch.autograd.Function):
    """``all_to_all`` under autograd: its transpose is itself (the
    cotangent of chunk j of the result goes back to rank j as chunk me)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return all_to_all(grad.contiguous(), ctx.group), None


def torus2d_all_reduce(x: torch.Tensor, row_group, col_group
                       ) -> torch.Tensor:
    """Dimension-ordered 2D-torus All-Reduce: ring AR within ``row_group``
    (the mesh's first axis), then within ``col_group`` (its second);
    ``repro_torch.launch.ranks.torus_groups`` builds both."""
    x = ring_all_reduce(x, row_group)
    return ring_all_reduce(x, col_group)


# ---------------------------------------------------------------------------
# Synthesized schedules: generic move-list interpreter
# ---------------------------------------------------------------------------


def _schedule_program(schedule) -> list:
    """Compile a ``SynthSchedule`` move list into permutation sub-batches.

    One permutation is partial — every rank sends at most one payload and
    receives at most one — so each synthesis step (whose moves may fan
    several arrivals into one rank on disjoint links) is split first-fit
    into sub-batches with each rank appearing at most once as source and
    once as destination.  First-fit preserves emission order for a
    repeated destination, which is exactly the accumulation order the
    replay semantics define.  Reading the *current* buffer inside a step
    rests on the synthesizer's wave invariant: a chunk delivered at step
    ``s`` is never forwarded before step ``s+1``.

    Returns a list of ``(perm, send_chunk, recv_chunk, recv_mask,
    reduce_mask)`` tuples over *group-rank* indices (the position of each
    device in ``schedule.group``)."""
    rank = {dev: i for i, dev in enumerate(schedule.group)}
    p = len(schedule.group)
    by_step: dict = {}
    for m in schedule.moves:
        by_step.setdefault(m.step, []).append(m)
    program = []
    for step in sorted(by_step):
        batches: list = []
        for m in by_step[step]:
            s, d = rank[m.src], rank[m.dst]
            for b in batches:
                if s not in b["srcs"] and d not in b["dsts"]:
                    break
            else:
                b = {"moves": [], "srcs": set(), "dsts": set()}
                batches.append(b)
            b["moves"].append((s, d, m.chunk, m.reduce))
            b["srcs"].add(s)
            b["dsts"].add(d)
        for b in batches:
            send_chunk = [0] * p
            recv_chunk = [0] * p
            recv_mask = [False] * p
            reduce_mask = [False] * p
            perm = []
            for s, d, chunk, red in b["moves"]:
                perm.append((s, d))
                send_chunk[s] = chunk
                recv_chunk[d] = chunk
                recv_mask[d] = True
                reduce_mask[d] = red
            program.append((perm, send_chunk, recv_chunk, recv_mask,
                            reduce_mask))
    return program


def synthesized_collective(x: torch.Tensor, schedule, group=None,
                           bits: Optional[int] = None) -> torch.Tensor:
    """Execute a synthesized schedule: one exchange per compiled sub-batch,
    a ``num_chunks``-slot buffer per rank, reduce moves accumulating and
    gather moves overwriting.

    ``bits`` enables the quantize-in-the-send-loop codec (the executable
    face of the ``synthesized+q8`` / ``+q4`` candidates, sharing
    ``wire_codec`` with the compressed ring): each sub-batch's payload is
    quantized by its sender and dequantized by its receiver, so reduce
    hops re-quantize partial sums.

    Supported primitives: ``all_reduce`` (rank ``i``'s input split into
    ``num_chunks`` equal slices), ``broadcast`` (every rank returns the
    root's payload) and ``all_gather`` (returns the ``(p, ...)`` stack)."""
    idx, p = _rank_size(group)
    if len(schedule.group) != p:
        raise ValueError(
            f"schedule group size {len(schedule.group)} != process group "
            f"size {p}")
    program = _schedule_program(schedule)
    nc = schedule.num_chunks
    if schedule.primitive in ("all_reduce", "broadcast"):
        flat, n, _ = _pad_to(x, nc)
        buf = flat.reshape(nc, -1).to(torch.float32).clone()
    elif schedule.primitive == "all_gather":
        buf = torch.zeros((nc, x.numel()), dtype=torch.float32,
                          device=x.device)
        buf[idx] = x.reshape(-1).to(torch.float32)
        n = x.numel()
    else:
        raise KeyError(
            f"no executable lowering for synthesized {schedule.primitive}")
    clen = buf.shape[1]
    if bits:
        encode, decode = wire_codec(bits, clen)
    for perm, send_chunk, recv_chunk, recv_mask, reduce_mask in program:
        if not any(idx in pair for pair in perm):
            continue
        payload = buf[send_chunk[idx]]
        sends = any(s == idx for s, _ in perm)
        if bits:
            # the encode is only for the wire; a rank that only receives
            # sends nothing and passes a template of the payload's shapes
            wire = encode(payload) if sends else _wire_template(bits, clen,
                                                                buf.device)
            got = _permute(wire, perm, group)
            payload = decode(*got) if got is not None else None
        else:
            got = _permute([payload], perm, group)
            payload = got[0] if got is not None else None
        if recv_mask[idx]:
            c = recv_chunk[idx]
            buf[c] = buf[c] + payload if reduce_mask[idx] else payload
    if schedule.primitive == "all_gather":
        return buf.reshape(nc, *x.shape).to(x.dtype)
    return buf.reshape(-1)[:n].reshape(x.shape).to(x.dtype)


def _wire_template(bits: int, clen: int, device) -> List[torch.Tensor]:
    """Empty tensors of the shapes ``wire_codec(bits, clen)`` encodes to."""
    qlen = (clen + 1) // 2 if bits == 4 else clen
    qdtype = torch.uint8 if bits == 4 else torch.int8
    return [torch.empty((qlen,), dtype=qdtype, device=device),
            torch.empty((1,), dtype=torch.float32, device=device)]


def make_synthesized(schedule, group=None, bits: Optional[int] = None
                     ) -> Callable:
    """A synthesized all-reduce/broadcast schedule as a shape-preserving
    function of this rank's tensor (all-gather changes the shape: call
    ``synthesized_collective`` for that)."""
    if schedule.primitive == "all_gather":
        raise KeyError("make_synthesized is shape-preserving; call "
                       "synthesized_collective for all_gather schedules")
    return functools.partial(synthesized_collective, schedule=schedule,
                             group=group, bits=bits)


IMPLEMENTATIONS: dict = {
    "ring": ring_all_reduce,
    "bidir_ring": bidir_ring_all_reduce,
    "recursive_doubling": latency_bound_all_reduce,
    "ring_q8": functools.partial(compressed_ring_all_reduce, bits=8),
    "ring_q4": functools.partial(compressed_ring_all_reduce, bits=4),
}

# executable implementation -> the algorithm name the cost models price
# it as (``ccl.cost.algo_cost`` / the selection registry of the planner)
MODEL_EQUIVALENTS: dict = {
    "ring": "ring",
    "bidir_ring": "bidir_ring",
    "recursive_doubling": "halving_doubling",
    "ring_q8": "ring+q8",
    "ring_q4": "ring+q4",
}


def make_all_reduce(impl: str, group=None) -> Callable:
    """An implementation of ``IMPLEMENTATIONS`` as a function of this
    rank's tensor over ``group``."""
    return functools.partial(IMPLEMENTATIONS[impl], group=group)
