"""One run of a training cell: set-up, the measured window, the trace, and
the comparison with the plain reference that decides ``correct``.

Set-up makes the weights from the seed in the port's layout, builds the
step (``repro_torch.train.step.make_train_step``) and drives it through
its first three steps, on the window's own feed: the steps the reference
follows.  After step 1 it reads each leaf's norm of the first moment (the
first gradient as the optimizer took it, times 1 - beta1); after step 3
each leaf's distance from the weights the seed made.  The window then runs
the same step object on fresh batches until ``seconds`` have passed on the
host clock, and synchronises.  On several ranks the window is a number of
steps that rank 0 fixes before it, from the set-up's steps, so that no
rank waits on another's host within the window.  Each step is timed with CUDA
events; a step's time on several ranks is the slowest rank's.  With
``trace`` a few steady steps in the middle of the window run under
``torch.profiler``, and the metrics that need no profiler read the steps
outside them.

Once the window has closed and the peak memory is read, the program's
state is freed and rank 0 runs the reference over the same three batches
from the same seed (``chipbench/reference``).
"""
from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from cb import data, guard, trace as tr, weights as wt
from cb.spec import Cell, load_metric, load_reference, model_fields

REF_STEPS = 3
PROFILE_STEPS = 3  # steady steps under the profiler, mid-window
MIN_LEAF_GRAD = 1e-3  # of the median leaf's reference gradient norm

DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32",
               torch.float16: "float16"}


# --------------------------------------------------------------------------
# faults planted in the program (the tests' check that ``correct`` fails)
# --------------------------------------------------------------------------


def plant(fault: Optional[str]) -> Callable[[], None]:
    """Breaks the program's step in this process: ``unchanged`` (the step
    returns its state as it got it), ``half_batch`` (half of the batch left
    out of the loss, the mean over the rest), ``no_exchange`` (the
    gradient's reduce-scatter and all-reduce return this rank's own),
    ``altered`` (the loss scaled by 1.05 where it is produced).  Returns
    the function that mends it."""
    if fault is None:
        return lambda: None
    from repro_torch.optim import adamw as opt
    from repro_torch.parallel import planner
    from repro_torch.train import step as st
    saved = [(st, "adamw_update", st.adamw_update),
             (st, "adamw_shard_update", st.adamw_shard_update),
             (st, "cross_entropy", st.cross_entropy),
             (planner.FlatLayout, "reduce_scatter",
              planner.FlatLayout.reduce_scatter),
             (planner.FlatLayout, "all_reduce", planner.FlatLayout.all_reduce)]

    def mend():
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    if fault == "unchanged":
        def same(params, grads, state, tcfg, lr, ctx=None, split=None,
                 data_split=None):
            return params, state, {"grad_norm": opt.global_norm(grads)}

        def same_shard(p_shard, g_shard, state, tcfg, lr, ctx,
                       split_ranges=()):
            return p_shard, state, {"grad_norm": opt.global_norm(
                [g_shard], ctx=ctx, sharded=True)}
        st.adamw_update, st.adamw_shard_update = same, same_shard
    elif fault in ("half_batch", "altered"):
        ce = st.cross_entropy

        def broken(logits, labels, ignore_index=-1, count=None, ctx=None):
            if fault == "altered":
                return 1.05 * ce(logits, labels, ignore_index, count, ctx)
            kept = labels.clone()
            if kept.shape[0] > 1:
                kept[kept.shape[0] // 2:] = -1
            else:
                kept[:, kept.shape[1] // 2:] = -1
            n = (kept != -1).sum().clamp(min=1).float()
            if count is not None:  # the global count, as kept
                n = n * count / (labels != -1).sum().clamp(min=1).float()
            return ce(logits, kept, ignore_index, n, ctx)
        st.cross_entropy = broken
    elif fault == "no_exchange":
        planner.FlatLayout.reduce_scatter = \
            lambda self, flat, group: self.shard(flat)
        planner.FlatLayout.all_reduce = \
            lambda self, flat, impl, group: flat
    else:
        raise ValueError(f"unknown fault {fault!r}")
    return mend


# --------------------------------------------------------------------------
# readings of the program's state
# --------------------------------------------------------------------------


def _sq_sums(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sum(t^2) of each tensor in f64 (in blocks: a cast copies)."""
    out = []
    for t in tensors:
        flat = t.reshape(-1)
        out.append(sum(flat[lo:lo + (1 << 26)].double().square().sum()
                       for lo in range(0, flat.numel(), 1 << 26)))
    return torch.stack(out)


def _shard_sq_sums(m: torch.Tensor, layout) -> torch.Tensor:
    """Per leaf, sum(m^2) over this rank's ZeRO-1 shard ``m`` of
    ``layout`` (``repro_torch.parallel.FlatLayout``)."""
    offsets = np.cumsum([0] + [math.prod(s) for s in layout.shapes])
    out = torch.zeros(len(layout.shapes), dtype=torch.float64,
                      device=m.device)
    at = 0
    for lo, hi in layout.buckets:
        c = layout.chunk(lo, hi)
        s0 = lo + layout.rank * c
        s1 = min(s0 + c, hi)
        first = int(np.searchsorted(offsets, s0, side="right")) - 1
        for i in range(max(first, 0), len(layout.shapes)):
            a, b = max(int(offsets[i]), s0), min(int(offsets[i + 1]), s1)
            if a >= s1:
                break
            if a < b:
                out[i] += m[at + a - s0:at + b - s0].double().square().sum()
        at += c
    return out


# --------------------------------------------------------------------------
# the run of one rank
# --------------------------------------------------------------------------


def rank_run(rank: int, world: int, cell: Cell, seed: int,
             seconds: Optional[float], trace: bool, device: str = "cuda",
             fault: Optional[str] = None) -> dict:
    """One rank's run; ``seconds`` None: the set-up's steps and the
    reference alone, no window (the readings that limits are set from).
    ``fault``: one of ``plant``'s, planted for this run."""
    mend = plant(fault)
    try:
        return _rank_run(rank, world, cell, seed, seconds, trace, device)
    finally:
        mend()


def _rank_run(rank, world, cell, seed, seconds, trace, device):
    import torch.distributed as dist
    from repro_torch.ccl import primitives as prim
    from repro_torch.core.tree import param_leaves
    from repro_torch.core.types import MeshConfig, ModelConfig, TrainConfig
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.parallel.planner import flat_layout, make_ctx
    from repro_torch.train.step import make_train_step

    multi = world > 1
    if multi:
        from repro_torch.launch.ranks import rank_device
        dev = rank_device(device)
        flags = dist.new_group(backend="gloo")
    else:
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", 0)
            torch.cuda.set_device(dev)
        flags = None
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    cfg = ModelConfig(**model_fields(cell.config))
    tcfg = TrainConfig(**cell.traffic["train"])
    ctx = make_ctx(None, MeshConfig(shape=(world, 1)), cfg=cfg,
                   remat=tcfg.remat) if multi else None
    zero1 = multi and tcfg.zero1
    dtype = wt.DTYPES[cell.config["param_dtype"]]
    meta = init_params(cfg, torch.Generator(), dtype=dtype, device="meta")
    leaves = wt.table([(p, t.shape, DTYPE_NAMES[t.dtype])
                       for p, t in wt.tree_paths(meta)],
                      cell.config["init"])
    params = wt.fill_tree(meta, wt.make(seed, leaves, dev))
    del meta
    opt = init_opt_state(params, ctx if zero1 else None)
    step = make_train_step(cfg, tcfg, ctx)
    feed = data.BigramFeed(cfg.vocab_size, cell.seq_len, cell.batch, seed,
                           dev)

    # the three steps the reference follows (and the warm-up)
    got = {"loss": []}
    times = []
    for i in range(REF_STEPS):
        sync()
        t = time.perf_counter()
        params, opt, m = step(params, opt, feed.batch(i))
        got["loss"].append(m["loss"])
        if i == 0:
            got["grad_norm"] = m["grad_norm"]
            if zero1:
                lay = flat_layout(list(param_leaves(params)), ctx)
                m_sq = _shard_sq_sums(opt["m"], lay)
                dist.all_reduce(m_sq)
            else:
                m_sq = _sq_sums(list(param_leaves(opt["m"])))
        sync()
        times.append(time.perf_counter() - t)
    cur = dict(wt.tree_paths(params))
    upd_sq = wt.diff_sq(seed, leaves, cur)
    del cur
    b1 = tcfg.beta1
    prog = {"loss": [float(x) for x in got["loss"]],
            "grad_norm": float(got["grad_norm"]),
            "grad_leaf": [math.sqrt(float(x)) / (1 - b1) for x in m_sq],
            "update_leaf": [math.sqrt(float(x)) for x in upd_sq]}
    del got, m_sq, upd_sq, m
    est = max(statistics.mean(times[1:]), 1e-3)

    out = {"rank": rank, "program": prog, "failed": 0, "setup_peak": 0,
           "window_peak": 0,
           "device_name": torch.cuda.get_device_name(dev) if on_card
           else "cpu"}
    m = None
    if seconds is not None:  # (None: the readings alone, no window)
        # the window
        n_prof = PROFILE_STEPS if trace else 0
        prof_at = max(1, int(seconds / est / 2) - n_prof // 2) \
            if trace else -1
        n_fixed = None  # on several ranks: the window's steps
        if multi:
            box = [prof_at, max(math.ceil(seconds / est),
                                prof_at + n_prof + 1 if trace else 1)]
            dist.broadcast_object_list(box, 0, group=flags)
            prof_at, n_fixed = box
            dist.barrier(group=flags)
        sync()
        setup_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        sent0 = prim._permute.sent_bytes
        events, losses = [], []
        prof = None
        t_a = t_b = None
        sent_a = sent_b = sent0
        t_start = time.perf_counter()
        wall_start = time.time()
        i = 0
        while True:
            if i == prof_at:
                sync()
                t_a, sent_a = time.perf_counter(), prim._permute.sent_bytes
                prof = tr.profiler()
                prof.__enter__()
                t_a1 = time.perf_counter()
            if on_card:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
            else:
                h0 = time.perf_counter()
            params, opt, m = step(params, opt, feed.batch(REF_STEPS + i))
            if on_card:
                e1.record()
                events.append((e0, e1))
            else:
                events.append(time.perf_counter() - h0)
            losses.append(m["loss"])
            i += 1
            if prof is not None and i == prof_at + n_prof:
                sync()
                t_b0 = time.perf_counter()
                prof.__exit__(None, None, None)
                t_b, sent_b = time.perf_counter(), prim._permute.sent_bytes
            done = i >= n_fixed if multi else \
                time.perf_counter() - t_start >= seconds
            if done and (prof is None or t_b is not None) \
                    and (not trace or prof is not None):
                break
        sync()
        t_end = time.perf_counter()
        sent_end = prim._permute.sent_bytes
        window_s = t_end - t_start
        step_ms = [a.elapsed_time(b) for a, b in events] if on_card \
            else [1e3 * x for x in events]
        losses = torch.stack(losses).float().cpu().numpy()
        window_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        steps = i
        if trace:
            pre, post = prof_at, steps - prof_at - n_prof
            free_s = (t_a - t_start) + (t_end - t_b)
            free_sent = (sent_a - sent0) + (sent_end - sent_b)
            # the traced span leaves out the profiler's own start and stop
            summary = tr.summarize(prof, n_prof, 1e6 * (t_b0 - t_a1))
            del prof
        else:
            pre, post, free_s, free_sent, summary = steps, 0, window_s, \
                sent_end - sent0, None
        out.update({"steps": steps, "window_s": window_s,
                    "wall_start": wall_start, "step_ms": step_ms,
                    "failed": int((~np.isfinite(losses)).sum()),
                    "setup_peak": setup_peak, "window_peak": window_peak,
                    "free_steps": pre + post, "free_s": free_s,
                    "sent_per_step": free_sent / max(pre + post, 1),
                    "trace": summary})

    # every rank's parameters the same bits as rank 0's
    if multi:
        mismatch = torch.zeros(1, dtype=torch.int64, device=dev)
        with torch.no_grad():
            for p in param_leaves(params):
                flat = p.reshape(-1)
                for lo in range(0, flat.numel(), 1 << 26):
                    mine = flat[lo:lo + (1 << 26)]
                    theirs = mine.clone()
                    dist.broadcast(theirs, 0)
                    mismatch += (mine.view(torch.int16 if mine.element_size()
                                           == 2 else torch.int32)
                                 != theirs.view(torch.int16
                                                if mine.element_size() == 2
                                                else torch.int32)).sum()
        dist.all_reduce(mismatch)
        out["rank_mismatch"] = int(mismatch)
    del params, opt, step, m, feed
    gc.collect()
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    out["modules"] = guard.forbidden_modules()

    # the reference, on rank 0
    if rank == 0:
        ref_mod = load_reference(cell.config)
        w = wt.make(seed, leaves, dev)
        ref_feed = data.BigramFeed(cfg.vocab_size, cell.seq_len, cell.batch,
                                   seed, dev)
        batches = [ref_feed.batch(i) for i in range(REF_STEPS)]
        t = time.perf_counter()
        out["reference"] = ref_mod.train_steps(
            w, cell.config, cell.traffic["train"], batches,
            lambda cur: wt.diff_sq(seed, leaves, cur))
        out["reference_s"] = time.perf_counter() - t
        del w, batches, ref_feed
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    if multi:
        dist.barrier(group=flags)
    return out


def rank_entry(rank: int, world: int, *args) -> dict:
    """``launch.ranks.spawn_ranks``' entry: the run of one rank."""
    return rank_run(rank, world, *args)


# --------------------------------------------------------------------------
# the comparison
# --------------------------------------------------------------------------


def _gap_by_leaf(got: Sequence[float], want: Sequence[float],
                 keep: Sequence[bool]) -> float:
    """The largest |got - want| over max(want, the median leaf's want),
    over the kept leaves."""
    kept = [w for w, k in zip(want, keep) if k]
    med = statistics.median(kept)
    return max(abs(g - w) / max(w, med, 1e-30)
               for g, w, k in zip(got, want, keep) if k)


def readings(prog: dict, ref: dict, mismatch: Optional[int] = None
             ) -> Dict[str, float]:
    """The numbers that decide ``correct``: the relative gap of the first
    step's loss (the later steps' swing from seed to seed: a row whose
    stretch of the bigram cycle overlaps an earlier row's has its loss
    lowered by what the earlier updates memorised, and the gap with it);
    the gap of the first step's global gradient norm before clipping; by
    the worst leaf, the gap of the first gradient's norm as the optimizer
    took it (clipped) and of the parameters' change over the three steps,
    the latter over the leaves whose reference gradient is at least
    ``MIN_LEAF_GRAD`` of the median leaf's (the others move by round-off
    alone); with several ranks, the values whose bits differ from rank
    0's."""
    raw = ref["grad_raw_leaf"]
    med = statistics.median(raw)
    moved = [r >= MIN_LEAF_GRAD * med for r in raw]
    out = {"loss_gap": abs(prog["loss"][0] - ref["loss"][0])
           / abs(ref["loss"][0]),
           "grad_norm_gap": abs(prog["grad_norm"] - ref["grad_norm"])
           / ref["grad_norm"],
           "grad_leaf_gap": _gap_by_leaf(prog["grad_leaf"], ref["grad_leaf"],
                                         [True] * len(raw)),
           "update_leaf_gap": _gap_by_leaf(prog["update_leaf"],
                                           ref["update_leaf"], moved)}
    if mismatch is not None:
        out["rank_mismatch"] = float(mismatch)
    return out


def loss_steps_gap(prog: dict, ref: dict) -> float:
    """The largest relative gap of the three steps' losses (recorded, not
    compared: see ``readings``)."""
    return max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                    ref["loss"]))


# --------------------------------------------------------------------------
# the run of a cell
# --------------------------------------------------------------------------


class Run:
    """What the per-layer metric readers read."""

    def __init__(self, cell: Cell, ranks: List[dict], trace: bool):
        self.cell = cell
        self.ranks = ranks
        self.traces = [r["trace"] for r in ranks if r["trace"]] \
            if trace else []
        r0 = ranks[0]
        self.steps = r0["steps"]
        self.window_s = max(r["window_s"] for r in ranks)
        self.step_ms = [max(r["step_ms"][i] for r in ranks)
                        for i in range(self.steps)]
        self.chips = len(ranks)
        self.rows_per_rank = cell.batch // cell.dp
        self.window_peak = max(r["window_peak"] for r in ranks)
        self.free_steps = r0["free_steps"]
        self.free_s = max(r["free_s"] for r in ranks)
        self.sent_per_step = statistics.mean(r["sent_per_step"]
                                             for r in ranks)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t0: float,
             device: str = "cuda", fault: Optional[str] = None) -> dict:
    """Runs the cell on its ranks (in this process where it has one) and
    returns the result line's object, and ``modules``: the forbidden
    modules found in any rank."""
    world = cell.dp
    args = (cell, seed, seconds, trace, device, fault)
    if world == 1:
        ranks = [rank_run(0, 1, *args)]
    else:
        from repro_torch.launch.ranks import build_kernels, spawn_ranks
        if device == "cuda":
            build_kernels()
        backend = "nccl" if device == "cuda" else "gloo"
        ranks = spawn_ranks(rank_entry, world, *args, backend=backend,
                            timeout_s=340.0)
    return result(cell, ranks, trace, t0)


def result(cell: Cell, ranks: List[dict], trace: bool, t0: float) -> dict:
    run = Run(cell, ranks, trace)
    r0 = ranks[0]
    tokens = cell.batch * cell.seq_len
    metrics = {}
    if not trace:
        vals = {"tokens_per_s": run.steps * tokens / run.window_s,
                "step_ms_p90": float(np.percentile(run.step_ms, 90)),
                "setup_s": max(r["wall_start"] for r in ranks) - t0}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": vals[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = load_metric(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    # a reading without a limit in the cell's file is printed, not compared
    readout = readings(r0["program"], r0["reference"],
                       r0.get("rank_mismatch"))
    limits = cell.limits
    checks = {k: v for k, v in readout.items() if k in limits}
    correct = all(checks[k] <= limits[k] for k in checks) and \
        all(r["failed"] == 0 for r in ranks)
    device = {"platform": "gpu" if r0["device_name"] != "cpu" else "cpu",
              "kind": r0["device_name"], "count": len(ranks),
              "memory_peak_bytes": max(max(r["setup_peak"], r["window_peak"])
                                       for r in ranks)}
    line = {"correct": bool(correct), "attempted": run.steps,
            "failed": sum(r["failed"] for r in ranks), "metrics": metrics,
            "device": device}
    if trace:
        busy = statistics.mean(t["busy_us"] for t in run.traces) / 1e6
        device["busy_s"] = busy
        device["window_s"] = statistics.mean(t["window_us"]
                                             for t in run.traces) / 1e6
        t = run.traces[0]
        line["breakdown"] = {
            "device_ops": [[k, v[1] / 1e6] for k, v in sorted(
                t["kernels"].items(), key=lambda kv: -kv[1][1])[:10]],
            "idle_gaps": [[k, v / 1e6] for k, v in tr.top(t["gaps"])]}
    line["checks"] = {k: {"value": v, "limit": limits[k]}
                      for k, v in checks.items()}
    return {"line": line, "modules": sorted({m for r in ranks
                                             for m in r["modules"]}),
            "reference_s": r0.get("reference_s"),
            "not_compared": dict(
                {k: v for k, v in readout.items() if k not in limits},
                loss_steps_gap=loss_steps_gap(r0["program"],
                                              r0["reference"])),
            "ranks": ranks}
