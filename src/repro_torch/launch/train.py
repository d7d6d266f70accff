"""Training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --devices 4 --steps 5 --batch 8 --seq 512

The JAX launcher's flags, plus ``--device`` (``cuda`` by default; ``cpu``
runs the plain path) and the step's settings that the JAX launcher fixes:
``--microbatches``, ``--remat``, ``--grad-dtype`` and ``--fixed-batch``
(every step on the first batch: an overfitting check).  ``--devices N``
starts N ranks (``launch.ranks.spawn_ranks``, gloo), each on the global
batch's shard of its data axis; on one card they share it.  The ranks run
ZeRO-1, ``TrainConfig.zero1``'s default: the JAX launcher passes the same
config but places its moments like the parameters, replicated, so there
each device holds the whole state where here a rank holds 1/N of it (the
same per-element arithmetic).  ``--model-axis M`` > 1 builds a (N/M, M)
data x model mesh (``launch.mesh.mesh_groups``) whose model axis runs
every layer tensor-parallel (``parallel.tensor``) and, as the JAX
launcher's ``make_ctx`` does, the MoE layers' experts expert-parallel
beside it.  Each rank then holds its part of the split leaves (drawn from
the seed, ``init_params(..., ctx=)``), and a checkpoint gathers them into
the JAX layout.  The cross-attention families take their context from the
stubs, as the JAX launcher does: every step the same ``audio_frames``
(encoded inside the loss) or ``vision_patches`` of the batch's rows.

``run(argv)`` is the entry point the CLI calls; it returns rank 0's printed
lines and every rank's measurements.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.ccl.primitives import _permute
from repro_torch.checkpoint.io import save_checkpoint
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.core.device import resolve_device
from repro_torch.core.tree import param_leaves
from repro_torch.core.types import MeshConfig, TrainConfig
from repro_torch.data import audio_frames, make_batches, vision_patches
from repro_torch.kernels import launch_counts
from repro_torch.launch.mesh import mesh_groups
from repro_torch.launch.ranks import build_kernels, rank_device, spawn_ranks
from repro_torch.models import init_params
from repro_torch.optim import gather_opt_state, init_opt_state
from repro_torch.parallel import gather_params, make_ctx, model_flags
from repro_torch.train import make_train_step


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen2-0.5b", choices=ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card; every rank on one card shares "
                         "it) or cpu")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", action="store_true",
                    help="checkpoint each layer")
    ap.add_argument("--grad-dtype", choices=("f32", "bf16"), default="f32")
    ap.add_argument("--fixed-batch", action="store_true",
                    help="train every step on the first batch")
    return ap.parse_args(argv)


def _train_config(args: argparse.Namespace) -> TrainConfig:
    return TrainConfig(learning_rate=args.lr, warmup_steps=10,
                       total_steps=args.steps, remat=args.remat,
                       microbatches=args.microbatches,
                       grad_dtype=args.grad_dtype)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def checksum(tree) -> int:
    """The bits of every leaf, summed: equal on two ranks only if the
    leaves are (almost surely) bit-equal."""
    return sum(int(t.detach().float().view(torch.int32).sum(
        dtype=torch.int64)) for t in param_leaves(tree))


def train(rank: int, world: int, args: argparse.Namespace
          ) -> Dict[str, Any]:
    """The training loop of one rank (of ``world``; 1: no process group).
    Rank 0 prints the JAX launcher's lines.  Returns the lines and this
    rank's measurements a step: loss, step wall ms, compute ms (the step's
    start to its local gradient, CUDA events on the card), exchange
    seconds, wire and staged bytes (``ccl.primitives._permute``) and
    kernel launches; the optimizer state's bytes against a replicated
    state's, peak memory, and checksums of the final parameters (and,
    with ``--ckpt-dir``, of the full moments written)."""
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = _train_config(args)
    lines: List[str] = []

    def say(line: str) -> None:
        if rank == 0:
            print(line, flush=True)
            lines.append(line)

    ctx = None
    if world > 1:
        device = rank_device(args.device)
        mcfg = MeshConfig(shape=(world // args.model_axis, args.model_axis))
        dgroup, mgroup = mesh_groups(mcfg)
        ctx = make_ctx(dgroup, mcfg, model_group=mgroup, remat=tcfg.remat,
                       cfg=cfg)
        say(f"mesh: {dict(zip(mcfg.axis_names, mcfg.shape))}")
    else:
        device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(tcfg.seed)
    params = init_params(cfg, gen, device=device, ctx=ctx)
    zero1 = ctx is not None and ctx.dp > 1 and tcfg.zero1
    opt = init_opt_state(params, ctx if zero1 else None)  # ZeRO-1 shards
    n_local = sum(p.numel() for p in param_leaves(params))
    tp = ctx.tp if ctx is not None else 1
    n_params = sum(p.numel() * (tp if e else 1) for p, e in
                   zip(param_leaves(params), model_flags(params, ctx, cfg)))
    say(f"arch={cfg.name} params={n_params/1e6:.1f}M "
        f"vocab={cfg.vocab_size} layers={cfg.num_layers}")

    step_fn = make_train_step(cfg, tcfg, ctx)
    batches = make_batches(cfg, args.batch, args.seq, seed=tcfg.seed)
    context = None
    if cfg.is_encoder_decoder:
        context = audio_frames(cfg, args.batch)
    elif cfg.cross_attn_period:
        context = vision_patches(cfg, args.batch)
    first = next(batches)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    steps: List[Dict[str, Any]] = []
    t0 = time.time()
    tokens_seen = 0
    for i in range(args.steps):
        batch = first if args.fixed_batch or i == 0 else next(batches)
        if context is not None:
            batch = {**batch, "context": context}
        marks = {}

        def hook(stage, grads):
            if stage == "local":  # this rank's gradient is done
                marks["local"] = _mark(cuda)

        ex = (_permute.seconds, _permute.sent_bytes, _permute.staged_bytes)
        n0 = launch_counts()
        _sync(device)
        w0 = time.perf_counter()
        marks["start"] = _mark(cuda)
        params, opt, m = step_fn(params, opt, batch, grad_hook=hook)
        _sync(device)
        wall_ms = 1e3 * (time.perf_counter() - w0)
        tokens_seen += args.batch * args.seq
        metrics = {k: float(v) for k, v in m.items()}
        steps.append({
            **metrics, "wall_ms": wall_ms,
            "compute_ms": _elapsed_ms(marks["start"], marks["local"]),
            "exchange_s": _permute.seconds - ex[0],
            "wire_bytes": _permute.sent_bytes - ex[1],
            "staged_bytes": _permute.staged_bytes - ex[2],
            "launches": {k: v - n0[k] for k, v in launch_counts().items()
                         if v != n0[k]}})
        if i % args.log_every == 0 or i == args.steps - 1:
            dt = time.time() - t0
            say(f"step {i:5d} loss={metrics['loss']:.4f} "
                f"ce={metrics['ce']:.4f} lr={metrics['lr']:.2e} "
                f"gnorm={metrics['grad_norm']:.2f} "
                f"tok/s={tokens_seen/max(dt,1e-9):,.0f}")
    whole = gather_params(params, ctx, cfg)  # every leaf, on every rank
    checksums = {"params": checksum(whole)}
    if args.ckpt_dir:
        full = gather_opt_state(opt, ctx, params) if zero1 else opt
        full = {**full, "m": gather_params(full["m"], ctx, cfg),
                "v": gather_params(full["v"], ctx, cfg)}
        checksums.update(m=checksum(full["m"]), v=checksum(full["v"]))
        if rank == 0:
            path = save_checkpoint(cfg, args.ckpt_dir, args.steps, whole,
                                   full)
            say(f"checkpoint: {path}")
        del full
        if world > 1:
            dist.barrier()
    del whole
    moments = [t for k in ("m", "v") for t in param_leaves(opt[k])]
    return {"lines": lines, "steps": steps, "device": str(device),
            "backend": dist.get_backend() if world > 1 else None,
            "params": n_params,
            "opt_state_bytes": sum(t.numel() * t.element_size()
                                   for t in moments),
            "replicated_opt_state_bytes": 2 * 4 * n_local,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(device)
            if cuda else None,
            "checksums": checksums}


def _mark(cuda: bool):
    if not cuda:
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _elapsed_ms(a, b) -> float:
    if isinstance(a, float):
        return 1e3 * (b - a)
    return a.elapsed_time(b)  # the step has synchronized since


def run(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Parses ``argv`` and trains: in this process with ``--devices 1``,
    else on that many gloo ranks (the kernels built first where they run
    on the card).  Returns {"lines": rank 0's printed lines, "ranks":
    each rank's ``train`` result}."""
    args = parse_args(argv)
    resolve_device(args.device)  # no card where one is asked for: raise
    if args.devices == 1:
        ranks = [train(0, 1, args)]
    else:
        if args.devices % args.model_axis:
            raise ValueError(f"--devices {args.devices} is not a multiple "
                             f"of --model-axis {args.model_axis}")
        if torch.device(args.device).type == "cuda":
            build_kernels()
        ranks = spawn_ranks(train, args.devices, args, backend="gloo",
                            timeout_s=3600)
    return {"lines": ranks[0]["lines"], "ranks": ranks}


def main() -> None:
    run()


if __name__ == "__main__":
    main()
