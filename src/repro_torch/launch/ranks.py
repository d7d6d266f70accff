"""Run a function on N ranks of a ``torch.distributed`` process group.

The torch counterpart of running a ``shard_map`` on a mesh, shared by the
multi-rank tests and ``chip_smoke.py``:

    results = spawn_ranks(fn, 4, arg, backend="gloo")

starts 4 processes with the ``spawn`` start method (never ``fork``: the
caller may have CUDA or JAX threads running), has each join one group over
a ``file://`` store in a fresh temporary directory (no fixed TCP port, so
concurrent runs cannot collide), calls ``fn(rank, world_size, *args)`` and
returns the ranks' results in rank order.  ``fn`` must be importable at
module top level, and its arguments and result picklable.  Any rank's
failure makes ``spawn_ranks`` raise with that rank's traceback.

On the card, ``build_kernels`` first, then in each rank ``rank_device``.
"""
from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.device import resolve_device
from repro_torch.kernels import SOURCES, _build


def _rank_main(fn: Callable, rank: int, world_size: int, store: str,
               backend: str, timeout_s: float, args: tuple,
               results) -> None:
    try:
        torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_ranks(fn: Callable, world_size: int, *args: Any,
                backend: str = "gloo", timeout_s: float = 600.0
                ) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` fresh processes
    in one process group; return their results in rank order."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, store, backend,
                                   timeout_s, args, results), daemon=True)
                 for r in range(world_size)]
        for proc in procs:
            proc.start()
        got: dict = {}
        failed: list = []
        deadline = time.monotonic() + timeout_s
        try:
            while len(got) + len(failed) < world_size:
                if time.monotonic() > deadline:
                    failed += [(r, f"no result within {timeout_s} s")
                               for r in range(world_size) if r not in got]
                    break
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, proc in enumerate(procs)
                            if proc.exitcode not in (None, 0)
                            and r not in got
                            and r not in (f[0] for f in failed)]
                    if dead:  # died without a word: a crash, or killed
                        failed += [(r, f"exit code {procs[r].exitcode}")
                                   for r in dead]
                    continue
                if ok:
                    got[rank] = out
                else:
                    failed.append((rank, out))
                    break  # the others may wait on it forever
        finally:
            for proc in procs:
                proc.join(timeout=30 if not failed else 1)
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
    if failed:
        rank, why = failed[0]
        raise RuntimeError(f"rank {rank} of {world_size} failed:\n{why}")
    return [got[r] for r in range(world_size)]


def build_kernels() -> None:
    """Compiles every kernel source, in this process: call it before
    starting ranks on the card, which then load the libraries.  Ranks that
    built at first use would each run nvcc on every source at once."""
    _build.build(list(SOURCES.values()))


def rank_device(device="cuda") -> torch.device:
    """This rank's device, made current: the card ``rank % cards`` (all
    ranks share ``cuda:0`` on one card), or the CPU where asked for.
    Asking for CUDA where there is none raises (``resolve_device``)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda",
                           dist.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def torus_groups(rows: int, cols: int):
    """The two groups of this rank on a ``rows x cols`` mesh of the default
    group (rank = r * cols + c): along the first axis (size ``rows``, the
    ranks with this rank's column) and along the second (size ``cols``).
    Every rank creates every group, in the same order."""
    me = dist.get_rank()
    if dist.get_world_size() != rows * cols:
        raise ValueError(f"a {rows} x {cols} torus needs {rows * cols} "
                         f"ranks, not {dist.get_world_size()}")
    row_group = col_group = None
    for c in range(cols):
        g = dist.new_group([r * cols + c for r in range(rows)])
        if me % cols == c:
            row_group = g
    for r in range(rows):
        g = dist.new_group([r * cols + c for c in range(cols)])
        if me // cols == r:
            col_group = g
    return row_group, col_group
