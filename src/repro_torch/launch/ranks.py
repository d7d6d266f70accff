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

``RankPool`` keeps its processes for a sequence of such runs (each in a
process group of its own), so that they start once:

    with RankPool(4) as pool:
        a = pool.run(fn, 4, arg)
        b = pool.run(other, 2, arg)

On the card, ``build_kernels`` first, then in each rank ``rank_device``.
"""
from __future__ import annotations

import datetime
import gc
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.device import resolve_device
from repro_torch.kernels import SOURCES, _build, reset_launch_counts


def _fresh(flags: tuple) -> None:
    """A pool process's state as a fresh process has it: the kernels'
    launch counts and the exchanges' byte and second counters at 0, the
    matmul precision flags at their start values, the peak memory reset."""
    from repro_torch.ccl import primitives as prim
    reset_launch_counts()
    prim._permute.sent_bytes = prim._permute.staged_bytes = 0
    prim._permute.seconds = 0.0
    torch.set_float32_matmul_precision(flags[0])
    torch.backends.cudnn.allow_tf32 = flags[1]
    if torch.cuda.is_initialized():
        torch.cuda.reset_peak_memory_stats()


def _pool_main(rank: int, tasks, results) -> None:
    """A pool process: runs each task of its queue on the rank ``rank`` of
    a process group of its own, until it gets ``None``.  A failed task
    reports its traceback and ends the process."""
    torch.set_num_threads(1)
    flags = (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    while True:
        task = tasks.get()
        if task is None:
            return
        fn, world_size, store, backend, timeout_s, args = task
        try:
            _fresh(flags)
            dist.init_process_group(
                backend, init_method=f"file://{store}", rank=rank,
                world_size=world_size,
                timeout=datetime.timedelta(seconds=timeout_s))
            try:
                out = fn(rank, world_size, *args)
            finally:
                dist.destroy_process_group()
            # the card's memory back before the caller hears of the
            # result: it may go on to allocate what this run held
            gc.collect()
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            results.put((rank, True, out))
        except BaseException:  # reported to the parent, which raises
            results.put((rank, False, traceback.format_exc()))
            raise
        del out


class RankPool:
    """``size`` processes started once, each running the functions that
    ``run`` hands it, so that a sequence of multi-rank runs pays for the
    processes' start (the imports, the card's context, the kernels'
    loading) once:

        with RankPool(4) as pool:
            a = pool.run(fn, 4, arg)
            b = pool.run(other, 2, arg)

    ``run(fn, world_size, *args)`` is ``spawn_ranks`` on the first
    ``world_size`` processes: a fresh process group over a ``file://``
    store, ``fn(rank, world_size, *args)`` on each, the results in rank
    order, any rank's failure raised with its traceback (and the pool
    closed).  Before each function a process resets what a fresh process
    would hold at 0 (``_fresh``); after it, and before it reports, it
    frees its cached device memory, so that the caller finds the card as
    the exit of fresh processes would leave it (but for their contexts).  ``env`` is set in the processes' environment from their
    start (an allocator setting must precede the first allocation)."""

    def __init__(self, size: int, env: Optional[dict] = None):
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(size)]
        saved = {k: os.environ.get(k) for k in env or {}}
        os.environ.update(env or {})
        try:
            self._procs = [ctx.Process(target=_pool_main,
                                       args=(r, self._tasks[r],
                                             self._results), daemon=True)
                           for r in range(size)]
            for proc in self._procs:
                proc.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        self._open = True

    @property
    def size(self) -> int:
        return len(self._procs)

    def run(self, fn: Callable, world_size: int, *args: Any,
            backend: str = "gloo", timeout_s: float = 600.0) -> List[Any]:
        """``fn(rank, world_size, *args)`` on the first ``world_size``
        processes in one process group; their results in rank order."""
        if not self._open:
            raise RuntimeError("the pool is closed")
        if not 0 < world_size <= self.size:
            raise ValueError(f"{world_size} ranks on a pool of {self.size}")
        with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
            store = os.path.join(tmp, "store")
            for r in range(world_size):
                self._tasks[r].put((fn, world_size, store, backend,
                                    timeout_s, args))
            got, failed = self._collect(world_size, timeout_s)
            if failed:
                self.close(wait=False)
        if failed:
            rank, why = failed[0]
            raise RuntimeError(f"rank {rank} of {world_size} failed:\n{why}")
        return [got[r] for r in range(world_size)]

    def _collect(self, world_size: int, timeout_s: float):
        got: dict = {}
        failed: list = []
        deadline = time.monotonic() + timeout_s
        while len(got) + len(failed) < world_size:
            if time.monotonic() > deadline:
                failed += [(r, f"no result within {timeout_s} s")
                           for r in range(world_size) if r not in got]
                break
            try:
                rank, ok, out = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r in range(world_size)
                        if self._procs[r].exitcode is not None
                        and r not in got
                        and r not in (f[0] for f in failed)]
                if dead:  # died without a word: a crash, or killed
                    failed += [(r, f"exit code {self._procs[r].exitcode}")
                               for r in dead]
                continue
            if ok:
                got[rank] = out
            else:
                failed.append((rank, out))
                break  # the others may wait on it forever
        return got, failed

    def close(self, wait: bool = True) -> None:
        """Ends every process: each finishes its task queue where ``wait``,
        and is killed after 30 s or at once otherwise."""
        if not self._open:
            return
        self._open = False
        for q, proc in zip(self._tasks, self._procs):
            if wait and proc.is_alive():
                q.put(None)
        for proc in self._procs:
            proc.join(timeout=30 if wait else 1)
        for proc in self._procs:
            if proc.is_alive():
                proc.kill()
                proc.join()

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close(wait=exc[0] is None)


def spawn_ranks(fn: Callable, world_size: int, *args: Any,
                backend: str = "gloo", timeout_s: float = 600.0
                ) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` fresh processes
    in one process group; return their results in rank order."""
    with RankPool(world_size) as pool:
        return pool.run(fn, world_size, *args, backend=backend,
                        timeout_s=timeout_s)


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
