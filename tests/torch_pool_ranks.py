"""Rank functions of ``tests/test_torch_rank_pool.py``, run by
``repro_torch.launch.ranks.RankPool``.  A pool process imports this module
by name, so every function here is at top level."""
import os

import torch
import torch.distributed as dist

from repro_torch.ccl import primitives as prim
from repro_torch.kernels import WRAPPERS, launch_counts


def state(rank: int, world: int, tag: int) -> dict:
    """What this process holds at the start of a run, then a sum over the
    group, and the counters bumped and the precision lowered (left so for
    the next run to find)."""
    seen = {"pid": os.getpid(), "rank": dist.get_rank(),
            "world": dist.get_world_size(),
            "launches": sum(launch_counts().values()),
            "sent": prim._permute.sent_bytes,
            "staged": prim._permute.staged_bytes,
            "seconds": prim._permute.seconds,
            "precision": torch.get_float32_matmul_precision()}
    x = torch.full((4,), float(rank + tag))
    seen["sum"] = prim.ring_all_reduce(x).tolist()
    for wrapper in WRAPPERS.values():
        wrapper.launches += 7
    prim._permute.seconds += 1.0
    torch.set_float32_matmul_precision("medium")
    return seen


def fail_on(rank: int, world: int, bad: int) -> int:
    """Rank ``bad`` raises; the others wait on it at a barrier."""
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    dist.barrier()
    return rank
