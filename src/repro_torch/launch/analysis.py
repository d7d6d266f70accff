"""What one rank's program costs, counted as it runs on the meta device:
the port's counterpart of ``repro.launch.analysis``.

The JAX package reads XLA's compiled module: ``cost_analysis()`` for the
FLOPs and bytes, ``memory_analysis()`` for the memory a device, and the
optimised HLO text for the collectives (``parse_collectives``).  The port
has no compiled module; its dry-run runs the eager step once on meta
tensors of one rank's shards (``launch.dryrun``) and counts what it
dispatches:

- ``record_collectives``: every outermost collective of
  ``ccl.primitives`` (which ``parallel.tensor``, ``parallel.fsdp``,
  ``models.moe`` and the train step call), under the reference's kinds
  and its result-shape bytes, beside ``_permute.sent_bytes``, the bytes
  the rank put on the wire;
- ``CostMode``: the bytes every aten op reads and writes (its tensor
  inputs and outputs; views move nothing), the elements out of its
  transcendental ops, and the high-water mark of the storage allocated
  while it runs: eager, unfused counts;
- the FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``
  (matmul-class ops: mm, bmm, addmm, convolutions, attention), forward
  and backward.

``measure`` runs a program under all three and returns an ``Account``,
which ``cost_summary`` and ``memory_summary`` read with the reference's
keys.
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.ccl import primitives as prim

# ops whose outputs are transcendental functions of their inputs (XLA's
# "transcendentals": exp, log, tanh, logistic, rsqrt, sqrt, pow, ...)
_TRANSCENDENTAL = frozenset({
    "exp", "exp_", "exp2", "expm1", "log", "log_", "log1p", "log2",
    "tanh", "tanh_", "tanh_backward", "sigmoid", "sigmoid_",
    "sigmoid_backward", "rsqrt", "rsqrt_", "sqrt", "sqrt_", "silu",
    "silu_", "silu_backward", "softplus", "softplus_backward", "gelu",
    "gelu_backward", "sin", "cos", "pow", "pow_", "erf", "_softmax",
    "_softmax_backward_data", "_log_softmax", "_log_softmax_backward_data",
    "logsumexp", "reciprocal", "reciprocal_"})
# ops that allocate but move no data
_NO_TRAFFIC = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                         "new_empty_strided", "detach", "alias",
                         "lift_fresh"})


@dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)
    ops: List[Tuple[str, int]] = field(default_factory=list)
    sent_bytes: int = 0  # ``_permute.sent_bytes`` over the recording

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def add(self, kind: str, result) -> None:
        """One collective of ``kind`` whose result is ``result`` (a tensor,
        a list of them, or ``None`` for a permute that receives
        nothing)."""
        nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(result)
                     if isinstance(t, torch.Tensor))
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + nbytes
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1
        self.ops.append((kind, nbytes))


@contextlib.contextmanager
def record_collectives():
    """Records every outermost collective of ``ccl.primitives`` called
    inside the block into the ``CollectiveStats`` it yields."""
    stats = CollectiveStats()
    sent0 = prim._permute.sent_bytes
    prim._RECORDERS.append(stats.add)
    try:
        yield stats
    finally:
        prim._RECORDERS.remove(stats.add)
        stats.sent_bytes = prim._permute.sent_bytes - sent0


def _storage(t: torch.Tensor):
    return t.untyped_storage()


def storage_bytes(tensors: Iterable[torch.Tensor]) -> int:
    """Bytes of the distinct storages under ``tensors``."""
    seen: dict = {}
    for t in tensors:
        st = _storage(t)
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


class CostMode(TorchDispatchMode):
    """Counts the bytes and transcendentals of every aten op dispatched
    inside it, and the live bytes of the storages its ops allocate (those
    of ``arguments`` excluded): ``peak`` is their high-water mark."""

    def __init__(self, arguments: Iterable[torch.Tensor] = ()):
        super().__init__()
        self.bytes = 0
        self.transcendentals = 0
        self.live = 0
        self.peak = 0
        self._args = {id(_storage(t)) for t in arguments}
        self._owned: Dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._owned.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        st = _storage(t)
        key = id(st)
        if key in self._args or key in self._owned:
            return
        n = st.nbytes()
        self._owned[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self._track(t)
        if func.is_view or name in _NO_TRAFFIC:
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        if name in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        return out


@dataclass
class Account:
    """What ``measure`` counted of one program run: the port's counterpart
    of a compiled module's analyses."""

    flops: float
    bytes: float
    transcendentals: float
    collectives: CollectiveStats
    argument_bytes: int
    temp_bytes: int
    output_bytes: int


def measure(program: Callable, arguments: Iterable[torch.Tensor]
            ) -> Account:
    """Runs ``program()`` once under the counters; ``arguments``: the
    tensors it reads that live before it (parameters, optimizer state,
    batch, cache)."""
    arguments = list(arguments)
    with record_collectives() as coll, \
            FlopCounterMode(display=False) as flops, \
            CostMode(arguments) as cost:
        out = program()
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        output_bytes = storage_bytes(outs)
        peak = cost.peak
        del out, outs
    return Account(flops=float(flops.get_total_flops()),
                   bytes=float(cost.bytes),
                   transcendentals=float(cost.transcendentals),
                   collectives=coll,
                   argument_bytes=storage_bytes(arguments),
                   temp_bytes=peak, output_bytes=output_bytes)


def cost_summary(account: Account) -> Dict[str, float]:
    return {"flops": account.flops, "bytes": account.bytes,
            "transcendentals": account.transcendentals}


def memory_summary(account: Account) -> Dict[str, float]:
    """The reference's keys.  The port's outputs are the arguments updated
    in place or storages allocated while the program ran, inside the
    temporaries' high-water mark: all of their bytes alias."""
    out = {"argument_size_in_bytes": float(account.argument_bytes),
           "output_size_in_bytes": float(account.output_bytes),
           "temp_size_in_bytes": float(account.temp_bytes),
           "generated_code_size_in_bytes": 0.0,
           "alias_size_in_bytes": float(account.output_bytes)}
    out["total_per_device"] = (out["argument_size_in_bytes"]
                               + out["temp_size_in_bytes"]
                               + out["output_size_in_bytes"]
                               - out["alias_size_in_bytes"])
    return out
