"""Collective (decomposed) matmul: the overlap lever of Megatron TP (port
of ``repro.parallel.collective_matmul``).

The pattern ``all_gather(x) @ W_col`` serialises a bulk all-gather before
the product can start.  The collective-matmul decomposition (Wang et al.,
ASPLOS'23) splits it into p ring steps: at step s each rank multiplies the
chunk it holds while the next chunk travels, so that the transfer can ride
under the product.  Two duals, each run by every rank of ``group`` (a
process group, ``None`` for the default one) as the JAX package runs them
inside a ``shard_map``:

- ``ag_matmul``: y = all_gather(x) @ W, x sharded on its rows, W on its
  columns; the output keeps W's column block;
- ``matmul_rs``: y = reduce_scatter(x @ W), x sharded on the contraction
  dim, W on its rows; the partial sums travel the same ring.

Each hop is one ``ccl.primitives._permute``, so its bytes and seconds land
in the port's counters, and each local product is a plain ``torch.matmul``
(the JAX package computes them with ``dot_general``, outside any Pallas
kernel).  Like the reference they stand alone: the model's layers sum
their row-parallel products with the all-reduce of ``parallel.tensor``.
The hops here are blocking, so a product and a transfer do not overlap
yet; the chunking and the index algebra are the reference's, hop for hop.
"""
from __future__ import annotations

import torch

from repro_torch.ccl.primitives import _permute, _rank_size, _ring


def ag_matmul(x_local: torch.Tensor, w_local: torch.Tensor,
              group=None) -> torch.Tensor:
    """x_local: (m/p, k), this rank's rows of x; w_local: (k, n/p), its
    column block of W.  Returns (m, n/p): this rank's columns of
    all_gather(x) @ W, in p ring steps (p - 1 hops of x's chunk)."""
    idx, p = _rank_size(group)
    m_local = x_local.shape[0]
    out = x_local.new_zeros((p * m_local, w_local.shape[1]))
    right = _ring(p, 1)
    chunk = x_local
    for s in range(p):
        # the chunk held at step s came from rank idx - s: its rows are
        # block (idx - s) of the gathered x
        src = (idx - s) % p
        out[src * m_local:(src + 1) * m_local] = chunk @ w_local
        if s + 1 < p:
            chunk = _permute([chunk], right, group)[0]
    return out


def matmul_rs(x_local: torch.Tensor, w_local: torch.Tensor,
              group=None) -> torch.Tensor:
    """x_local: (m, k/p), this rank's contraction block of x; w_local:
    (k/p, n), the same rows of W.  Returns (m/p, n): this rank's row block
    of reduce_scatter(x @ W), the partial sums accumulated around the
    ring (the index algebra of ``ring_reduce_scatter``: an accumulator
    made on rank r carries row block r - 1 and gathers every rank's
    partial for it; rank i ends with block i)."""
    idx, p = _rank_size(group)
    m = x_local.shape[0]
    if m % p:
        raise ValueError(f"matmul_rs: {m} rows do not split over {p} ranks")
    mb = m // p
    right = _ring(p, 1)

    def partial(block: int) -> torch.Tensor:
        return x_local[block * mb:(block + 1) * mb] @ w_local

    acc = partial((idx - 1) % p)
    for s in range(p - 1):
        acc = _permute([acc], right, group)[0] + partial((idx - s - 2) % p)
    return acc
