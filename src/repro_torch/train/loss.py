"""Cross-entropy over the padded-vocab logits.

Port of ``repro.train.loss``: logsumexp in f32 over the padded vocabulary
(whose extra ids carry the LM head's -1e30 bias, so they add nothing),
labels taken at max(label, 0), and the mean over the tokens whose label is
not ``ignore_index``.  A data-parallel rank passes ``count``, the number of
such tokens in the global (micro)batch, so that the ranks' results add up to
the global mean.  A tensor-parallel rank passes its context: its logits are
then its block of the vocabulary
(``parallel.tensor.vocab_parallel_cross_entropy``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.parallel.tensor import vocab_parallel_cross_entropy


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = -1,
                  count: Optional[torch.Tensor] = None,
                  ctx=None) -> torch.Tensor:
    """logits: (B, S, V_pad); labels: (B, S) int.  Returns the mean NLL over
    the non-ignored tokens, f32: their summed NLL over max(their count, 1),
    or over ``count`` where given (already at least 1).  ``ctx``: the
    tensor-parallel context of vocabulary-sharded logits (B, S, V_pad/tp);
    every model rank returns the same loss."""
    if ctx is not None:
        return vocab_parallel_cross_entropy(logits, labels, ctx,
                                            ignore_index, count)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    true_logit = torch.take_along_dim(
        logits, labels.clamp(min=0).long()[..., None], dim=-1)[..., 0]
    nll = lse - true_logit
    mask = (labels != ignore_index).float()
    if count is None:
        count = mask.sum().clamp(min=1.0)
    return (nll * mask).sum() / count
