"""Plain PyTorch version of the SSD scan kernel, and the model's scan.

Port of ``repro.models.ssm._segsum`` / ``ssd_chunked`` (the chunked dual form
of Mamba2's SSD, arXiv:2405.21060 Sec. 6) and of
``repro.kernels.ssd_scan.ref.ssd_scan_ref`` (the same scan re-laid out to the
kernel's (B,H,L,P)).  ``ssd_chunked`` lives here rather than in
``repro_torch.models.ssm`` (which re-exports it) so that the kernel's wrapper
can use it without importing the model package.
"""
from __future__ import annotations

import torch

DEFAULT_CHUNK = 256


def check_chunk(length: int, chunk: int) -> int:
    """The chunk length the scan uses; raises where the JAX package asserts
    (``repro/models/ssm.py:99-100``): L must be a multiple of min(chunk, L)."""
    q = min(chunk, length)
    if q < 1 or length % q:
        raise ValueError(f"sequence length {length} is not a multiple of the "
                         f"chunk {q}; the SSD scan takes L <= chunk or a "
                         f"multiple of it")
    return q


def _segsum(dac: torch.Tensor) -> torch.Tensor:
    """dac: (..., Q) log-decay per step. Returns (..., Q, Q) with
    out[i, j] = sum_{j < m <= i} dac[m]  (-inf above the diagonal)."""
    q = dac.shape[-1]
    cs = torch.cumsum(dac, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]  # [i,j] = cs_i - cs_j
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=dac.device))
    # -inf before the exp: above the diagonal cs_i - cs_j > 0 can reach
    # +1e3, and exp would overflow to inf (inf * 0 = NaN)
    return torch.where(mask, diff, torch.full_like(diff, -torch.inf))


def ssd_chunked(x, dt, a, b, c, *, chunk: int = DEFAULT_CHUNK, h0=None):
    """Chunked SSD scan.

    x: (B, L, H, P) f32; dt: (B, L, H) f32 (post-softplus);
    a: (H,) negative decay rates; b, c: (B, L, N) (single group, broadcast
    over heads).  Returns (y (B,L,H,P), h_final (B,H,P,N))."""
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    q = check_chunk(l, chunk)
    nc = l // q

    xs = x.reshape(bsz, nc, q, h, p)
    dts = dt.reshape(bsz, nc, q, h)
    bs = b.reshape(bsz, nc, q, n)
    cs_ = c.reshape(bsz, nc, q, n)

    da = dts * a  # (B,nc,Q,H) log-decay contributions
    da_cum = torch.cumsum(da, dim=2)  # inclusive within chunk
    da_total = da_cum[:, :, -1]  # (B,nc,H)

    # intra-chunk (dual / attention-like) term
    lmat = torch.exp(_segsum(da.movedim(2, 3)))  # (B,nc,H,Q,Q)
    scores = torch.einsum("bcin,bcjn->bcij", cs_, bs)  # (B,nc,Q,Q)
    w = scores[:, :, None] * lmat  # (B,nc,H,Q,Q)
    y_diag = torch.einsum("bchij,bcjh,bcjhp->bcihp", w, dts, xs)

    # chunk -> state contributions
    decay_out = torch.exp(da_total[:, :, None, :] - da_cum)  # (B,nc,Q,H)
    states = torch.einsum("bcjn,bcjh,bcjh,bcjhp->bchpn",
                          bs, decay_out, dts, xs)  # (B,nc,H,P,N)

    # inter-chunk recurrence (jax.lax.scan in the JAX package)
    hprev = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device)
             if h0 is None else h0.float())
    h_before = []
    for ci in range(nc):
        h_before.append(hprev)
        hprev = hprev * torch.exp(da_total[:, ci])[:, :, None, None] \
            + states[:, ci]
    h_before = torch.stack(h_before, dim=1)  # (B,nc,H,P,N) at chunk start

    # inter-chunk output term
    decay_in = torch.exp(da_cum)  # (B,nc,Q,H)
    y_off = torch.einsum("bcin,bcih,bchpn->bcihp", cs_, decay_in, h_before)

    y = (y_diag + y_off).reshape(bsz, l, h, p)
    return y, hprev


def ssd_scan_ref(x, dt, a, b, c, *, chunk: int = 128):
    """x: (B,H,L,P); dt: (B,H,L); a: (H,); b,c: (B,L,N) -> y (B,H,L,P) in
    x's dtype, computed in f32."""
    y, _ = ssd_chunked(x.movedim(1, 2).float(), dt.movedim(1, 2).float(),
                       a.float(), b.float(), c.float(), chunk=chunk)
    return y.movedim(2, 1).to(x.dtype)
