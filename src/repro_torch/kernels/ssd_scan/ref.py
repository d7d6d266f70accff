"""Plain PyTorch version of the SSD scan kernel, and the model's scan.

Port of ``repro.models.ssm._segsum`` / ``ssd_chunked`` (the chunked dual form
of Mamba2's SSD, arXiv:2405.21060 Sec. 6) and of
``repro.kernels.ssd_scan.ref.ssd_scan_ref`` (the same scan re-laid out to the
kernel's (B,H,L,P)).  ``ssd_chunked`` lives here rather than in
``repro_torch.models.ssm`` (which re-exports it) so that the kernel's wrapper
can use it without importing the model package.  ``_segsum`` sums each
segment on its own, the stable form of the JAX package's cumsum
difference (same function, closer to exact in f32).

``ssd_scan_staged`` mirrors the Hopper kernel's three stages in plain
PyTorch (chunk states, the carry across chunks, the chunks' outputs), with
its chunk of ``KERNEL_CHUNK`` rows, its zero padding of a ragged last
chunk, and its products either in f32 or as the tensor cores compute them
(``tf32_round``: one TF32 product, or the split 3xTF32 one the kernel
uses), so that the CPU tests pin the kernel's arithmetic.
"""
from __future__ import annotations

import math

import torch

DEFAULT_CHUNK = 256
KERNEL_CHUNK = 64  # rows of a chunk in csrc/ssd_scan_fwd.cu


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
    out[i, j] = sum_{j < m <= i} dac[m]  (-inf above the diagonal).

    Each segment is summed on its own (a cumsum down the columns of the
    masked terms), not taken as cs_i - cs_j of one cumsum: at the model's
    decays cs falls to -1e3 and below over a chunk of 256, and the
    difference of two such sums loses their ulp in each factor
    exp(cs_i - cs_j) next to the diagonal (up to 2.9e-5 of the scan's
    scale against an f64 recurrence, tools/ssd_scan_accuracy.py: as much
    as the kernel tolerance)."""
    q = dac.shape[-1]
    ones = torch.ones((q, q), dtype=torch.bool, device=dac.device)
    # terms[m, j] = dac[m] for m > j; their cumsum over m is the segment sum
    terms = torch.where(torch.tril(ones, -1), dac[..., :, None],
                        torch.zeros((), dtype=dac.dtype, device=dac.device))
    seg = torch.cumsum(terms, dim=-2)
    # -inf above the diagonal, before the exp: there the sum is empty, but
    # exp must give 0 (the difference form gave +1e3 there, and inf * 0 =
    # NaN)
    return torch.where(torch.tril(ones), seg, torch.full_like(seg, -torch.inf))


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
    state_dtype = torch.promote_types(x.dtype, torch.float32)  # f64 stays
    hprev = (torch.zeros((bsz, h, p, n), dtype=state_dtype, device=x.device)
             if h0 is None else h0.to(state_dtype))
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
    x's dtype, computed in f32 (in f64 where x is f64)."""
    work = torch.float64 if x.dtype == torch.float64 else torch.float32
    y, _ = ssd_chunked(x.movedim(1, 2).to(work), dt.movedim(1, 2).to(work),
                       a.to(work), b.to(work), c.to(work), chunk=chunk)
    return y.movedim(2, 1).to(x.dtype)


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """f32 ``v`` rounded to TF32 (10 mantissa bits), half away from zero,
    as ``cvt.rna.tf32.f32`` does: add half of the dropped 13 bits, then
    mask them (what the kernel does in two integer operations)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(v: torch.Tensor) -> torch.Tensor:
    """f32 ``v`` cut to TF32: what the tensor cores read of an f32 operand
    (its low 13 bits are ignored)."""
    return (v.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _product(a: torch.Tensor, b: torch.Tensor, product: str) -> torch.Tensor:
    """a @ b with the kernel's products: "f32" (exact products, f32 sums),
    "tf32" (one TF32 product) or "3xtf32" (hi*lo + lo*hi + hi*hi with hi =
    tf32_round(v) and lo = v - hi, which the tensor cores cut to TF32; f32
    sums).  A product of two TF32 values is exact in f32, so f32 matmuls of
    rounded operands emulate the tensor cores up to the order of the
    sums."""
    if product == "f32":
        return a @ b
    ah, bh = tf32_round(a), tf32_round(b)
    if product == "tf32":
        return ah @ bh
    if product != "3xtf32":
        raise ValueError(f"unknown product {product!r}")
    al, bl = tf32_trunc(a - ah), tf32_trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def ssd_scan_staged(x, dt, a, b, c, *, q: int = KERNEL_CHUNK,
                    product: str = "f32"):
    """The kernel's staged scan.  x (B,H,L,P), dt (B,H,L), a (H,), b, c
    (B,L,N) -> y (B,H,L,P) in x's dtype, computed in f32 (or in x's dtype
    where that is f64).  L is cut into chunks of ``q`` rows, the last one
    zero-padded (x, dt, b, c = 0: no decay, no state, never returned); per
    chunk cs = cumsum(dt a):
      (i)   S_c = (x_c o w)^T B_c, w = exp(cs_Q - cs) dt; CB_c = C_c B_c^T
            (once per batch row and chunk, shared by the heads);
      (ii)  h_c = h_{c-1} exp(cs_Q) + S_c, h_{-1} = 0;
      (iii) y_c = G_c x_c + exp(cs) o (C_c h_{c-1}^T), G_c[i, j] =
            CB_c[i, j] exp(cs_i - cs_j) dt_j for j <= i, else 0."""
    work = torch.float64 if x.dtype == torch.float64 else torch.float32
    bsz, h, l, p = x.shape
    n = b.shape[-1]
    nc = math.ceil(l / q)
    pad = nc * q - l

    def chunks(t, axis):  # zero-pad L to nc * q, split it into (nc, q)
        t = t.to(work)
        t = torch.cat([t, t.new_zeros(*t.shape[:axis], pad,
                                      *t.shape[axis + 1:])], axis)
        return t.reshape(*t.shape[:axis], nc, q, *t.shape[axis + 1:])

    xs, dts = chunks(x, 2), chunks(dt, 2)        # (B,H,nc,Q,P), (B,H,nc,Q)
    bs, cs_mat = chunks(b, 1), chunks(c, 1)      # (B,nc,Q,N)
    cs = torch.cumsum(dts * a.to(work)[:, None, None], dim=-1)
    cs_last = cs[..., -1]                        # (B,H,nc)

    # (i) chunk states and C B^T
    w = torch.exp(cs_last[..., None] - cs) * dts
    states = _product((xs * w[..., None]).transpose(-1, -2), bs[:, None],
                      product)                   # (B,H,nc,P,N)
    cb = _product(cs_mat, bs.transpose(-1, -2), product)  # (B,nc,Q,Q)

    # (ii) the carry: the state before each chunk
    hcur = states.new_zeros(bsz, h, p, n)
    before = []
    for ci in range(nc):
        before.append(hcur)
        hcur = hcur * torch.exp(cs_last[:, :, ci])[..., None, None] \
            + states[:, :, ci]
    before = torch.stack(before, dim=2)          # (B,H,nc,P,N)

    # (iii) outputs; exp only on and below the diagonal
    tril = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    diff = torch.where(tril, cs[..., :, None] - cs[..., None, :],
                       torch.full((), -torch.inf, dtype=work,
                                  device=x.device))
    g = cb[:, None] * torch.exp(diff) * dts[..., None, :]
    y = _product(g, xs, product) + torch.exp(cs)[..., None] * _product(
        cs_mat[:, None], before.transpose(-1, -2), product)
    return y.reshape(bsz, h, nc * q, p)[:, :, :l].to(x.dtype)


def ssd_scan_bwd_ref(x, dt, a, b, c, dy, *, chunk: int = KERNEL_CHUNK,
                     product: str | None = None):
    """Gradient of the SSD scan, written out stage by stage as the backward
    kernel (``csrc/ssd_scan_bwd.cu``) computes it, not through autograd.
    x (B,H,L,P), dt (B,H,L), a (H,), b, c (B,L,N), dy (B,H,L,P) -> (dx,
    ddt, da, db, dc) in the dtypes of x, dt, a, b, c, computed in f64:
    ddt's sums of mixed-sign terms leave an f32 computation up to ~3e-5 of
    its scale off the exact gradient at the model's decays, as far as the
    f32 kernel's own error, so an f32 reference would not tell the two
    apart within the 5e-5 tolerance.  L is cut into chunks of ``min(chunk, L)`` rows,
    the last one zero-padded (no decay, no state, never returned).  Per
    chunk, with cs = cumsum(dt a), e = exp(cs), w = exp(cs_Q - cs) dt, h
    the state before the chunk and G the gradient of the state after it:
      (i)   dH_c = (dy_c o e)^T C_c, the gradient that the chunk's outputs
            send to the state before it;
      (ii)  the reverse carry G_{c-1} = dH_c + exp(cs_Q,c) G_c, G_last = 0;
      (iii) the dual's backward, as attention's: D = dy x^T and L[i, j] =
            exp(cs_i - cs_j) on and below the diagonal, M = (C B^T) o L,
            dCB = D o L o dt_j; dx = dt o (M^T dy) + w o (B G^T); dC =
            dCB B + e o (dy h), dB = dCB^T C + w o (x G), summed over the
            heads (B and C are shared by them);
      (iv)  d(dt a) at row m, the sum of d cs over rows k >= m, taken
            term by term in forms that do not cancel: L's share is the sum
            of T = M o D o dt_j over the rectangle i >= m > j (its row and
            column sums would cancel to it), e's the sum over k >= m of e_k
            r_k, r_i = C_i . (dy h)_i, w's the sum over k < m of w_k u_k,
            u_j = B_j . (x G)_j, and the carry's exp(cs_Q) <G, h>; then ddt
            = (M o D) summed over i + exp(cs_Q - cs) u + a d(dt a), and da
            = the sum over (B, L) of dt d(dt a).
    ``product`` ("f32", "3xtf32" or "tf32"): compute in f32 instead, with
    every matrix product (the forward's states and C B^T, which the kernel
    reads from K6's workspace, and the backward's ten) taken as
    ``_product`` does, so that the CPU tests pin which products the kernel
    may run on the tensor cores."""
    work = torch.float64 if product is None else torch.float32

    def mm(u, v):
        return u @ v if product is None else _product(u, v, product)
    bsz, h, l, p = x.shape
    n = b.shape[-1]
    q = min(chunk, l)
    nc = math.ceil(l / q)
    pad = nc * q - l

    def chunks(t, axis):
        t = t.to(work)
        t = torch.cat([t, t.new_zeros(*t.shape[:axis], pad,
                                      *t.shape[axis + 1:])], axis)
        return t.reshape(*t.shape[:axis], nc, q, *t.shape[axis + 1:])

    xs, dys, dts = chunks(x, 2), chunks(dy, 2), chunks(dt, 2)
    bs, cm = chunks(b, 1)[:, None], chunks(c, 1)[:, None]  # (B,1,nc,Q,N)
    av = a.to(work)[:, None, None]
    cs = torch.cumsum(dts * av, dim=-1)          # (B,H,nc,Q)
    last = cs[..., -1]                           # (B,H,nc)
    dec = torch.exp(last)
    wo = torch.exp(last[..., None] - cs)         # exponents <= 0
    w = wo * dts
    e = torch.exp(cs)

    # the forward's chunk states and the state before each chunk
    states = mm((xs * w[..., None]).transpose(-1, -2), bs)  # (B,H,nc,P,N)
    hcur = states.new_zeros(bsz, h, p, n)
    before = []
    for ci in range(nc):
        before.append(hcur)
        hcur = hcur * dec[:, :, ci, None, None] + states[:, :, ci]
    before = torch.stack(before, dim=2)

    # (i), (ii): gn[c] = G_c, the gradient of the state after chunk c
    dh_in = mm((dys * e[..., None]).transpose(-1, -2), cm)  # (B,H,nc,P,N)
    g = torch.zeros_like(hcur)
    gn = [None] * nc
    for ci in reversed(range(nc)):
        gn[ci] = g
        g = dh_in[:, :, ci] + dec[:, :, ci, None, None] * g
    gn = torch.stack(gn, dim=2)

    # (iii)
    tril = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    diff = torch.where(tril, cs[..., :, None] - cs[..., None, :],
                       torch.full((), -torch.inf, dtype=work,
                                  device=x.device))
    lmat = torch.exp(diff)
    cb = mm(cm, bs.transpose(-1, -2))            # (B,1,nc,Q,Q)
    d = mm(dys, xs.transpose(-1, -2))            # (B,H,nc,Q,Q)
    m = cb * lmat
    md = m * d
    dcb = d * lmat * dts[..., None, :]
    xg = mm(xs, gn)                              # (B,H,nc,Q,N)
    dh = mm(dys, before)                         # (B,H,nc,Q,N)
    u = (xg * bs).sum(-1)                        # (B,H,nc,Q)
    r = (dh * cm).sum(-1)
    dx = dts[..., None] * mm(m.transpose(-1, -2), dys) \
        + w[..., None] * mm(bs, gn.transpose(-1, -2))
    dc = (mm(dcb, bs) + e[..., None] * dh).sum(1)   # (B,nc,Q,N)
    db = (mm(dcb.transpose(-1, -2), cm) + w[..., None] * xg).sum(1)

    # (iv)
    def before_m(v):  # the sum over j < m, not cumsum - v (which cancels)
        return torch.nn.functional.pad(torch.cumsum(v, -1)[..., :-1], (1, 0))

    t = md * dts[..., None, :]
    er = e * r
    dda = torch.tril(before_m(t)).sum(-2) \
        + torch.flip(torch.cumsum(torch.flip(er, (-1,)), -1), (-1,)) \
        + before_m(w * u) \
        + (dec * (gn * before).sum((-1, -2)))[..., None]
    ddt = md.sum(-2) + wo * u + av * dda
    da = (dts * dda).sum((0, 2, 3))

    def unchunk(t, axis):
        t = t.reshape(*t.shape[:axis], nc * q, *t.shape[axis + 2:])
        return t.narrow(axis, 0, l)

    return (unchunk(dx, 2).to(x.dtype), unchunk(ddt, 2).to(dt.dtype),
            da.to(a.dtype), unchunk(db, 1).to(b.dtype),
            unchunk(dc, 1).to(c.dtype))
