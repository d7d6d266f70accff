"""Plain PyTorch version of the grouped expert GEMM kernel and of its
backward.

Port of ``repro.kernels.moe_gmm.ref.moe_gmm_ref``: the CPU path of the
wrapper, and what the CUDA kernels are held against on the card.
``expanded``: x is the (T, d) tokens that every expert reads (what
``moe_dense`` passes, an (E, T, d) view of expert stride 0 in the forward).
"""
from __future__ import annotations

import torch


def moe_gmm_ref(x, w, *, expanded: bool = False):
    """x: (E, C, d), or (C, d) read by every expert where ``expanded``;
    w: (E, d, f) -> (E, C, f) in x's dtype."""
    if expanded:
        x = x.expand(w.shape[0], *x.shape)
    return torch.einsum("ecd,edf->ecf", x, w).to(x.dtype)


def moe_gmm_bwd_ref(x, w, dy, *, expanded: bool = False):
    """Gradient of ``moe_gmm_ref``: (dx, dw) in the dtypes of x and w,
    accumulated in f32 (in f64 where x is f64), as the backward kernel
    (``csrc/moe_gmm_bwd.cu``) accumulates.  dy: (E, C, f).
    dx_e = dy_e w_e^T and dw_e = x_e^T dy_e; where ``expanded``, x is the
    (C, d) tokens of every expert and dx their one (C, d) sum over the
    experts, sum_e dy_e w_e^T, a single product over (e, f)."""
    work = torch.float64 if x.dtype == torch.float64 else torch.float32
    xw, ww, dyw = x.to(work), w.to(work), dy.to(work)
    if expanded:
        dx = torch.einsum("ecf,edf->cd", dyw, ww)
        dw = torch.einsum("cd,ecf->edf", xw, dyw)
    else:
        dx = torch.einsum("ecf,edf->ecd", dyw, ww)
        dw = torch.einsum("ecd,ecf->edf", xw, dyw)
    return dx.to(x.dtype), dw.to(w.dtype)
