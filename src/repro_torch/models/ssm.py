"""Mamba2 (state-space duality) block: chunked SSD prefill, recurrent decode.

Port of ``repro.models.ssm``.  Projections stay separate tensors (z / x / B /
C / dt and per-stream convs) in the JAX package's layout.  The scan of
prefill (``mamba_forward``) goes through ``ssd_scan``, which runs the
hand-written SSD-scan kernel on a CUDA tensor and the plain chunked dual
form (``ssd_chunked``) on the CPU; the device decides.  ``ssd_chunked``
and ``_segsum`` live beside the kernel (``repro_torch.kernels.ssd_scan.ref``)
and are re-exported here.

Decode (``mamba_decode``) is the single-step recurrence and runs no kernel,
as in the JAX package; it updates the cache in place and returns it.

Tensor parallelism (``ctx``, where ``parallel.planner.tp_layout`` splits
the SSM heads, ``ssm_num_heads % tp == 0``): a rank holds the columns of
``z_proj``, ``x_proj``, ``dt_proj``, ``conv_x``, ``conv_x_bias`` and the
entries of ``A_log``, ``D``, ``dt_bias`` of its heads, and those rows of
``out_proj``; ``b_proj``, ``c_proj``, ``conv_b``, ``conv_c`` and the norm's
scale stay whole, as the JAX rules keep them.  The input enters the head
blocks through ``copy_to_model``; B and C, computed whole on every rank,
through ``copy_to_model`` too (each rank's heads give part of their
gradient); the gated norm's mean square is summed over the model ranks
(``sum_over_model``: it spans the whole ``d_inner``), each rank scaling
by its slice of the scale; the output's partial sums go through
``reduce_from_model``.  The cache holds this rank's heads and
``conv_x`` channels.

Where the model axis keeps the SSM heads whole but divides the ``d_inner``
channels (``TPLayout.conv_x``: mamba2-130m's 24 heads at tp 16), every
leaf and the computation stay whole, but ``cache_specs`` splits the
decode cache's ``conv_x`` channels: a rank holds its block of them
(``conv_block``).  Its decode convolves that block where it lives and
all-gathers the f32 outputs over the model ranks, in rank order
(``gather_from_model``), before the whole-head state step, as XLA does
under those specs.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.types import ModelConfig
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import (  # noqa: F401
    DEFAULT_CHUNK,
    _segsum,
    ssd_chunked,
)
from repro_torch.models.modules import dense_init, init_norm, rms_norm, whole
from repro_torch.parallel.planner import tp_layout
from repro_torch.parallel.tensor import (copy_to_model, gather_from_model,
                                         reduce_from_model, sum_over_model)


def init_mamba(cfg: ModelConfig, dtype, device,
               generator: torch.Generator, cut=whole) -> dict:
    """``cut``: as ``modules.init_ffn``'s, on the leaves a rank may split
    (B and C's projections and convolutions, and the norm, stay whole)."""
    d = cfg.d_model
    din = cfg.ssm_d_inner
    n = cfg.ssm_state
    h = cfg.ssm_num_heads
    k = cfg.ssm_conv_kernel

    def conv_init(ch):
        return (torch.randn((k, ch), dtype=torch.float32, device=device,
                            generator=generator) * 0.1).to(dtype)

    def zeros(ch, dt=dtype):
        return torch.zeros((ch,), dtype=dt, device=device)

    return {
        "z_proj": cut("z_proj", dense_init(d, (din,), dtype, device,
                                           generator)),
        "x_proj": cut("x_proj", dense_init(d, (din,), dtype, device,
                                           generator)),
        "b_proj": dense_init(d, (n,), dtype, device, generator),
        "c_proj": dense_init(d, (n,), dtype, device, generator),
        "dt_proj": cut("dt_proj", dense_init(d, (h,), dtype, device,
                                             generator)),
        "conv_x": cut("conv_x", conv_init(din)),
        "conv_x_bias": cut("conv_x_bias", zeros(din)),
        "conv_b": conv_init(n),
        "conv_b_bias": zeros(n),
        "conv_c": conv_init(n),
        "conv_c_bias": zeros(n),
        # f32 whatever the weights' dtype, as in the JAX package
        "A_log": cut("A_log", torch.log(torch.linspace(
            1.0, 16.0, h, dtype=torch.float32, device=device))),
        "D": cut("D", torch.ones((h,), dtype=torch.float32, device=device)),
        "dt_bias": cut("dt_bias", zeros(h, torch.float32)),
        "norm": init_norm(din, dtype, device),
        "out_proj": cut("out_proj", dense_init(din, (d,), dtype, device,
                                               generator)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via shifted adds. x: (B, L, C); w: (K, C)."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i:i + x.shape[1], :] * w[i]
    return F.silu(out + b)


def _tp_heads(cfg: ModelConfig, ctx):
    lay = tp_layout(cfg, ctx)
    return lay if lay is not None and lay.ssm else None


def conv_block(cfg: ModelConfig, ctx):
    """[lo, hi): the ``conv_x`` channels of this rank's decode cache where
    the model axis splits them and not the heads (``TPLayout.conv_x``),
    else ``None``."""
    lay = tp_layout(cfg, ctx)
    return lay.block(cfg.ssm_d_inner) if lay is not None and lay.conv_x \
        else None


def _gated_norm(p: dict, cfg: ModelConfig, y, z, lay, ctx):
    """``rms_norm(y * silu(z), norm.scale)`` over the whole ``d_inner``:
    with a layout, y and z are this rank's channels, their mean square a
    sum over the model ranks and the scale this rank's slice."""
    if lay is None:
        return rms_norm(y * F.silu(z), p["norm"]["scale"], cfg.norm_eps)
    v = (y * F.silu(z)).float()
    lo, hi = lay.block(cfg.ssm_d_inner)
    scale = copy_to_model(p["norm"]["scale"], ctx)[lo:hi]
    var = sum_over_model(v.square().sum(dim=-1, keepdim=True),
                         ctx) / cfg.ssm_d_inner
    return (v * torch.rsqrt(var + cfg.norm_eps) * scale.float()).to(y.dtype)


def mamba_forward(p: dict, cfg: ModelConfig, xin: torch.Tensor, *,
                  chunk: int = DEFAULT_CHUNK, ctx=None) -> torch.Tensor:
    """xin: (B, L, d) -> (B, L, d).  L must be <= chunk or a multiple of it
    (``ValueError`` otherwise, where the JAX package asserts).  ``ctx``: a
    tensor-parallel context (the module's docstring)."""
    lay = _tp_heads(cfg, ctx)
    h = p["A_log"].shape[0]  # this rank's heads
    hd = cfg.ssm_head_dim
    xf = xin if lay is None else copy_to_model(xin, ctx)
    z = xf @ p["z_proj"]
    x = _causal_conv(xf @ p["x_proj"], p["conv_x"], p["conv_x_bias"])
    b = _causal_conv(xin @ p["b_proj"], p["conv_b"], p["conv_b_bias"])
    c = _causal_conv(xin @ p["c_proj"], p["conv_c"], p["conv_c_bias"])
    if lay is not None:
        b, c = copy_to_model(b, ctx), copy_to_model(c, ctx)
    dt = F.softplus((xf @ p["dt_proj"]).float() + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    # the scan runs in f32 whatever the weights' dtype (repro ssm.py:157-162)
    xh = x.float().reshape(*x.shape[:2], h, hd)
    # the kernel's (B,H,L,P) / (B,H,L) as permuted views: no copy
    y = ssd_scan(xh.permute(0, 2, 1, 3), dt.permute(0, 2, 1), a,
                 b.float(), c.float(), chunk=chunk).permute(0, 2, 1, 3)
    y = y + xh * p["D"][:, None]
    y = y.reshape(*xin.shape[:2], h * hd).to(xin.dtype)
    y = _gated_norm(p, cfg, y, z, lay, ctx) @ p["out_proj"]
    return y if lay is None else reduce_from_model(y, ctx)


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device,
                     heads=None, channels=None) -> dict:
    """Slot axis first: conv histories (batch, K-1, C) in ``dtype``, the
    SSM state (batch, H, P, N) in f32; ``heads`` (by default the
    config's) SSM heads, a tensor-parallel rank's those of its ``A_log``;
    ``channels`` ``conv_x`` channels, by default those of the heads (a
    rank's ``conv_block`` where the model axis splits them alone)."""
    h = heads or cfg.ssm_num_heads
    din, n = channels or h * cfg.ssm_head_dim, cfg.ssm_state
    km1 = cfg.ssm_conv_kernel - 1
    return {
        "conv_x": torch.zeros((batch, km1, din), dtype=dtype, device=device),
        "conv_b": torch.zeros((batch, km1, n), dtype=dtype, device=device),
        "conv_c": torch.zeros((batch, km1, n), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, h, cfg.ssm_head_dim, n),
                           dtype=torch.float32, device=device),
    }


def _conv_step(hist: torch.Tensor, new: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """hist: (B, K-1, C) past inputs, shifted in place; new: (B, C).
    Concatenates in the cache's dtype and sums in f32 (repro ssm.py:181-186).
    Returns the activated output."""
    full = torch.cat([hist, new[:, None, :].to(hist.dtype)], dim=1)
    out = torch.einsum("bkc,kc->bc", full.float(), w.float()) + b
    hist.copy_(full[:, 1:])
    return F.silu(out)


def mamba_decode(p: dict, cfg: ModelConfig, xin: torch.Tensor, cache: dict,
                 ctx=None) -> Tuple[torch.Tensor, dict]:
    """Single-token recurrent step. xin: (B, 1, d).  Updates ``cache`` in
    place; returns (out (B, 1, d), cache).  ``ctx``: as
    ``mamba_forward``'s; where it splits the ``conv_x`` channels alone
    (``conv_block``), the cache holds this rank's block of them."""
    lay = _tp_heads(cfg, ctx)
    h = p["A_log"].shape[0]
    hd = cfg.ssm_head_dim
    x0 = xin[:, 0]
    z = x0 @ p["z_proj"]
    blk = conv_block(cfg, ctx)
    if blk is None:
        x = _conv_step(cache["conv_x"], x0 @ p["x_proj"], p["conv_x"],
                       p["conv_x_bias"])
    else:  # this rank's channels of the whole product, then all of them
        lo, hi = blk
        if cache["conv_x"].shape[-1] != hi - lo:
            raise ValueError(f"conv_x cache of {cache['conv_x'].shape[-1]} "
                             f"channels; this rank holds {hi - lo}")
        x = gather_from_model(_conv_step(
            cache["conv_x"], (x0 @ p["x_proj"])[:, lo:hi],
            p["conv_x"][:, lo:hi], p["conv_x_bias"][lo:hi]), ctx)
    b = _conv_step(cache["conv_b"], x0 @ p["b_proj"], p["conv_b"],
                   p["conv_b_bias"])
    c = _conv_step(cache["conv_c"], x0 @ p["c_proj"], p["conv_c"],
                   p["conv_c_bias"])
    dt1 = F.softplus((x0 @ p["dt_proj"]).float() + p["dt_bias"])  # (B,H)
    a = -torch.exp(p["A_log"])

    xh = x.float().reshape(-1, h, hd)
    decay = torch.exp(dt1 * a)  # (B,H)
    hnew = (cache["ssm"] * decay[..., None, None]
            + torch.einsum("bh,bhp,bn->bhpn", dt1, xh, b.float()))
    cache["ssm"].copy_(hnew)
    y = torch.einsum("bhpn,bn->bhp", hnew, c.float()) + xh * p["D"][:, None]
    y = y.reshape(-1, h * hd).to(xin.dtype)
    y = _gated_norm(p, cfg, y, z, lay, ctx) @ p["out_proj"]
    if lay is not None:
        y = reduce_from_model(y, ctx)
    return y[:, None, :], cache
