"""Shared building blocks: norms, linear init, embeddings, dense FFN, RoPE.

Port of ``repro.models.modules``.  Parameter shapes and layouts are the JAX
package's, so ``repro_torch.bridge`` carries weights over by value.  The
``init_*`` functions pass each leaf, as it is drawn, through ``cut(name,
leaf)``: a tensor-parallel rank keeps its block of it
(``parallel.planner.tp_cut``), so that no rank holds a whole model.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.types import ModelConfig
from repro_torch.parallel.tensor import copy_to_model, reduce_from_model


def whole(name: str, w: torch.Tensor) -> torch.Tensor:
    """The ``cut`` of a rank that keeps every leaf whole."""
    return w


def dense_init(in_dim: int, out_shape, dtype, device,
               generator: torch.Generator) -> torch.Tensor:
    """Truncated-normal (+-3 sigma) fan-in init, drawn as (in_dim, prod(out))
    and reshaped to (in_dim, *out_shape) like the JAX package."""
    flat_out = math.prod(out_shape)
    w = torch.empty((in_dim, flat_out), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
    w.mul_(1.0 / math.sqrt(in_dim))
    return w.reshape(in_dim, *out_shape).to(dtype)


def embed_init(vocab: int, d: int, dtype, device,
               generator: torch.Generator) -> torch.Tensor:
    w = torch.randn((vocab, d), dtype=torch.float32, device=device,
                    generator=generator) * 0.02
    return w.to(dtype)


def init_norm(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    # parity: computed in f32 and cast back (repro/models/modules.py:39-44)
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq).

    Parity: rotates the split halves (x1, x2) = x[..., :hd/2], x[..., hd/2:],
    not interleaved pairs, and computes in f32 (repro/models/modules.py:61-70).
    """
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, device=x.device)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_ffn(cfg: ModelConfig, d_ff: int, dtype, device,
             generator: torch.Generator, cut=whole) -> dict:
    d = cfg.d_model
    names = ("w_gate", "w_up") if cfg.ffn_act in ("swiglu", "geglu") \
        else ("w_up",)
    p = {name: cut(name, dense_init(d, (d_ff,), dtype, device, generator))
         for name in names}
    p["w_down"] = cut("w_down", dense_init(d_ff, (d,), dtype, device,
                                           generator))
    return p


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # parity: jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def ffn_apply(params: dict, x: torch.Tensor, act: str,
              ctx=None) -> torch.Tensor:
    """The FFN of ``x`` (..., d).  ``ctx``: the tensor-parallel context of
    a rank holding a column block of ``w_gate``/``w_up`` and the same rows
    of ``w_down`` (Megatron's column / row split): ``x`` enters through
    ``copy_to_model`` and the partial products are summed by
    ``reduce_from_model``."""
    if ctx is not None:
        x = copy_to_model(x, ctx)
    if act in ("swiglu", "geglu"):
        g = x @ params["w_gate"]
        u = x @ params["w_up"]
        g = F.silu(g) if act == "swiglu" else _gelu(g)
        y = (g * u) @ params["w_down"]
    else:
        y = _gelu(x @ params["w_up"]) @ params["w_down"]
    return reduce_from_model(y, ctx) if ctx is not None else y
