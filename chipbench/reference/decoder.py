"""Plain PyTorch reference of a decoder-only transformer's training step.

It knows the configurations that name it (``"reference": "decoder"``):
GQA self-attention with RoPE (split halves) and optional q/k/v biases,
RMSNorm, a SwiGLU or GeGLU feed-forward layer or a top-k mixture of
experts with the Switch load-balance loss, an LM head tied to the
embedding or not, the mean cross-entropy over the labels that are not -1,
and AdamW with global-norm clipping under a linear-warmup cosine schedule.
It follows the configuration's own statement of each (the file's sizes,
the job's ``train`` settings); it imports nothing of the program and reads
nothing that the program made.  The weights and batches are the
benchmark's.

Precision.  Every product and sum is taken in float32 with TF32 off.
What the configuration states about storage is kept: the parameters live
in their dtype (bf16) and are rounded to it after each update, the
gradient is cast to the job's ``grad_dtype`` before the optimizer, and the
moments are float32.  ``Precision("fp8")`` is the control: the same
reference one step of precision down, the weights stored and read in fp8
(e4m3, one power-of-two scale a tensor), every operand of a product rounded to e4m3 and
the gradient cast to e5m2.

Memory.  The whole batch runs at once; each layer, each block of queries
of the attention, each expert and each block of the LM head is under
``torch.utils.checkpoint``, so that only their inputs are kept for the
backward pass, and a leaf is read as float32 only where it is used.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Q_BLOCK = 512         # queries of one attention block
HEAD_BLOCK = 2048     # tokens of one LM-head block
UPDATE_BLOCK = 1 << 26

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round_fp8(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``t`` on the grid of ``dtype`` under one power-of-two scale a tensor
    (its largest magnitude at most ``top``): values that bf16 holds
    exactly."""
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    scale = torch.exp2(torch.ceil(torch.log2(amax / top)))
    return (t.detach().float() / scale).to(dtype).float() * scale


class Precision:
    """How the reference rounds: "f32" (the reference) or "fp8" (its
    control)."""

    def __init__(self, kind: str = "f32", param_dtype=torch.bfloat16,
                 grad_dtype=torch.bfloat16):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind
        self.param_dtype = param_dtype
        self.grad_dtype = grad_dtype

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        """An operand of a product: as it is in f32, in e4m3 for fp8 (the
        gradient passes straight through the rounding)."""
        t = t.float()
        if self.kind == "f32":
            return t
        return t + (_round_fp8(t, torch.float8_e4m3fn, E4M3_MAX) - t).detach()

    def store(self, p32: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """A parameter as it is stored after an update (an fp8 value in the
        leaf's dtype, which holds it exactly)."""
        if self.kind == "f32":
            return p32.to(like.dtype)
        return _round_fp8(p32, torch.float8_e4m3fn, E4M3_MAX).to(like.dtype)

    def grad(self, g: torch.Tensor) -> torch.Tensor:
        """The gradient as the optimizer gets it (the configured cast)."""
        if self.kind == "f32":
            return g.to(self.grad_dtype)
        return _round_fp8(g, torch.float8_e5m2,
                          E5M2_MAX).to(self.grad_dtype)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x, pos, theta):
    """x (B, S, H, hd); the two halves of the head dim rotated."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = pos[:, None].float() * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attn_block(q, k, v, lo: int, prec: Precision):
    """Causal attention of the queries at positions lo .. lo + len(q) - 1
    over the keys up to the last of them; q (B, c, KV, G, hd), k, v
    (B, end, KV, hd)."""
    c, end = q.shape[1], k.shape[1]
    scores = torch.einsum("bqkgh,bskh->bqkgs", prec.operand(q),
                          prec.operand(k)) / math.sqrt(q.shape[-1])
    qpos = torch.arange(lo, lo + c, device=q.device)
    kpos = torch.arange(end, device=q.device)
    mask = qpos[:, None] >= kpos[None, :]
    scores = scores.masked_fill(~mask[None, :, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bqkgs,bskh->bqkgh", prec.operand(probs),
                        prec.operand(v))


def attention(x, w: dict, cfg: dict, prec: Precision):
    b, s, d = x.shape
    h, kv = cfg["num_heads"], cfg["num_kv_heads"]
    hd = cfg.get("head_dim") or d // h
    xo = prec.operand(x)
    q = torch.einsum("bsd,dhk->bshk", xo, prec.operand(w["wq"]))
    k = torch.einsum("bsd,dhk->bshk", xo, prec.operand(w["wk"]))
    v = torch.einsum("bsd,dhk->bshk", xo, prec.operand(w["wv"]))
    if "bq" in w:
        q = q + w["bq"].float()
        k = k + w["bk"].float()
        v = v + w["bv"].float()
    pos = torch.arange(s, device=x.device)
    q = rope(q, pos, cfg["rope_theta"]).reshape(b, s, kv, h // kv, hd)
    k = rope(k, pos, cfg["rope_theta"])
    outs = []
    for lo in range(0, s, Q_BLOCK):
        hi = min(lo + Q_BLOCK, s)
        outs.append(checkpoint(_attn_block, q[:, lo:hi], k[:, :hi],
                               v[:, :hi], lo, prec, use_reentrant=False))
    o = torch.cat(outs, dim=1).reshape(b, s, h, hd)
    return torch.einsum("bshk,hkd->bsd", prec.operand(o),
                        prec.operand(w["wo"]))


def _act(cfg: dict):
    if cfg["ffn_act"] == "swiglu":
        return F.silu
    if cfg["ffn_act"] == "geglu":
        return lambda t: F.gelu(t, approximate="tanh")
    raise ValueError(f"the reference has no FFN {cfg['ffn_act']!r}")


def ffn(x, wg, wu, wd, cfg: dict, prec: Precision):
    xo = prec.operand(x)
    g = xo @ prec.operand(wg)
    u = xo @ prec.operand(wu)
    return prec.operand(_act(cfg)(g) * u) @ prec.operand(wd)


def _expert(x, wg, wu, wd, cfg, prec):
    return ffn(x, wg, wu, wd, cfg, prec)


def moe(x, w: dict, cfg: dict, prec: Precision):
    """Top-k routing over all experts, each expert on its tokens only;
    returns (y, the Switch load-balance loss)."""
    shp = x.shape
    xt = x.reshape(-1, shp[-1])
    e, k = cfg["num_experts"], cfg["top_k"]
    probs = torch.softmax(xt @ w["router"].float(), dim=-1)
    top, ids = torch.topk(probs, k, dim=-1)
    top = top / top.sum(-1, keepdim=True).clamp(min=1e-9)
    frac = torch.zeros(e, device=x.device).index_add_(
        0, ids.reshape(-1), torch.ones(ids.numel(), device=x.device)) \
        / xt.shape[0]
    aux = e * torch.sum(frac * probs.mean(0)) / k
    y = torch.zeros_like(xt)
    # one view an expert, whose gradients come back as one stack
    wg, wu, wd = (w[n].unbind(0) for n in ("w_gate", "w_up", "w_down"))
    for j in range(e):
        tok, slot = (ids == j).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        out = checkpoint(_expert, xt[tok], wg[j], wu[j], wd[j], cfg, prec,
                         use_reentrant=False)
        y = y.index_add(0, tok, out * top[tok, slot][:, None])
    return y.reshape(shp), aux


def layer(x, w: dict, cfg: dict, prec: Precision):
    eps = cfg.get("norm_eps", 1e-5)
    x = x + attention(rms_norm(x, w["norm1/scale"], eps), w, cfg, prec)
    h = rms_norm(x, w["norm2/scale"], eps)
    if "router" in w:
        y, aux = moe(h, w, cfg, prec)
    else:
        y, aux = ffn(h, w["w_gate"], w["w_up"], w["w_down"], cfg, prec), \
            torch.zeros((), device=x.device)
    return x + y, aux


def _layer_flat(x, names, cfg, prec, *leaves):
    return layer(x, dict(zip(names, leaves)), cfg, prec)


def _layer_weights(weights: dict, i: int) -> Dict[str, torch.Tensor]:
    """Layer i's leaves by their short name (``wq``, ``norm1/scale``)."""
    pre = f"/layers/{i}/"
    out = {}
    for path, t in weights.items():
        if path.startswith(pre):
            rest = path[len(pre):]
            out[rest.split("/", 1)[1] if rest.startswith(("mixer/", "ffn/"))
                else rest] = t
    return out


def _nll_block(h, head, labels, vocab: int, prec: Precision):
    logits = prec.operand(h) @ prec.operand(head)[:, :vocab]
    lse = torch.logsumexp(logits, dim=-1)
    true = torch.gather(logits, 1, labels.clamp(min=0)[:, None])[:, 0]
    return ((lse - true) * (labels != -1).float()).sum()


def loss_fn(weights: dict, cfg: dict, tokens, labels, count,
            prec: Precision):
    """(loss, ce, aux) of the batch: the summed NLL over ``count``, plus
    the router loss times the configuration's weight."""
    # read as f32 once: the lookup and every block of a tied head add their
    # gradients in f32 before the one cast to the leaf's dtype
    embed = prec.operand(weights["/embed"])
    x = embed[tokens]
    aux = torch.zeros((), device=x.device)
    for i in range(cfg["num_layers"]):
        lw = _layer_weights(weights, i)
        names = list(lw)
        x, a = checkpoint(_layer_flat, x, names, cfg, prec, *lw.values(),
                          use_reentrant=False)
        aux = aux + a
    h = rms_norm(x, weights["/final_norm/scale"], cfg.get("norm_eps", 1e-5))
    head = embed.T if cfg.get("tie_embeddings") \
        else prec.operand(weights["/lm_head"])
    h = h.reshape(-1, h.shape[-1])
    lab = labels.reshape(-1)
    nll = torch.zeros((), device=x.device)
    for lo in range(0, h.shape[0], HEAD_BLOCK):
        nll = nll + checkpoint(_nll_block, h[lo:lo + HEAD_BLOCK], head,
                               lab[lo:lo + HEAD_BLOCK], cfg["vocab_size"],
                               prec, use_reentrant=False)
    ce = nll / count
    return ce + cfg.get("router_aux_loss", 0.01) * aux, ce, aux


# --------------------------------------------------------------------------
# the optimizer
# --------------------------------------------------------------------------


def lr_at(step: int, train: dict) -> float:
    """Linear warmup over ``warmup_steps`` (on step + 1), then a cosine
    from 1x to 0.1x of the rate over the remaining steps; ``step`` counted
    from 0."""
    warm = min((step + 1) / max(train["warmup_steps"], 1), 1.0)
    prog = min(max((step - train["warmup_steps"])
                   / max(train["total_steps"] - train["warmup_steps"], 1),
                   0.0), 1.0)
    return train["learning_rate"] * warm * (0.1 + 0.9 * 0.5
                                            * (1 + math.cos(math.pi * prog)))


def _sq(t: torch.Tensor) -> float:
    """sum(t^2) in f64, in blocks (the cast to f64 copies its input)."""
    flat = t.reshape(-1)
    return float(sum(flat[lo:lo + UPDATE_BLOCK].double().square().sum()
                     for lo in range(0, flat.numel(), UPDATE_BLOCK)))


def adamw(params: dict, grads: dict, m: dict, v: dict, step: int,
          train: dict, prec: Precision) -> float:
    """One AdamW step on every leaf in place (decoupled weight decay on
    all of them), the gradient clipped to ``grad_clip`` by the global
    norm; returns that norm before clipping."""
    gnorm = math.sqrt(sum(_sq(g) for g in grads.values()))
    scale = min(1.0, train["grad_clip"] / max(gnorm, 1e-9))
    b1, b2 = train["beta1"], train["beta2"]
    bc1, bc2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
    lr, wd, eps = lr_at(step, train), train["weight_decay"], train["eps"]
    with torch.no_grad():
        for path, p in params.items():
            g = grads[path].reshape(-1)
            if path not in m:
                m[path] = torch.zeros(p.numel(), device=p.device)
                v[path] = torch.zeros(p.numel(), device=p.device)
            new = torch.empty(p.numel(), device=p.device)
            flat = p.reshape(-1)
            for lo in range(0, p.numel(), UPDATE_BLOCK):
                sl = slice(lo, lo + UPDATE_BLOCK)
                gs = g[sl].float() * scale
                mm, vv = m[path][sl], v[path][sl]
                mm.mul_(b1).add_(gs, alpha=1 - b1)
                vv.mul_(b2).addcmul_(gs, gs, value=1 - b2)
                p32 = flat[sl].float()
                upd = (mm / bc1) / ((vv / bc2).sqrt() + eps) + wd * p32
                new[sl] = p32 - lr * upd
            params[path] = prec.store(new, p).reshape(p.shape)
    return gnorm


# --------------------------------------------------------------------------
# three steps
# --------------------------------------------------------------------------


def train_steps(weights: Dict[str, torch.Tensor], cfg: dict, train: dict,
                batches: Sequence[Dict[str, torch.Tensor]],
                diff_sq: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
                prec: Optional[Precision] = None, fault: Optional[str] = None,
                dp: int = 1) -> dict:
    """Follows the step through ``len(batches)`` steps from ``weights``
    (consumed: updated in place).  Returns, in the order of ``weights``:
    ``loss`` of each step; ``grad_norm``, the first step's global norm
    before clipping; ``grad_leaf``, each leaf's norm of the first
    gradient as the optimizer takes it (clipped); ``grad_raw_leaf``, the
    same before clipping; ``update_leaf``, each leaf's norm of its change
    over the steps (``diff_sq`` of the final parameters: the squared
    distances from the weights the seed made).

    ``fault`` (the planted faults read in the program's place):
    ``"half_batch"``, the gradient of half of the batch, its mean over
    that half (the last rows, or with one row its last positions, left
    out); ``"local_grad"``, the gradient of the rows of data rank 0 alone,
    as its share of the global batch (the exchange between the ``dp``
    ranks left out); ``"altered"``, the loss scaled by 1.05 where it is
    produced."""
    prec = prec or Precision("f32")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        params = {p: prec.store(t.float(), t) if prec.kind == "fp8" else t
                  for p, t in weights.items()}
        weights.clear()  # the old values go as the updates replace them
        m: dict = {}
        v: dict = {}
        out = {"loss": []}
        for step, batch in enumerate(batches):
            tokens, labels = batch["tokens"], batch["labels"]
            count = (labels != -1).sum().clamp(min=1).float()
            g_labels, g_count, g_tokens = labels, count, tokens
            if fault == "half_batch":
                g_labels = labels.clone()
                if labels.shape[0] > 1:
                    g_labels[labels.shape[0] // 2:] = -1
                else:
                    g_labels[:, labels.shape[1] // 2:] = -1
                g_count = (g_labels != -1).sum().clamp(min=1).float()
            elif fault == "local_grad":
                rows = labels.shape[0] // dp
                g_tokens, g_labels = tokens[:rows], labels[:rows]
            elif fault not in (None, "altered"):
                raise ValueError(f"unknown fault {fault!r}")
            leaves = {p: t.detach().requires_grad_(True)
                      for p, t in params.items()}
            loss, _, _ = loss_fn(leaves, cfg, g_tokens, g_labels, g_count,
                                 prec)
            if fault == "altered":
                loss = 1.05 * loss
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
            if fault in ("half_batch", "local_grad"):
                with torch.no_grad():
                    loss, _, _ = loss_fn(params, cfg, tokens, labels, count,
                                         prec)
            out["loss"].append(float(loss.detach()))
            del leaves
            grads = {p: prec.grad(torch.zeros_like(params[p]) if g is None
                                  else g)
                     for p, g in zip(params, grads)}
            if step == 0:
                raw = [math.sqrt(_sq(g)) for g in grads.values()]
            gnorm = adamw(params, grads, m, v, step, train, prec)
            if step == 0:
                scale = min(1.0, train["grad_clip"] / max(gnorm, 1e-9))
                out["grad_norm"] = gnorm
                out["grad_raw_leaf"] = raw
                out["grad_leaf"] = [r * scale for r in raw]
            del grads
        del m, v
        out["update_leaf"] = [float(x) for x in diff_sq(params).sqrt()]
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])
