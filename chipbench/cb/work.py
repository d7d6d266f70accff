"""The work of a training step, counted from the cell's shapes, and the
chip's peaks.

The counts are those of the model as the configuration states it, whatever
implements it: recomputed layers, the masked experts of a dense MoE pass
and padded vocabulary rows are not work.  A product of an (m, k) by a
(k, n) matrix is 2 m k n operations; a backward pass is two such products
a product of the forward.
"""
from __future__ import annotations

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates): bf16 tensor-core
# operations a second, and HBM3 bytes a second
PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES = 3.35e12

BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["num_heads"]


def _ffn_mats(cfg: dict, d_ff: int) -> int:
    return (3 if cfg["ffn_act"] in ("swiglu", "geglu") else 2) \
        * cfg["d_model"] * d_ff


def active_matmul_params(cfg: dict) -> int:
    """The weights of the products one token goes through: the attention
    projections, the dense FFN or its top-k experts and the router, the LM
    head over the real vocabulary; no embedding lookup, norm or bias."""
    d, h, kv = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"]
    hd = head_dim(cfg)
    attn = d * (h + 2 * kv) * hd + h * hd * d
    per_layer = attn
    if cfg.get("num_experts", 0):
        per_layer += cfg["top_k"] * _ffn_mats(cfg, cfg.get("moe_d_ff")
                                              or cfg["d_ff"])
        per_layer += d * cfg["num_experts"]
    else:
        per_layer += _ffn_mats(cfg, cfg["d_ff"])
    return cfg["num_layers"] * per_layer + d * cfg["vocab_size"]


def model_flops_per_token(cfg: dict, seq_len: int) -> float:
    """Training operations a token: 6 N_active for the products' forward
    and backward, and 6 L S H hd for causal attention's (its two products
    at half the S x S square, forward and backward)."""
    return 6.0 * active_matmul_params(cfg) + 6.0 * cfg["num_layers"] \
        * seq_len * cfg["num_heads"] * head_dim(cfg)


def attention_work(cfg: dict, rows: int, seq_len: int) -> tuple:
    """(operations, bytes) of a step's causal attention over ``rows``
    sequences, forward and backward, all layers: QK^T and PV forward, four
    products backward, each over half of the S x S square; each input and
    output once (q, k, v, o and the log-sum-exp forward; q, k, v, o, dO
    and the statistics in, dQ, dK, dV out backward)."""
    h, kv, hd, n = cfg["num_heads"], cfg["num_kv_heads"], head_dim(cfg), \
        cfg["num_layers"]
    act = BYTES[cfg.get("param_dtype", "bfloat16")]
    s = seq_len
    flops = 6.0 * rows * h * s * s * hd * n
    qo = rows * s * h * hd * act
    kvb = rows * s * kv * hd * act
    lse = rows * h * s * 4
    fwd = 2 * qo + 2 * kvb + lse
    bwd = (3 * qo + 2 * kvb + lse) + (qo + 2 * kvb)
    return flops, float((fwd + bwd) * n)


def moe_routed_work(cfg: dict, rows: int, seq_len: int) -> tuple:
    """(operations, bytes) of a step's routed expert products, forward
    and backward, all MoE layers: top_k x tokens rows through the gate,
    up and down products; each expert weight read once forward and once
    backward and its gradient written once, the routed rows' inputs and
    outputs once each way."""
    if not cfg.get("num_experts", 0):
        return 0.0, 0.0
    d, ff = cfg["d_model"], cfg.get("moe_d_ff") or cfg["d_ff"]
    e = cfg["num_experts"]
    act = BYTES[cfg.get("param_dtype", "bfloat16")]
    routed = rows * seq_len * cfg["top_k"]
    n = cfg["num_layers"]
    flops = 3 * 3 * 2.0 * routed * d * ff * n
    weights = 3 * e * d * ff * act
    # gate/up: x (routed, d) in, (routed, ff) out; down: (routed, ff) in,
    # (routed, d) out; the backward reads what the forward wrote and
    # writes what it read
    acts = routed * (d + 2 * ff + ff + d) * act
    return flops, float((3 * weights + 2 * acts) * n)


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS_BF16, nbytes / PEAK_BYTES)
