"""Model and training configuration types of the PyTorch port.

A copy of ``LayerSpec``, ``_round_up``, ``ModelConfig``, ``ShapeConfig`` (and
its named workload shapes), ``TrainConfig``, ``MeshConfig`` and the two named
meshes from ``repro.core.types``: that module holds no JAX code, but
importing anything under ``repro`` runs ``repro/__init__.py``, which imports
jax.  The fields and derived properties are kept identical, so a config built
here compares equal field by field with its JAX twin.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Literal, Optional, Tuple

LayerKind = Literal["attn", "mamba", "cross_attn"]
FFNKind = Literal["dense", "moe", "none"]


@dataclass(frozen=True)
class LayerSpec:
    """One decoder layer: its mixer (attention / mamba) and its FFN."""

    mixer: LayerKind = "attn"
    ffn: FFNKind = "dense"


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description. One instance per ``configs/<id>.py``."""

    name: str
    family: Literal["dense", "ssm", "moe", "audio", "vlm", "hybrid"]
    source: str

    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention flavour ---
    attention: Literal["gqa", "mla", "none"] = "gqa"
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    sliding_window: Optional[int] = None  # tokens; None = full attention

    # --- MLA (DeepSeek-V2) ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0  # 0 -> head_dim

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_layer_period: int = 1
    moe_first_dense: int = 0
    router_aux_loss: float = 0.01

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_kernel: int = 4
    attn_period: int = 0

    # --- encoder-decoder (audio) ---
    encoder_layers: int = 0

    # --- VLM cross-attention interleave ---
    cross_attn_period: int = 0
    num_vision_tokens: int = 0
    num_audio_frames: int = 0

    # --- misc ---
    ffn_act: Literal["swiglu", "gelu", "geglu"] = "swiglu"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq_len: int = 524_288

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def resolved_v_head_dim(self) -> int:
        return self.v_head_dim or self.resolved_head_dim

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def padded_vocab(self) -> int:
        """Vocab padded so the embedding/LM-head shard cleanly over TP=16."""
        return _round_up(self.vocab_size, 256)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        """Per-layer (mixer, ffn) pattern for the decoder stack."""
        specs = []
        for i in range(self.num_layers):
            if self.attention == "none":
                mixer = "mamba"
            elif self.attn_period > 0:
                mixer = "attn" if i % self.attn_period == 0 else "mamba"
            elif self.cross_attn_period > 0 and (i % self.cross_attn_period
                                                 == self.cross_attn_period - 1):
                mixer = "cross_attn"
            else:
                mixer = "attn"
            if self.ssm_state > 0 and self.attn_period == 0:
                ffn = "none" if self.d_ff == 0 else "dense"
            elif self.is_moe and i >= self.moe_first_dense and (
                    i % self.moe_layer_period == self.moe_layer_period - 1
                    or self.moe_layer_period == 1):
                ffn = "moe"
            else:
                ffn = "dense"
            specs.append(LayerSpec(mixer=mixer, ffn=ffn))
        return tuple(specs)

    def layer_groups(self) -> Tuple[Tuple[Tuple[LayerSpec, ...], int], ...]:
        """Group the layer pattern into (period, repeats).

        The JAX package scans over parameters stacked per group; the port
        loops over layers, and uses the grouping only to unstack the JAX
        parameter tree in the same layer order (``repro_torch.bridge``).
        """
        specs = self.layer_specs()
        best = ((specs, 1),)
        best_period = len(specs)
        for prefix in range(0, 3):
            body = specs[prefix:]
            m = len(body)
            if not m:
                continue
            for period in range(1, m + 1):
                if m % period:
                    continue
                pat = body[:period]
                if all(body[j] == pat[j % period] for j in range(m)):
                    if period < best_period:
                        groups = []
                        if prefix:
                            groups.append((specs[:prefix], 1))
                        groups.append((pat, m // period))
                        best = tuple(groups)
                        best_period = period
                    break
        return best

    def param_counts(self) -> dict:
        """Returns dict with total and active (per-token) parameter counts:
        the JAX package's estimate (attention, Mamba and FFN matrices and
        the embeddings; norms, biases and cross-attention gates left out).
        A cross-attention layer counts as a GQA layer; an encoder-decoder
        config adds its encoder layers (attention and dense FFN) and one
        cross-attention block per decoder layer."""
        d = self.d_model
        hd = self.resolved_head_dim
        vhd = self.resolved_v_head_dim
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        if self.attention == "mla":
            rope = self.qk_rope_head_dim
            attn = (d * self.q_lora_rank
                    + (self.q_lora_rank or d) * self.num_heads * (hd + rope)
                    + d * (self.kv_lora_rank + rope)
                    + self.kv_lora_rank * self.num_heads * (hd + vhd)
                    + self.num_heads * vhd * d)
        else:
            attn = (2 * self.num_heads + 2 * self.num_kv_heads) * d * hd
        din, nh, ns = self.ssm_d_inner, self.ssm_num_heads, self.ssm_state
        # in_proj: z, x, B, C, dt; conv; A_log, D; out_proj
        mamba = (d * (2 * din + 2 * ns + nh)
                 + self.ssm_conv_kernel * (din + 2 * ns) + 2 * nh + din * d)

        def ffn(dff: int) -> int:
            return (3 if self.ffn_act in ("swiglu", "geglu") else 2) * d * dff

        moe_ffn = ffn(self.moe_d_ff or self.d_ff)
        total = active = emb
        for spec in self.layer_specs():
            mixer = mamba if spec.mixer == "mamba" else attn
            total += mixer
            active += mixer
            if spec.ffn == "dense":
                total += ffn(self.d_ff)
                active += ffn(self.d_ff)
            elif spec.ffn == "moe":
                shared = self.num_shared_experts * moe_ffn
                router = d * self.num_experts
                total += self.num_experts * moe_ffn + shared + router
                active += self.top_k * moe_ffn + shared + router
        if self.encoder_layers:
            enc = (self.encoder_layers * (attn + ffn(self.d_ff))
                   + self.num_layers * attn)
            total += enc
            active += enc
        return {"total": total, "active": active}


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]
    # decode shapes attend against a cache of ``seq_len`` and produce 1 token.


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

INPUT_SHAPES: Tuple[ShapeConfig, ...] = (
    TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)

SHAPES_BY_NAME = {s.name: s for s in INPUT_SHAPES}


@dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters, field for field the JAX package's.
    ``zero1`` decides a data-parallel step's gradient sync, as the JAX
    package's demand builder decides it: reduce-scatter of the gradient and
    all-gather of the updated parameters under ZeRO-1, all-reduce without
    (``repro_torch.train.make_train_step``).  ``grad_sync`` is read by
    nothing, in the JAX package as here.  The step reads ``remat`` (the JAX
    package reads it from its ``ParallelCtx``; the port's must agree)."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1_000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    zero1: bool = True  # shard optimizer state over the data axis
    remat: bool = True  # activation checkpointing per layer
    grad_sync: Literal["all_reduce", "reduce_scatter"] = "reduce_scatter"
    microbatches: int = 1  # grad-accumulation steps (activation memory / K)
    grad_dtype: Literal["f32", "bf16"] = "f32"  # sync precision
    seed: int = 0


@dataclass(frozen=True)
class MeshConfig:
    """How logical parallelism axes map onto the device mesh (the JAX
    package's, field for field).  The port runs the data axes: the ranks of
    a ``torch.distributed`` group (``repro_torch.launch.mesh``)."""

    shape: Tuple[int, ...] = (16, 16)
    axis_names: Tuple[str, ...] = ("data", "model")
    # which mesh axes carry each parallel dimension
    data_axes: Tuple[str, ...] = ("data",)
    model_axes: Tuple[str, ...] = ("model",)
    pipeline_axis: Optional[str] = None

    @property
    def num_devices(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    @property
    def tp(self) -> int:
        return math.prod(self.axis_size(a) for a in self.model_axes)

    @property
    def dp(self) -> int:
        return math.prod(self.axis_size(a) for a in self.data_axes)


SINGLE_POD_MESH = MeshConfig()
MULTI_POD_MESH = MeshConfig(
    shape=(2, 16, 16), axis_names=("pod", "data", "model"),
    data_axes=("pod", "data"), model_axes=("model",))
