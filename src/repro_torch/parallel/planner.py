"""The parallel context of the port and its layouts: data parallelism,
tensor parallelism of every layer over the model axis and expert
parallelism of the MoE layers beside it, the parts of
``repro.parallel.planner`` that the port runs.

The JAX package threads a ``ParallelCtx`` holding a mesh through its model
code and lets XLA's sharding propagation place the collectives: plain DP
parameter specs give a gradient all-reduce, ZeRO-1 optimizer-state specs
(``zero1_spec``) a reduce-scatter and an all-gather, the expert specs of
``param_specs`` (experts over the model axis) put each expert's weights on
one model rank, and its Megatron specs (columns of ``wq``/``w_gate``, rows
of ``wo``/``w_down``, the vocabulary of ``embed``/``lm_head``, the Mamba
heads) an activation all-reduce after each row-parallel product.  Here the
context holds the process groups of the data axes and of the model axis
instead, and the step and the layers call the collectives themselves
(``repro_torch.train.make_train_step``, ``repro_torch.models.moe``,
``repro_torch.parallel.tensor``):

- ``make_ctx`` builds the context from the groups and a ``MeshConfig``: a
  model axis runs tensor parallelism (``ParallelCtx.tensor_parallel``) of
  every leaf ``param_specs`` splits, and for a MoE config expert
  parallelism of the experts beside it;
- ``param_specs`` and ``cache_specs`` are the JAX package's layout rules
  (``guarded``, ``_leaf_rule``, ``_mamba_head_axis``), leaf for leaf, on
  the port's trees: one tuple of mesh axes (or ``None``) a dim;
  ``tp_layout`` is what they decide for the model code of a rank;
  ``zero1_spec`` and ``apply_fsdp`` are the JAX package's optimizer-state
  and FSDP specs on those tuples (``parallel.fsdp`` runs the latter:
  ``make_ctx(..., fsdp=True)``);
- ``microbatch_rows`` is the batch shard of ``batch_specs``;
- ``shard_params`` cuts a rank's part out of the full parameters (under
  expert parallelism its experts, model rank m holding experts
  ``m E/tp .. (m+1) E/tp - 1`` and, weight-stationary, its slice of the
  ffn dim over the data axes; of every other leaf that ``param_specs``
  puts on the model axis the m-th of tp equal blocks of that dim), and
  ``gather_params`` puts it back together;
- ``FlatLayout`` is the gradient of this rank's leaves flattened into the
  planner's 64 MiB buckets, with the chunk of each bucket that
  ``ring_reduce_scatter`` leaves on this rank: the ZeRO-1 shard of the
  optimizer state.

A MoE config on a model axis without expert parallelism (the JAX
package's ``moe_dense`` on experts that XLA shards over the model axis) is
not ported: ROADMAP item 8c.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.ccl import primitives as prim
from repro_torch.core.types import MeshConfig, ModelConfig

# the planner's gradient bucket (``plan_iteration(bucket_bytes=...)``), in
# f32 values: the dtype of the sums and of the moments
BUCKET_BYTES = 64 * 2 ** 20
BUCKET_VALUES = BUCKET_BYTES // 4


@dataclass
class ParallelCtx:
    """What the model and the step need to know of the mesh.

    ``group`` is the process group of the data axes (``None``: the default
    group), ``rank`` this process's rank in it and ``dp`` its size;
    ``model_group``, ``model_rank`` and ``tp`` the same of the model axis
    (``model_group`` ``None`` where ``tp`` is 1).  ``grad_all_reduce``
    names the entry of ``ccl.primitives.IMPLEMENTATIONS`` that carries a
    plain-DP gradient sync.  ``use_ep``: the MoE layers run expert-parallel
    over the model axis (``models.moe.moe_apply``), with the JAX package's
    capacity factors and ``ep_weight_stationary`` decode; a model axis
    splits every other leaf that ``param_specs`` puts on it
    (``tensor_parallel``), with or without it.  ``causal_skip`` and
    ``unroll_layers``: the chunked attention's (``models.attention``).
    ``fsdp``: where set, each leaf's dim that ``apply_fsdp`` shards over
    the data axes, by path (``parallel.fsdp.fsdp_layout``): the leaves are
    this rank's shards, gathered before each layer runs.
    """

    group: Any = None
    rank: int = 0
    dp: int = 1
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    model_group: Any = None
    model_rank: int = 0
    tp: int = 1
    remat: bool = True
    use_ep: bool = False
    capacity_factor: float = 1.25
    decode_capacity_factor: float = 4.0
    ep_weight_stationary: bool = False
    grad_all_reduce: str = "ring"
    causal_skip: bool = False
    unroll_layers: bool = False
    fsdp: Optional[dict] = None

    @property
    def ep_axis(self) -> str:
        return self.model_axis

    @property
    def tensor_parallel(self) -> bool:
        """The model axis splits the layers' heads, hidden dims, Mamba
        heads and vocabulary (``tp_layout``), beside the experts under
        ``use_ep``."""
        return self.tp > 1

    def allsum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the data ranks, the same bits on every
        rank: ``ring_all_gather`` then a sum in rank order.  For the
        scalars and small vectors of a step (losses, squared norms, routing
        fractions); on a gloo group ``_permute`` copies them through the
        host, the transport of gloo."""
        if self.dp == 1:
            return x
        return prim.ring_all_gather(x, self.group).sum(dim=0)

    def model_allsum(self, x: torch.Tensor) -> torch.Tensor:
        """``allsum`` over the model ranks."""
        if self.tp == 1:
            return x
        return prim.ring_all_gather(x, self.model_group).sum(dim=0)


def check_tensor_parallel(cfg: ModelConfig, use_ep: bool) -> None:
    """Raises for a MoE config on a model axis without expert parallelism
    (``use_ep`` False): the JAX package runs ``moe_dense`` there on
    experts that XLA shards over the model axis, which the port has not
    ported (ROADMAP item 8c)."""
    if cfg.is_moe and not use_ep:
        raise NotImplementedError(
            f"a model axis without expert parallelism on {cfg.name}'s MoE "
            f"layers (moe_dense on experts split over the model axis) is "
            f"not ported yet: ROADMAP item 8c")


def make_ctx(group, mesh_cfg: MeshConfig, *, model_group=None,
             remat: bool = True, use_ep: Optional[bool] = None,
             capacity_factor: float = 1.25,
             decode_capacity_factor: float = 4.0,
             ep_weight_stationary: bool = False,
             grad_all_reduce: str = "ring",
             cfg: Optional[ModelConfig] = None,
             causal_skip: bool = False, unroll_layers: bool = False,
             fsdp: bool = False) -> ParallelCtx:
    """The context of this rank in ``group`` (the data axes of
    ``mesh_cfg``) and ``model_group`` (its model axis);
    ``repro_torch.launch.mesh.mesh_groups`` builds both.

    ``use_ep`` defaults to ``mesh_cfg.tp > 1`` for a MoE config (and
    where no ``cfg`` is given): the model axis then runs the MoE layers
    expert-parallel beside the tensor parallelism of the other layers, and
    with a model axis of 1 expert parallelism would only add capacity drops
    (the JAX package's default, ``True``, drops tokens there too; pass
    ``use_ep=True`` for that).  A model axis without it on a MoE config
    raises (``check_tensor_parallel``: ROADMAP item 8c).  ``fsdp``
    (which needs ``cfg``): the parameters are sharded over the data axes
    as ``apply_fsdp`` says (``parallel.fsdp``)."""
    if grad_all_reduce not in prim.IMPLEMENTATIONS:
        raise KeyError(f"unknown all-reduce {grad_all_reduce!r}; known: "
                       f"{sorted(prim.IMPLEMENTATIONS)}")
    tp = mesh_cfg.tp
    if use_ep is None:
        use_ep = tp > 1 and (cfg is None or cfg.is_moe)
    if tp > 1 and cfg is not None:
        check_tensor_parallel(cfg, use_ep)
    dp = dist.get_world_size(group)
    if dp != mesh_cfg.dp:
        raise ValueError(f"the group has {dp} ranks, the mesh's data axes "
                         f"{mesh_cfg.data_axes} {mesh_cfg.dp}")
    if tp > 1 and (model_group is None
                   or dist.get_world_size(model_group) != tp):
        raise ValueError(f"a model axis of {tp} needs its model group "
                         f"(launch.mesh.mesh_groups)")
    if fsdp and cfg is None:
        raise ValueError("make_ctx(fsdp=True) needs the config")
    layout = None
    if fsdp:
        from repro_torch.parallel.fsdp import fsdp_layout
        layout = fsdp_layout(cfg, mesh_cfg)
    return ParallelCtx(
        group=group, rank=dist.get_rank(group), dp=dp,
        data_axes=tuple(mesh_cfg.data_axes),
        model_axis=mesh_cfg.model_axes[0],
        model_group=model_group if tp > 1 else None,
        model_rank=dist.get_rank(model_group) if tp > 1 else 0, tp=tp,
        remat=remat, use_ep=use_ep, capacity_factor=capacity_factor,
        decode_capacity_factor=decode_capacity_factor,
        ep_weight_stationary=ep_weight_stationary,
        grad_all_reduce=grad_all_reduce, causal_skip=causal_skip,
        unroll_layers=unroll_layers, fsdp=layout)


# ---------------------------------------------------------------------------
# Layout rules (``param_specs`` / ``cache_specs`` of the JAX package)
# ---------------------------------------------------------------------------

Axis = Union[str, Tuple[str, ...], None]
Spec = Tuple[Axis, ...]


def _axis_size(mesh_cfg: MeshConfig, axis: Axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(mesh_cfg.axis_size(a) for a in axis)
    return mesh_cfg.axis_size(axis)


def guarded(shape: Sequence[int], axes: Sequence[Axis],
            mesh_cfg: MeshConfig, notes: Optional[List[str]] = None,
            what: str = "") -> Spec:
    """The axes of a spec, each dropped (``None``, with a planner note)
    where its size does not divide the dim."""
    out = []
    for dim, ax in zip(shape, axes):
        if ax is not None and dim % _axis_size(mesh_cfg, ax) == 0:
            out.append(ax)
        else:
            if ax is not None and notes is not None:
                notes.append(f"replicated {what} dim={dim} (axis {ax} "
                             f"size {_axis_size(mesh_cfg, ax)} !| {dim})")
            out.append(None)
    return tuple(out)


def validate_spec(spec: Spec, shape: Sequence[int],
                  mesh_cfg: MeshConfig) -> bool:
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                       - len(spec))):
        if ax is not None and dim % _axis_size(mesh_cfg, ax) != 0:
            return False
    return True


def _mamba_head_axis(cfg: ModelConfig, mesh_cfg: MeshConfig) -> Axis:
    """Shard SSM channels only when shards align with head boundaries."""
    m = mesh_cfg.model_axes[0]
    tp = _axis_size(mesh_cfg, m)
    if cfg.ssm_num_heads and cfg.ssm_num_heads % tp == 0:
        return m
    return None


def _leaf_rule(path: str, shape, cfg: ModelConfig, mesh_cfg: MeshConfig,
               notes) -> Spec:
    """The JAX package's rule for the leaf at ``path`` (``/``-joined keys
    of the port's tree) of the (unstacked) ``shape``."""
    m = mesh_cfg.model_axes[0]

    def g(axes, what):
        return guarded(shape, axes, mesh_cfg, notes, what=f"{what}:{path}")

    rep = (None,) * len(shape)
    name = path.rsplit("/", 1)[-1]
    # ---- embeddings / head: the logits stay sharded over the vocabulary
    # and the loss's logsumexp reduces them with a small all-reduce ----
    if name == "embed":
        return g((m, None), "embed")
    if name == "lm_head":
        return g((None, m), "lm_head")
    if name == "scale":  # norms
        return rep
    # ---- attention ----
    if name == "wq":
        return g((None, m, None), "wq")
    if name in ("wk", "wv"):
        return g((None, m, None), "wkv")
    if name == "wo":
        return g((m, None, None), "wo")
    if name == "bq":
        return g((m, None), "bq")
    if name in ("bk", "bv"):
        return g((m, None), "bkv")
    if name == "gate_attn":
        return ()
    # ---- MLA ----
    if name == "w_uq":
        return g((None, m, None), "w_uq")
    if name in ("w_uk", "w_uv"):
        return g((None, m, None), "w_ukv")
    if name in ("w_dq", "w_dkv"):
        return (None, None)
    # ---- MoE ----
    if name == "router":
        return (None, None)
    if name in EXPERT_LEAVES and "ffn" in path and len(shape) == 3 and \
            cfg.is_moe and shape[0] == cfg.num_experts:
        return g((m, None, None), "moe_expert")
    # ---- dense FFN (also MoE shared expert) ----
    if name in ("w_gate", "w_up"):
        return g((None, m), "ffn_col")
    if name == "w_down":
        return g((m, None), "ffn_row")
    # ---- Mamba ----
    sp = _mamba_head_axis(cfg, mesh_cfg)
    if name in ("z_proj", "x_proj"):
        return g((None, sp), "ssm_col")
    if name == "out_proj":
        return g((sp, None), "ssm_row")
    if name == "dt_proj":
        return g((None, sp), "ssm_dt")
    if name in ("b_proj", "c_proj"):
        return (None, None)
    if name == "conv_x":
        return g((None, sp), "ssm_conv")
    if name == "conv_x_bias":
        return g((sp,), "ssm_conv_bias")
    if name in ("conv_b", "conv_c"):
        return (None, None)
    if name in ("conv_b_bias", "conv_c_bias"):
        return (None,)
    if name in ("A_log", "D", "dt_bias"):
        return g((sp,), "ssm_head_vec")
    return rep  # fallback: replicate


def _with_paths(tree, prefix: str = ""):
    """(path, leaf) of every leaf of a port tree, in ``param_leaves``
    order; paths ``/``-joined, list entries by index."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _with_paths(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _with_paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _unflatten_like(tree, values):
    it = iter(values)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return next(it)
    return walk(tree)


def param_shapes(cfg: ModelConfig):
    """The port's parameter tree of ``cfg`` on the meta device: every
    leaf's shape and dtype, no values."""
    from repro_torch.models.transformer import init_params
    return init_params(cfg, torch.Generator(), device="meta")


def param_specs(cfg: ModelConfig, mesh_cfg: MeshConfig,
                notes: Optional[List[str]] = None, shapes=None):
    """The spec of every leaf of the port's parameter tree (``shapes``: a
    tree of tensors of the full shapes, by default ``param_shapes(cfg)``):
    the same tree with a tuple of mesh axes (or ``None``) a dim, the
    entries of the JAX package's ``param_specs`` without the
    group-stacking dim."""
    shapes = param_shapes(cfg) if shapes is None else shapes
    return _unflatten_like(shapes, [
        _leaf_rule(path, tuple(t.shape), cfg, mesh_cfg, notes)
        for path, t in _with_paths(shapes)])


def _bspec(mesh_cfg: MeshConfig) -> Axis:
    axes = tuple(mesh_cfg.data_axes)
    return axes if len(axes) > 1 else axes[0]


def cache_specs(cfg: ModelConfig, mesh_cfg: MeshConfig, batch: int,
                cache_shapes, notes: Optional[List[str]] = None):
    """Specs of the decode cache (``cache_shapes``: the port's cache tree
    of ``models.init_cache``, leaves with a ``shape``): the batch (slot)
    dim over the data axes where they divide it, else the sequence or slot
    dim (the long-context batch-1 case); KV heads, SSM heads and the
    ``conv_x`` channels over the model axis (``guarded``), as the JAX
    package's ``cache_specs`` without the group-stacking dim."""
    b = _bspec(mesh_cfg)
    m = mesh_cfg.model_axes[0]
    batch_ok = batch % _axis_size(mesh_cfg, b) == 0
    bb = b if batch_ok else None

    def g(shape, axes, what):
        return guarded(shape, axes, mesh_cfg, notes, what=what)

    def classify(path: str, shape) -> Spec:
        name = path.rsplit("/", 1)[-1]
        if name in ("k", "v"):
            if "/cross/" in path:  # cross K/V: (B, T, KV, hd)
                return g(shape, (bb, None, m, None), "cross_cache")
            if batch_ok:  # (B, slots, KV, hd)
                return g(shape, (b, None, m, None), "kv_cache")
            return g(shape, (None, b, m, None), "kv_cache_seqsharded")
        if name in ("c", "k_rope"):  # (B, L, lora)
            if batch_ok:
                return g(shape, (b, None, None), "mla_cache")
            return g(shape, (None, b, None), "mla_cache_seqsharded")
        if name == "ssm":  # (B, H, P, N)
            return g(shape, (bb, m, None, None), "ssm_cache")
        if name in ("conv_x", "conv_b", "conv_c"):  # (B, K-1, C)
            return g(shape, (bb, None, m if name == "conv_x" else None),
                     "conv_cache")
        return (None,) * len(shape)

    return _unflatten_like(cache_shapes, [
        classify(path, tuple(t.shape))
        for path, t in _with_paths(cache_shapes)])


def zero1_spec(param_spec: Spec, shape: Sequence[int],
               mesh_cfg: MeshConfig) -> Spec:
    """The JAX package's ZeRO-1 spec of an optimizer-state leaf: the
    parameter's spec plus the data axes on its first free dim they divide
    (unchanged where it already holds them: FSDP)."""
    b = _bspec(mesh_cfg)
    dp = _axis_size(mesh_cfg, b)
    entries = list(tuple(param_spec) + (None,) * (len(shape)
                                                  - len(param_spec)))
    if b in entries:
        return tuple(entries)
    for i, (dim, ax) in enumerate(zip(shape, entries)):
        if ax is None and dim % dp == 0:
            entries[i] = b
            break
    return tuple(entries)


def apply_fsdp(specs, shapes, mesh_cfg: MeshConfig):
    """The JAX package's FSDP (ZeRO-3) specs: each leaf of ``specs`` (the
    port's tree of ``param_specs``) also over the data axes on its first
    free dim they divide (``zero1_spec``; ``shapes``: the leaves' full
    shapes).  ``parallel.fsdp`` shards the leaves so and gathers them on
    demand, as XLA does under these specs."""
    return _unflatten_like(shapes, [
        zero1_spec(sp, tuple(t.shape), mesh_cfg)
        for (_, sp), (_, t) in zip(_with_paths(specs), _with_paths(shapes))])


@dataclass(frozen=True)
class TPLayout:
    """What ``param_specs`` splits over the model axis of a rank (``rank``
    of ``tp``): the query heads (``wq``, ``bq``, ``wo``; of MLA ``w_uq``,
    ``w_uk``, ``w_uv`` and ``wo``), the KV heads (``wk``, ``wv``, ``bk``,
    ``bv``), the dense FFN's hidden dim, the shared experts' hidden dim
    (``shared``), the vocabulary (``embed``, ``lm_head``) and the Mamba
    heads (``_mamba_head_axis``).  Cross-attention and the encoder read
    ``heads`` and ``kv`` as self-attention does."""

    rank: int
    tp: int
    heads: bool
    kv: bool
    ffn: bool
    vocab: bool
    ssm: bool
    shared: bool

    def block(self, n: int) -> Tuple[int, int]:
        """[lo, hi): this rank's block of a dim of ``n`` split tp ways."""
        return self.rank * (n // self.tp), (self.rank + 1) * (n // self.tp)


def tp_layout(cfg: ModelConfig, ctx: Optional[ParallelCtx]
              ) -> Optional[TPLayout]:
    """The layout of ``ctx`` where its model axis splits (``None``
    without one): each flag what ``guarded`` decides for the leaves it
    names."""
    if ctx is None or not ctx.tensor_parallel:
        return None
    tp = ctx.tp
    shared = (cfg.moe_d_ff or cfg.d_ff) * cfg.num_shared_experts
    return TPLayout(
        rank=ctx.model_rank, tp=tp,
        heads=cfg.num_heads > 0 and cfg.num_heads % tp == 0,
        kv=cfg.num_kv_heads > 0 and cfg.num_kv_heads % tp == 0,
        ffn=cfg.d_ff > 0 and cfg.d_ff % tp == 0,
        vocab=cfg.padded_vocab % tp == 0,
        ssm=bool(cfg.ssm_num_heads) and cfg.ssm_num_heads % tp == 0,
        shared=shared > 0 and shared % tp == 0)


def _tp_mesh(tp: int, axis: str) -> MeshConfig:
    """A mesh whose model axis ``axis`` has ``tp`` ranks: all the rules of
    a tensor-parallel rank read (they put no leaf on a data axis)."""
    return MeshConfig(shape=(1, tp), axis_names=("data", axis),
                      model_axes=(axis,))


def tp_dim(path: str, shape, cfg: ModelConfig, ctx: ParallelCtx
           ) -> Optional[int]:
    """The dim of the leaf at ``path`` (full ``shape``) that a
    tensor-parallel ``ctx`` splits, or ``None``."""
    spec = _leaf_rule(path, tuple(shape), cfg,
                      _tp_mesh(ctx.tp, ctx.model_axis), None)
    return next((i for i, ax in enumerate(spec) if ax == ctx.model_axis),
                None)


def tp_dims(cfg: ModelConfig, ctx: ParallelCtx) -> dict:
    """``tp_dim`` of every leaf of the port's parameter tree, by path
    (kept per config and model axis: the meta tree of a full-size config
    takes a second to build)."""
    return _tp_dims(cfg, ctx.tp, ctx.model_axis)


@functools.lru_cache(maxsize=16)
def _tp_dims(cfg: ModelConfig, tp: int, axis: str) -> dict:
    ctx = ParallelCtx(tp=tp, model_axis=axis)
    return {path: tp_dim(path, t.shape, cfg, ctx)
            for path, t in _with_paths(param_shapes(cfg))}


def tp_cut(path: str, w: torch.Tensor, cfg: ModelConfig,
           ctx: ParallelCtx) -> torch.Tensor:
    """This model rank's block of the full leaf ``w`` at ``path`` (a
    contiguous copy), or ``w`` itself where the leaf is replicated."""
    dim = tp_dim(path, w.shape, cfg, ctx)
    if dim is None:
        return w
    n = w.shape[dim] // ctx.tp
    return w.narrow(dim, ctx.model_rank * n, n).clone(
        memory_format=torch.contiguous_format)


# ---------------------------------------------------------------------------
# Expert layouts (the MoE rules of ``param_specs``)
# ---------------------------------------------------------------------------

EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def expert_flags(tree, _expert: bool = False) -> List[bool]:
    """One flag a leaf of a parameter tree (or m or v), in
    ``param_leaves`` order: set for the expert weights of the MoE layers
    (the ``w_gate``, ``w_up``, ``w_down`` of a dict holding a
    ``router``), which expert parallelism shards; the router is
    replicated, and the shared experts are a dense FFN (split by
    ``tp_cut`` on a model axis)."""
    if isinstance(tree, dict):
        moe = "router" in tree
        return [f for k, v in tree.items()
                for f in expert_flags(v, moe and k in EXPERT_LEAVES)]
    if isinstance(tree, list):
        return [f for v in tree for f in expert_flags(v)]
    return [_expert]


def sharded_experts(ctx: Optional[ParallelCtx]) -> bool:
    """Whether ``ctx`` keeps a part of each expert weight on a rank."""
    return ctx is not None and ctx.use_ep and (
        ctx.tp > 1 or (ctx.ep_weight_stationary and ctx.dp > 1))


def expert_range(num_experts: int, ctx: ParallelCtx) -> Tuple[int, int]:
    """[lo, hi): the experts of this model rank, ``model_rank E/tp ..``."""
    if num_experts % ctx.tp:
        raise ValueError(f"{num_experts} experts do not split over a model "
                         f"axis of {ctx.tp}")
    el = num_experts // ctx.tp
    return ctx.model_rank * el, (ctx.model_rank + 1) * el


def ffn_slice(name: str, w: torch.Tensor, ctx: ParallelCtx) -> torch.Tensor:
    """A contiguous copy of this rank's experts ``w`` (K5 wants its
    weights contiguous), weight-stationary only the ``rank``-th of dp
    slices of the ffn dim: (E/tp, d, ff/dp) for ``w_gate``/``w_up``,
    (E/tp, ff/dp, d) for ``w_down``."""
    if ctx.ep_weight_stationary and ctx.dp > 1:
        dim = 1 if name == "w_down" else 2
        ff = w.shape[dim]
        if ff % ctx.dp:
            raise ValueError(f"an ffn dim of {ff} does not split over "
                             f"{ctx.dp} data ranks")
        w = w.narrow(dim, ctx.rank * (ff // ctx.dp), ff // ctx.dp)
    return w.clone(memory_format=torch.contiguous_format)


def expert_shard(name: str, w: torch.Tensor, ctx: ParallelCtx
                 ) -> torch.Tensor:
    """This rank's part of the full expert weight ``w`` (``name`` one of
    ``EXPERT_LEAVES``): its experts (``expert_range``), weight-stationary
    its slice of the ffn dim (``ffn_slice``)."""
    lo, hi = expert_range(w.shape[0], ctx)
    return ffn_slice(name, w[lo:hi], ctx)


def model_flags(params, ctx: Optional[ParallelCtx],
                cfg: Optional[ModelConfig] = None) -> List[bool]:
    """One flag a leaf of this rank's parameter tree (or m or v), in
    ``param_leaves`` order: set where the leaf is this rank's part of a
    leaf split over the model axis: the experts under expert parallelism
    (``expert_flags``) and every other leaf that ``param_specs`` puts on
    the model axis (which needs ``cfg``).  The other leaves are the same
    on every model rank."""
    experts = expert_flags(params)
    if ctx is not None and ctx.tensor_parallel:
        dims = tp_dims(cfg, ctx)
        return [e or dims[path] is not None
                for (path, _), e in zip(_with_paths(params), experts)]
    if sharded_experts(ctx):
        return experts
    return [False] * len(experts)


def _split(ctx: Optional[ParallelCtx], cfg: Optional[ModelConfig],
           what: str) -> bool:
    """Whether ``ctx``'s model axis splits the leaves (raising where it
    has no config, or where the layout is not ported)."""
    if ctx is None or not ctx.tensor_parallel:
        return False
    if cfg is None:
        raise ValueError(f"{what}: a model axis needs the config")
    check_tensor_parallel(cfg, ctx.use_ep)
    return True


def shard_params(params, ctx: Optional[ParallelCtx],
                 cfg: Optional[ModelConfig] = None):
    """The tree with each leaf that ``ctx`` splits replaced by this rank's
    part: each expert weight (of a dict holding a ``router``) by
    ``expert_shard``; on a model axis (which needs ``cfg``) every other
    leaf that ``param_specs`` puts on it by its block (``tp_cut``).  Every
    other leaf is the same tensor; with nothing split, the tree itself."""
    split = _split(ctx, cfg, "shard_params")
    experts = sharded_experts(ctx)
    if not (split or experts):
        return params
    return _unflatten_like(params, [
        expert_shard(path.rsplit("/", 1)[-1], t, ctx) if e and experts
        else tp_cut(path, t, cfg, ctx) if split else t
        for (path, t), e in zip(_with_paths(params), expert_flags(params))])


def gather_params(params, ctx: Optional[ParallelCtx],
                  cfg: Optional[ModelConfig] = None):
    """The inverse of ``shard_params``: each split leaf gathered from the
    ranks that hold its parts (the model group, and for weight-stationary
    experts the data group), every other leaf the same tensor.  Every rank
    calls it and gets the full tree."""
    split = _split(ctx, cfg, "gather_params")
    experts = sharded_experts(ctx)
    if not (split or experts):
        return params
    dims = tp_dims(cfg, ctx) if split else {}
    out = []
    for (path, t), e in zip(_with_paths(params), expert_flags(params)):
        if e and experts:
            t = _gather_expert(path.rsplit("/", 1)[-1], t, ctx)
        elif split and dims[path] is not None:
            got = prim.ring_all_gather(t.contiguous(), ctx.model_group)
            t = torch.cat(got.unbind(0), dim=dims[path])
        out.append(t)
    return _unflatten_like(params, out)


def _gather_expert(name: str, w: torch.Tensor, ctx: ParallelCtx
                   ) -> torch.Tensor:
    if ctx.ep_weight_stationary and ctx.dp > 1:
        dim = 1 if name == "w_down" else 2
        w = torch.cat(prim.ring_all_gather(w, ctx.group).unbind(0), dim=dim)
    if ctx.tp > 1:
        w = prim.ring_all_gather(w, ctx.model_group).flatten(0, 1)
    return w


def microbatch_rows(batch_size: int, microbatches: int,
                    ctx: Optional[ParallelCtx] = None
                    ) -> List[Tuple[slice, slice]]:
    """(the microbatch's global rows, this rank's rows of it), one pair a
    microbatch.  Microbatch i is the global rows [i B/nmb, (i+1) B/nmb),
    as the JAX step splits the batch; within it rank r takes the r-th of
    ``dp`` equal parts, as ``batch_specs`` shards the batch dimension (with
    one microbatch: rows [r B/dp, (r+1) B/dp))."""
    dp, rank = (ctx.dp, ctx.rank) if ctx is not None else (1, 0)
    if batch_size % (microbatches * dp):
        raise ValueError(f"batch {batch_size} is not a multiple of "
                         f"{microbatches} microbatches x {dp} ranks")
    mb = batch_size // microbatches
    local = mb // dp
    return [(slice(i * mb, (i + 1) * mb),
             slice(i * mb + rank * local, i * mb + (rank + 1) * local))
            for i in range(microbatches)]


@dataclass(frozen=True)
class FlatLayout:
    """This rank's parameter leaves (its parts of the leaves split over the
    model axis) flattened in ``param_leaves`` order and cut
    into buckets of ``BUCKET_VALUES``; each bucket is padded to a multiple
    of ``dp`` and split into ``dp`` chunks, and this rank owns chunk
    ``rank`` of each, the chunk ``ring_reduce_scatter`` leaves on it.

    The ZeRO-1 shard (``zero1_spec`` of the JAX package, which shards each
    stacked leaf of the optimizer state on its first free divisible dim) is
    the concatenation of this rank's chunks: the same per-element AdamW
    arithmetic on 1/dp of the state, padding included (zeros, which stay
    zeros)."""

    shapes: Tuple[Tuple[int, ...], ...]
    dp: int
    rank: int

    @property
    def numel(self) -> int:
        return sum(math.prod(s) for s in self.shapes)

    @property
    def buckets(self) -> List[Tuple[int, int]]:
        n = self.numel
        return [(lo, min(lo + BUCKET_VALUES, n))
                for lo in range(0, n, BUCKET_VALUES)]

    def chunk(self, lo: int, hi: int) -> int:
        """Values in each rank's chunk of the bucket [lo, hi)."""
        return -(-(hi - lo) // self.dp)

    @property
    def shard_numel(self) -> int:
        return sum(self.chunk(lo, hi) for lo, hi in self.buckets)

    def flatten(self, leaves: Sequence[torch.Tensor],
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """One flat tensor of every leaf, in ``dtype`` (default: the
        leaves' common dtype, promoted where they differ)."""
        flat = torch.cat([t.reshape(-1) for t in leaves])
        return flat if dtype is None else flat.to(dtype)

    def unflatten(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Views of ``flat`` shaped like the leaves."""
        sizes = [math.prod(s) for s in self.shapes]
        return [t.view(s) for t, s in zip(flat.split(sizes), self.shapes)]

    def _padded(self, flat: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """Bucket [lo, hi) of ``flat`` as (dp, chunk), zero-padded."""
        c = self.chunk(lo, hi)
        x = flat[lo:hi]
        pad = self.dp * c - (hi - lo)
        if pad:
            x = torch.cat([x, x.new_zeros(pad)])
        return x.view(self.dp, c)

    def shard(self, flat: torch.Tensor) -> torch.Tensor:
        """This rank's chunks of ``flat`` (no communication)."""
        return torch.cat([self._padded(flat, lo, hi)[self.rank]
                          for lo, hi in self.buckets])

    def shard_ranges(self, flags: Sequence[bool]) -> List[Tuple[int, int]]:
        """The [start, stop) ranges of ``shard``'s result that hold values
        of the leaves whose flag is set (``model_flags``)."""
        offsets = [0]
        for s in self.shapes:
            offsets.append(offsets[-1] + math.prod(s))
        flagged = [(offsets[i], offsets[i + 1])
                   for i, f in enumerate(flags) if f]
        out, at = [], 0
        for lo, hi in self.buckets:
            c = self.chunk(lo, hi)
            s0 = lo + self.rank * c
            s1 = min(s0 + c, hi)
            for a, b in flagged:
                a, b = max(a, s0), min(b, s1)
                if a < b:
                    out.append((at + a - s0, at + b - s0))
            at += c
        return out

    def reduce_scatter(self, flat: torch.Tensor, group) -> torch.Tensor:
        """Each bucket through ``ring_reduce_scatter``: this rank's chunks
        of the sum over the ranks."""
        return torch.cat([prim.ring_reduce_scatter(
            self._padded(flat, lo, hi), group) for lo, hi in self.buckets])

    def all_gather(self, shard: torch.Tensor, group) -> torch.Tensor:
        """Every rank's chunks back into one flat tensor, bucket by bucket
        through ``ring_all_gather`` (the inverse of ``shard``)."""
        out = shard.new_empty(self.numel)
        at = 0
        for lo, hi in self.buckets:
            c = self.chunk(lo, hi)
            got = prim.ring_all_gather(shard[at:at + c], group)
            out[lo:hi] = got.reshape(-1)[:hi - lo]
            at += c
        return out

    def all_reduce(self, flat: torch.Tensor, impl: str, group
                   ) -> torch.Tensor:
        """Each bucket through ``make_all_reduce(impl)``, in place."""
        fn = prim.make_all_reduce(impl, group)
        for lo, hi in self.buckets:
            flat[lo:hi] = fn(flat[lo:hi])
        return flat


def flat_layout(leaves: Sequence[torch.Tensor],
                ctx: Optional[ParallelCtx] = None) -> FlatLayout:
    dp, rank = (ctx.dp, ctx.rank) if ctx is not None else (1, 0)
    return FlatLayout(tuple(tuple(t.shape) for t in leaves), dp, rank)
