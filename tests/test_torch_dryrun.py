"""The port's dry-run (``repro_torch.launch.dryrun``, ``.analysis``,
``.mesh``) against the JAX package's (``repro.launch.dryrun``).

- ``meta`` of every architecture x input shape on both production meshes
  equals the reference's, computed here from the JAX package's own
  ``param_specs``, ``eval_shape`` and ``uses_swa_variant`` as its
  ``build_dryrun`` computes it (one subprocess runs that function itself,
  on 512 forced host devices, for one combination);
- ``analyse`` equals the reference's on the same cost vector, but for the
  roofline terms, which read each package's chip;
- on a fake world at smoke size, the collectives the port places count
  what the ring formulas say (``chip_smoke.tp_forward_bytes`` for the
  model axis, ``chip_smoke.fsdp_wire_bytes`` for FSDP,
  ``parallel.sequence.combine_bytes`` for a decode whose data axes split
  the cache's slots);
- ``measure_costs``' extrapolation equals the full-depth count.

The dry-run's programs run in this process, each on a fake world it
initialises and destroys (no other test here initialises
``torch.distributed`` in-process)."""
import torch_threads  # noqa: F401 - caps torch's threads under xdist

import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import chip_smoke
from repro.configs import get_config as jax_get_config
from repro.core.types import MULTI_POD_MESH as JAX_MULTI_POD
from repro.core.types import SHAPES_BY_NAME as JAX_SHAPES
from repro.core.types import SINGLE_POD_MESH as JAX_SINGLE_POD
from repro.launch import dryrun as jax_dryrun
from repro.launch.specs import cache_shapes as jax_cache_shapes
from repro.launch.specs import uses_swa_variant as jax_uses_swa
from repro.models.transformer import init_params as jax_init_params
from repro.parallel.planner import param_specs as jax_param_specs
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.core.types import (INPUT_SHAPES, SHAPES_BY_NAME, MeshConfig,
                                    ShapeConfig)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, mesh_groups, production_world
from repro_torch.launch.specs import cache_shapes, decode_window
from repro_torch.parallel import make_ctx
from repro_torch.parallel import fsdp as fsdp_mod
from repro_torch.parallel.fsdp import fsdp_shard
from repro_torch.parallel.planner import (_bspec, _with_paths, cache_specs,
                                          param_shapes, slot_split)
from repro_torch.parallel.sequence import (SlotBlock, cache_slots,
                                           combine_bytes)
from repro_torch.models import init_cache, init_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [s.name for s in INPUT_SHAPES]


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax.eval_shape(lambda: jax_init_params(
        jax_get_config(arch), jax.random.PRNGKey(0), dtype=jnp.bfloat16))


def jax_meta(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """``repro.launch.dryrun.build_dryrun``'s meta (lines 70-111 and its
    ``cache_bytes``), without the lowering."""
    cfg, shape = jax_get_config(arch), JAX_SHAPES[shape_name]
    mcfg = JAX_MULTI_POD if multi_pod else JAX_SINGLE_POD
    notes: list = []
    jax_param_specs(cfg, mcfg, notes)
    shapes = _jax_params(arch)
    param_bytes = sum(l.size * l.dtype.itemsize
                      for l in jax.tree.leaves(shapes))
    fsdp = param_bytes / mcfg.tp > jax_dryrun.FSDP_THRESHOLD_BYTES
    if fsdp:
        notes.append(f"fsdp=True (param_bytes/tp = "
                     f"{param_bytes / mcfg.tp / 2**30:.1f} GiB)")
    meta = {"arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "kind": shape.kind, "fsdp": bool(fsdp),
            "swa_variant": jax_uses_swa(cfg, shape), "causal_skip": False,
            "param_bytes": param_bytes, "notes": list(notes)}
    if shape.kind == "decode":
        meta["cache_bytes"] = sum(
            l.size * l.dtype.itemsize for l in jax.tree.leaves(
                jax_cache_shapes(cfg, shape, shapes)))
    return meta


@pytest.mark.parametrize("multi_pod", [False, True], ids=["1pod", "2pod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_meta_equals_reference(arch, multi_pod):
    """fsdp, swa_variant, param_bytes, the planner notes (in the JAX
    package's order) and cache_bytes, every key of the reference's meta."""
    for shape in SHAPES:
        _, meta = dryrun.build_dryrun(arch, shape, multi_pod=multi_pod)
        assert meta == jax_meta(arch, shape, multi_pod), (arch, shape)


def test_fsdp_archs():
    """The four configs whose bf16 parameters over tp 16 exceed 4 GiB run
    under FSDP (the JAX package's threshold), on both meshes."""
    got = {a for a in ARCHS
           if dryrun.build_dryrun(a, "train_4k")[1]["fsdp"]}
    assert got == {"dbrx-132b", "llama-3.2-vision-90b", "deepseek-v2-236b",
                   "jamba-1.5-large-398b"}
    assert dryrun.FSDP_THRESHOLD_BYTES == jax_dryrun.FSDP_THRESHOLD_BYTES


_REFERENCE = """
import json
import jax
from jax.sharding import AxisType
import repro.launch.dryrun as d

def mesh(*, multi_pod=False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))

d.make_production_mesh = mesh  # Auto axes: ROADMAP R5
_, meta = d.build_dryrun("qwen2-0.5b", "decode_32k")
print(json.dumps(meta))
"""


def test_reference_build_dryrun_meta():
    """The JAX package's ``build_dryrun`` itself (a subprocess on 512
    forced host devices, its production mesh with Auto axes) gives the
    port's meta."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REFERENCE], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    _, got = dryrun.build_dryrun("qwen2-0.5b", "decode_32k")
    assert got == want


@pytest.mark.parametrize("arch,shape,multi_pod", [
    ("dbrx-132b", "train_4k", False), ("qwen2-0.5b", "decode_32k", True),
    ("seamless-m4t-medium", "prefill_32k", False),
    ("mamba2-130m", "long_500k", False)])
def test_analyse_equals_reference(arch, shape, multi_pod):
    """Every field of ``analyse`` but the roofline terms (each package's
    chip) and the dominant one: the same cost vector and memory give the
    same chips, per-device counts, collectives by kind and useful-FLOPs
    ratio."""
    meta = jax_meta(arch, shape, multi_pod)
    costs = {"flops": 3.5e14, "bytes": 2.25e12, "transcendentals": 4.0e9,
             "collective_bytes": 7.0e10, "coll_all-reduce": 5.0e10,
             "coll_all-gather": 2.0e10, "count_all-reduce": 480.0,
             "count_all-gather": 96.0}
    mem = {"argument_size_in_bytes": 1.0e9, "temp_size_in_bytes": 2.0e9}
    got = dryrun.analyse(dict(meta), mem, dict(costs))
    want = jax_dryrun.analyse(dict(meta), mem, dict(costs))
    for k in ("roofline", "dominant"):
        got.pop(k), want.pop(k)
    assert got == want


def _run(arch, kind, mesh_shape, *, batch=4, seq=32, layers=None, **kw):
    cfg = smoke_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    program, _ = dryrun.build_dryrun(
        arch, "t", cfg_override=cfg, mesh=MeshConfig(tuple(mesh_shape)),
        shape=ShapeConfig("t", seq, batch, kind), **kw)
    return cfg, program()


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
@pytest.mark.parametrize("gather", [False, True])
def test_tp_prefill_collectives(mesh, gather):
    """A tensor-parallel prefill of granite on a fake world: each rank's
    wire bytes are ``tp_forward_bytes`` (the ring all-reduces of the
    embedding and of each row-parallel product, the logits' all-gather
    where gathered), and the result-shape bytes are one (rows, seq, d)
    tensor an all-reduce, (tp, rows, seq, V/tp) an all-gather."""
    dp, tp = mesh
    cfg, acc = _run("granite-3-8b", "prefill", mesh, gather_logits=gather)
    rows, seq = 4 // dp, 32
    coll = acc.collectives
    assert coll.sent_bytes == chip_smoke.tp_forward_bytes(
        cfg, tp, rows, seq, 2, gather=gather)
    n_ar = coll.count_by_kind["all-reduce"]
    assert n_ar == 1 + 2 * cfg.num_layers
    assert coll.bytes_by_kind["all-reduce"] == \
        n_ar * rows * seq * cfg.d_model * 2
    if gather:
        assert coll.count_by_kind["all-gather"] == 1
        assert coll.bytes_by_kind["all-gather"] == \
            rows * seq * cfg.padded_vocab * 2
    else:
        assert "all-gather" not in coll.count_by_kind


@pytest.mark.parametrize("arch,mesh", [
    ("qwen2-0.5b", (4, 1)), ("qwen2-0.5b", (2, 2)),
    ("deepseek-v2-236b", (2, 2))])
def test_seq_split_decode_collectives(arch, mesh):
    """A decode at batch 1, whose data axes split the self-attention and
    MLA caches' slots (``cache_specs``' long-context layout), on a fake
    world: one all-gather a layer (the softmax combine of
    ``parallel.sequence``), of (dp, B, H_local, d_o + 2) f32, and each
    rank's wire bytes the combine's formula plus, on a model axis,
    ``tp_forward_bytes``' decode all-reduces (bf16)."""
    dp, tp = mesh
    cfg, acc = _run(arch, "decode", mesh, batch=1, seq=64)
    coll = acc.collectives
    layers = sum(s.mixer == "attn" for s in cfg.layer_specs())
    combine = combine_bytes(cfg, dp, tp, 1, 64)
    assert combine > 0
    assert coll.count_by_kind["all-gather"] == layers
    assert coll.bytes_by_kind["all-gather"] == combine // (dp - 1) * dp
    model = chip_smoke.tp_forward_bytes(
        cfg, tp, 1, 1, 2, gather=False,
        moe="decode" if cfg.is_moe else None) if tp > 1 else 0
    assert coll.sent_bytes == combine + model


@pytest.mark.parametrize("multi_pod", [False, True], ids=["1pod", "2pod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_shards_are_cache_specs(arch, multi_pod):
    """On a rank of the production mesh, ``init_cache(..., ctx=)`` over the
    rank's parameters splits every leaf over the data axes as the port's
    ``cache_specs`` (the JAX package's rule) splits the whole cache, for
    decode_32k (the rows) and long_500k (the slots, ``slot_split``: the
    attention and MLA caches ``SlotBlock``s, rank 37's block), and every
    dim that the spec puts on the model axis is its 1/tp there (mamba2's
    ``conv_x`` channels too, whose heads tp 16 keeps whole); the dry-run's
    decode cache is built so."""
    cfg = dryrun.get_config(arch)
    whole = param_shapes(cfg)
    mcfg = production_world(multi_pod=multi_pod, rank=37)
    try:
        dgroup, mgroup = mesh_groups(mcfg)
        ctx = make_ctx(dgroup, mcfg, model_group=mgroup, cfg=cfg)
        params = init_params(cfg, torch.Generator(), device="meta", ctx=ctx)
        for name in ("decode_32k", "long_500k"):
            shape = SHAPES_BY_NAME[name]
            full = cache_shapes(cfg, shape, whole)
            specs = cache_specs(cfg, mcfg, shape.global_batch, full)
            rows = shape.global_batch // ctx.dp \
                if shape.global_batch % ctx.dp == 0 else shape.global_batch
            got = init_cache(cfg, params, shape.global_batch, shape.seq_len,
                             torch.bfloat16, window=decode_window(cfg, shape),
                             context=dryrun.context_spec(cfg, rows,
                                                         torch.bfloat16),
                             ctx=ctx)
            data, model = _bspec(mcfg), mcfg.model_axes[0]
            for (path, t), (_, sp), (_, w) in zip(
                    _with_paths(got), _with_paths(specs), _with_paths(full)):
                for i, (d, ax) in enumerate(zip(w.shape, sp)):
                    if ax == data:
                        assert t.shape[i] == d // ctx.dp, (name, path, sp)
                    elif ax == model:
                        assert t.shape[i] == d // ctx.tp, (name, path, sp)
                    elif ax is None and i < 2:  # rows and slots left whole
                        assert t.shape[i] == d, (name, path, sp)
            slots = cache_slots(cfg, shape.seq_len, decode_window(cfg, shape))
            split = slot_split(shape.global_batch, slots, ctx.dp)
            assert split == (name == "long_500k" and slots % ctx.dp == 0)
            for spec, lc in zip(cfg.layer_specs(), got["layers"]):
                blk = spec.mixer == "attn" and split
                assert isinstance(lc, SlotBlock) == blk, (name, spec)
                if blk:
                    assert lc.slots == slots
                    assert lc.lo == ctx.rank * slots // ctx.dp
    finally:
        dist.destroy_process_group()


# mamba2-130m's decode argument bytes a rank on the production meshes
# before its ``conv_x`` cache held only the rank's channels (every channel
# of 24 layers, bf16)
MAMBA_WHOLE_CONV_ARGS = {False: 338_641_184, True: 262_111_504}


@pytest.mark.parametrize("multi_pod", [False, True], ids=["1pod", "2pod"])
def test_mamba_conv_split_decode(multi_pod):
    """mamba2-130m's decode_32k on a rank of the production mesh, whose
    model axis (tp 16) keeps the 24 SSM heads whole and splits the 1,536
    ``conv_x`` channels (``TPLayout.conv_x``): the rank's cache holds 96
    channels of each layer's ``conv_x``, 24 x rows x 3 x 1,440 bf16 bytes
    below the whole channels' figure, and the step all-gathers each
    layer's f32 conv outputs once, (tp, rows, 96) of result and 15 hops of
    (rows, 96) on the wire, beside the embedding's all-reduce."""
    program, _ = dryrun.build_dryrun("mamba2-130m", "decode_32k",
                                     multi_pod=multi_pod)
    acc = program()
    cfg = dryrun.get_config("mamba2-130m")
    tp, rows = 16, 8 if not multi_pod else 4
    blk = cfg.ssm_d_inner // tp
    assert blk == 96 and cfg.ssm_num_heads % tp
    held_out = cfg.num_layers * rows * 3 * (cfg.ssm_d_inner - blk) * 2
    assert held_out == (1_658_880 if not multi_pod else 829_440)
    assert acc.argument_bytes == MAMBA_WHOLE_CONV_ARGS[multi_pod] - held_out
    coll = acc.collectives
    assert coll.count_by_kind == {"all-reduce": 1,
                                  "all-gather": cfg.num_layers}
    assert coll.bytes_by_kind["all-gather"] == \
        cfg.num_layers * rows * cfg.ssm_d_inner * 4
    embed = coll.bytes_by_kind["all-reduce"]  # (rows, 1, d) bf16
    assert embed == rows * cfg.d_model * 2
    assert coll.sent_bytes == (cfg.num_layers * (tp - 1) * rows * blk * 4
                               + 2 * (tp - 1) * embed // tp)


@pytest.mark.parametrize("mesh", [(2, 1), (4, 1)])
@pytest.mark.parametrize("remat,microbatches", [(True, 2), (False, 1)])
def test_fsdp_train_wire_bytes(mesh, remat, microbatches):
    """An FSDP training step of qwen2 on a data-only fake world: each
    rank's wire bytes are ``fsdp_wire_bytes``'s (the gathers at every use,
    the reduce-scatters of the gradients, the metrics' and the norm's
    gathers), and its all-gathers and reduce-scatters count one a use of
    a unit (a layer, the embedding, the final norm)."""
    cfg, acc = _run("qwen2-0.5b", "train", mesh, batch=8, fsdp=True,
                    remat=remat, microbatches=microbatches,
                    grad_dtype="bf16")
    fake_world(mesh[0])
    try:
        ctx = make_ctx(mesh_groups(MeshConfig(mesh))[0], MeshConfig(mesh),
                       cfg=cfg, fsdp=True, remat=remat)
        params = fsdp_shard(init_params(cfg, torch.Generator(),
                                        dtype=torch.bfloat16,
                                        device="meta"), ctx)
        want = chip_smoke.fsdp_wire_bytes(cfg, params, ctx, microbatches,
                                          remat, 2)
        # FSDP's units: a layer, the embedding (twice, as the tied head),
        # the final norm; each gathered by one collective
        units = {p.split("/")[1] + ("/" + p.split("/")[2]
                                    if p.startswith("/layers/") else "")
                 for p, _ in _with_paths(params)
                 if fsdp_mod._dim(ctx, p) is not None}
    finally:
        dist.destroy_process_group()
    assert acc.collectives.sent_bytes == want
    layers = sum(u.startswith("layers/") for u in units)
    uses = len(units) + ("embed" in units and cfg.tie_embeddings)
    counts = acc.collectives.count_by_kind
    assert counts["reduce-scatter"] == microbatches * uses
    # again in the recompute, and the two metric gathers: (loss, ce, aux)
    # and the norm's squares
    assert counts["all-gather"] == \
        microbatches * (uses + layers * remat) + 2


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_world(multi_pod):
    """``production_world`` joins a fake world of the production mesh's
    size (the reference's ``make_production_mesh`` / ``mesh_config``), on
    which ``mesh_groups`` builds 16-rank model groups and 16- or 32-rank
    data groups; ``smoke_mesh_config`` is the reference's (1, 1)."""
    from repro.launch.mesh import mesh_config as jax_mesh_config
    from repro.launch.mesh import smoke_mesh_config as jax_smoke_mesh
    from repro_torch.launch.mesh import (mesh_config, production_world,
                                         smoke_mesh_config)
    mcfg = production_world(multi_pod=multi_pod, rank=37)
    try:
        assert mcfg == mesh_config(multi_pod=multi_pod)
        assert dataclasses.asdict(mcfg) == dataclasses.asdict(
            jax_mesh_config(multi_pod=multi_pod))
        assert dist.get_world_size() == (512 if multi_pod else 256)
        dgroup, mgroup = mesh_groups(mcfg)
        assert dist.get_process_group_ranks(mgroup) == list(range(32, 48))
        assert dist.get_process_group_ranks(dgroup) == \
            list(range(5, mcfg.num_devices, 16))
    finally:
        dist.destroy_process_group()
    assert dataclasses.asdict(smoke_mesh_config()) == \
        dataclasses.asdict(jax_smoke_mesh())


def test_multi_pod_groups():
    """On a (pod, data, model) mesh the data group is every rank of this
    rank's model index over pod and data together, the model group the
    ranks of its (pod, data) index."""
    mcfg = MeshConfig(shape=(2, 2, 2), axis_names=("pod", "data", "model"),
                      data_axes=("pod", "data"), model_axes=("model",))
    fake_world(8, rank=5)  # (pod 1, data 0, model 1)
    try:
        dgroup, mgroup = mesh_groups(mcfg)
        assert dist.get_process_group_ranks(dgroup) == [1, 3, 5, 7]
        assert dist.get_process_group_ranks(mgroup) == [4, 5]
        ctx = make_ctx(dgroup, mcfg, model_group=mgroup)
        assert (ctx.dp, ctx.rank, ctx.tp, ctx.model_rank) == (4, 2, 2, 1)
        assert ctx.data_axes == ("pod", "data")
    finally:
        dist.destroy_process_group()


# one arch of each family, and MLA
FAMILIES = ["granite-3-8b", "mamba2-130m", "dbrx-132b",
            "seamless-m4t-medium", "llama-3.2-vision-90b",
            "jamba-1.5-large-398b", "deepseek-v2-236b"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_extrapolation_equals_full_depth(arch):
    """The JAX package's extrapolation from one and two repeats of the
    last layer group (and one and two encoder layers) gives the
    full-depth count exactly, prefill and decode, on a (2, 2) fake
    world."""
    cfg = smoke_config(arch)
    groups = cfg.layer_groups()
    n = sum(len(p) for p, _ in groups[:-1]) + len(groups[-1][0]) * 3
    cfg = dataclasses.replace(cfg, num_layers=n, **(
        {"encoder_layers": 3} if cfg.is_encoder_decoder else {}))
    mesh = MeshConfig((2, 2))
    for kind in ("prefill", "decode"):
        shape = ShapeConfig("t", 64, 8, kind)
        kw = dict(cfg_override=cfg, mesh=mesh, shape=shape)
        program, _ = dryrun.build_dryrun(arch, "t", unroll=True, **kw)
        full = dryrun._cost_vector(program())
        assert dryrun.measure_costs(arch, "t", **kw) == full, kind


def test_extrapolation_equals_full_depth_fsdp_train():
    """Under FSDP a training step's counts extrapolate exactly too (every
    collective is a leaf's, none a bucket's)."""
    cfg = dataclasses.replace(smoke_config("qwen2-0.5b"), num_layers=3)
    kw = dict(cfg_override=cfg, mesh=MeshConfig((2, 2)), fsdp=True,
              shape=ShapeConfig("t", 64, 8, "train"))
    program, _ = dryrun.build_dryrun("qwen2-0.5b", "t", unroll=True, **kw)
    full = dryrun._cost_vector(program())
    assert dryrun.measure_costs("qwen2-0.5b", "t", **kw) == full


def test_cli_on_host():
    """The CLI runs on a host without a card: qwen2 decode on the
    2 x 16 x 16 mesh, one line of numbers."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-0.5b", "--shape", "decode_32k", "--multi-pod", "--no-save",
         "--skip-costs"], env=env, capture_output=True, text=True,
        timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[qwen2-0.5b x decode_32k x 2x16x16] fsdp=False" in out.stdout
    assert "all dry-runs passed" in out.stdout
    assert np.isfinite(float(out.stdout.split("flops=")[1].split()[0]))
