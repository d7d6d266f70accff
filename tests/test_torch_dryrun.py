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
  model axis, ``chip_smoke.fsdp_wire_bytes`` for FSDP);
- ``measure_costs``' extrapolation equals the full-depth count.

The dry-run's programs run in this process, each on a fake world it
initialises and destroys (no other test here initialises
``torch.distributed`` in-process)."""
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
from repro_torch.core.types import INPUT_SHAPES, MeshConfig, ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, mesh_groups
from repro_torch.parallel import make_ctx
from repro_torch.parallel import fsdp as fsdp_mod
from repro_torch.parallel.fsdp import fsdp_shard
from repro_torch.parallel.planner import _with_paths
from repro_torch.models import init_params

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
