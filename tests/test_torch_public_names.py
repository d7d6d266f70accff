"""The port's public surface against the JAX package's: every public name
that a ``repro.*`` module defines (its top-level functions, classes and
assignments; for a package's ``__init__`` also what it re-exports) exists
in the ``repro_torch`` module of the same path, but for the departures
listed here with their reasons; each public function's and method's
parameters are the port's twin's too, but for the parameter departures.
Then the two names whose values are compared: ``list_archs`` and
``batch_specs``."""
import ast
import importlib
import inspect
import pkgutil

import pytest

import repro
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import list_archs as jax_list_archs
from repro.core.types import MeshConfig as JaxMeshConfig
from repro.parallel import batch_specs as jax_batch_specs
from repro_torch.configs import ARCHS, list_archs
from repro_torch.core.types import MeshConfig
from repro_torch.parallel import batch_specs

_PALLAS = "a Pallas kernel: the port's is a CUDA source under csrc/, " \
          "launched by the ops module"
# module -> the reason it has no counterpart
MODULE_DEPARTURES = {f"repro.kernels.{k}.kernel": _PALLAS
                     for k in ("compress", "flash_attention", "moe_gmm",
                               "ssd_scan")}
_TPU = "the TPU's interconnect and core; the port's hw describes the " \
       "H100 (HBM_BW, NVLINK_BW)"
# (module, name) -> the reason the port's module does not define it
NAME_DEPARTURES = {
    ("repro.launch.analysis", "parse_collectives"):
        "reads XLA's HLO text; the port has no HLO and records its "
        "collectives as they run (record_collectives)",
    ("repro.launch.mesh", "make_production_mesh"):
        "builds a jax Mesh; the port's mesh is a world of processes "
        "(production_world) and its groups (mesh_groups)",
    ("repro.launch.mesh", "make_smoke_mesh"):
        "builds a jax Mesh; the port's smoke mesh is smoke_mesh_config "
        "on one process",
    ("repro.kernels.compress.ref", "wire_codec"):
        "lives in kernels.compress.ops, which takes K2a/K2b on CUDA "
        "tensors and their plain versions on the host",
    **{("repro.core.hw", n): _TPU for n in (
        "ICI_BW_PER_LINK", "ICI_LINKS_PER_CHIP", "DCN_BW_PER_HOST",
        "VMEM_BYTES", "MXU_TILE")},
}


_MESH = "a named axis of the jax Mesh (shard_map, psum); the port passes " \
        "the process group of that axis (group, row_group / col_group, " \
        "launch.mesh.mesh_groups) or the ParallelCtx holding it (ctx), " \
        "and reads the axis's size from it"
_BLOCKS = "a Pallas block size; the CUDA kernels fix their own tiles"
# parameter -> the reason no function of the port takes one of that name
PARAM_DEPARTURES = {
    "key": "a jax PRNG key; the port draws from a torch.Generator "
           "(generator) or takes the random bits (rand_bits)",
    "mesh": _MESH, "axis_name": _MESH, "axis_size": _MESH,
    "ep_axis": _MESH, "data_axes": _MESH, "row_axis": _MESH,
    "col_axis": _MESH, "rows": _MESH, "cols": _MESH, "num_stages": _MESH,
    "interpret": "Pallas' interpret mode; a CUDA kernel has none, and its "
                 "wrapper takes the plain version on CPU tensors",
    "use_pallas": "chooses the Pallas kernel; in the port the device "
                  "decides (a CUDA tensor goes to the kernel)",
    "bq": _BLOCKS, "bk": _BLOCKS, "bc": _BLOCKS, "bf": _BLOCKS,
    "bd": _BLOCKS,
    "compiled": "an XLA executable whose HLO the cost and memory analyses "
                "read; the port's read the launch.analysis.Account of a "
                "run on meta tensors",
}
_SPECS = "a PartitionSpec that XLA's sharding propagation reads; the port " \
         "places its collectives itself (parallel.tensor)"
# (module, function or Class.method, parameter) -> the reason
SIGNATURE_DEPARTURES = {
    **{(m, "ParallelCtx.__init__", f): _SPECS
       for m in ("repro.parallel", "repro.parallel.planner")
       for f in ("act_spec", "logit_spec")},
    **{(m, "ParallelCtx.__init__", "notes"):
       "the planner's notes of the context's layout; the port's layout "
       "rules append theirs to the notes list a caller passes"
       for m in ("repro.parallel", "repro.parallel.planner")},
}


def _modules():
    return ["repro"] + sorted(m.name for m in pkgutil.walk_packages(
        repro.__path__, "repro."))


def _defined(mod) -> list:
    """The public names ``mod``'s source defines at top level, and for a
    package's ``__init__`` the names it imports from the package."""
    init = mod.__file__.endswith("__init__.py")
    names = []
    for node in ast.parse(open(mod.__file__).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            names.append(node.target.id)
        elif init and isinstance(node, ast.ImportFrom) and \
                (node.module or "").startswith("repro"):
            names += [a.asname or a.name for a in node.names]
    return [n for n in names if not n.startswith("_")]


@pytest.mark.parametrize("name", _modules())
def test_every_public_name_has_its_counterpart(name):
    """The port's module of the same path holds every public name the
    JAX package's defines, but the listed departures, which the port
    indeed lacks (the list stays true)."""
    mod = importlib.import_module(name)
    port = "repro_torch" + name[len("repro"):]
    if name in MODULE_DEPARTURES:
        with pytest.raises(ImportError):
            importlib.import_module(port)
        return
    twin = importlib.import_module(port)
    for n in _defined(mod):
        if (name, n) in NAME_DEPARTURES:
            assert not hasattr(twin, n), (name, n)
        else:
            assert hasattr(twin, n), f"{port} lacks {n} of {name}"


def _signatures(name: str):
    """(label, the reference's parameter names, the port's) of every public
    function of module ``name`` and every public method (and
    ``__init__``) of its public classes, but the listed departures."""
    mod = importlib.import_module(name)
    twin = importlib.import_module("repro_torch" + name[len("repro"):])
    for n in _defined(mod):
        if (name, n) in NAME_DEPARTURES:
            continue
        ref, port = getattr(mod, n), getattr(twin, n)
        if inspect.isclass(ref):
            pairs = [(f"{n}.{m}", getattr(ref, m), getattr(port, m, None))
                     for m, v in vars(ref).items()
                     if (m == "__init__" or not m.startswith("_"))
                     and callable(v)]
        elif inspect.isfunction(ref):
            pairs = [(n, ref, port)]
        else:
            continue
        for label, f, g in pairs:
            assert g is not None, f"{name}: the port lacks {label}"
            yield (label, list(inspect.signature(f).parameters),
                   list(inspect.signature(g).parameters))


@pytest.mark.parametrize("name", [m for m in _modules()
                                  if m not in MODULE_DEPARTURES])
def test_every_public_signature_has_its_parameters(name):
    """Every parameter of each public function and method of the JAX
    package's module is one of its twin's (the port may add its own,
    device or generator), but the listed parameter departures; a
    function's own departures the twin indeed lacks."""
    for label, ref, port in _signatures(name):
        for p in ref:
            if (name, label, p) in SIGNATURE_DEPARTURES:
                assert p not in port, (name, label, p)
            elif p not in port:
                assert p in PARAM_DEPARTURES, \
                    f"{name}.{label} lacks parameter {p!r}"


def test_parameter_departures_are_taken():
    """Each parameter departure is a parameter that some twin lacks (the
    one it names, for the per-function ones): the lists stay true."""
    lacked = set()
    for name in _modules():
        if name in MODULE_DEPARTURES:
            continue
        for label, ref, port in _signatures(name):
            lacked.update(p for p in ref if p not in port)
            lacked.update((name, label, p) for p in ref if p not in port)
    assert set(PARAM_DEPARTURES) <= lacked
    assert set(SIGNATURE_DEPARTURES) <= lacked


def test_departures_name_what_the_reference_defines():
    """Each departure is a name the JAX package's module defines."""
    for (name, n) in NAME_DEPARTURES:
        assert n in _defined(importlib.import_module(name)), (name, n)
    for name in MODULE_DEPARTURES:
        assert "pallas_call" in open(importlib.import_module(
            name).__file__).read()


def test_list_archs():
    assert list_archs() == ARCHS == jax_list_archs() == JAX_ARCHS
    assert list_archs() is not ARCHS


@pytest.mark.parametrize("shape,names,data", [
    ((4, 1), ("data", "model"), ("data",)),
    ((2, 2), ("data", "model"), ("data",)),
    ((2, 16, 16), ("pod", "data", "model"), ("pod", "data"))])
def test_batch_specs_are_the_references(shape, names, data):
    """``batch_specs`` is the JAX package's dict, each ``PartitionSpec``
    as the port's tuple of axes."""
    want = jax_batch_specs(JaxMeshConfig(shape=shape, axis_names=names,
                                         data_axes=data))
    got = batch_specs(MeshConfig(shape=shape, axis_names=names,
                                 data_axes=data))
    assert got == {k: tuple(v) for k, v in want.items()}
